"""Designs of K12, the dense-grid weight pass (`csrc/grid.cu`: the
occupancy pass `occupancy_kernel` and the march `grid_kernel`), side by
side on one CUDA GPU.

    python3 tools/grid_ab.py [--parent DIR] [--designs A,B,...] [--rounds N] [--check-only]

This script compiles each design with nvcc, every design a text patch of
`grid.cu` in a copy of the sources (that unit alone):

  * ``shipped``: the source as it is: bricks of 8^3, the mask read from
    global memory (`__ldg`), a sample's mask bit and sigma loaded and used
    in turn, 32-bit voxel indices, an 8x4 pixel tile a warp;
  * ``rows``: the shipped kernel launched with no row width: 32
    consecutive pixels of a row a warp;
  * ``b4``, ``b16``: bricks of 4^3 and 16^3 (the occupancy pass and the
    march);
  * ``idx64``: 64-bit voxel indices;
  * ``ldcg``: sigma loaded through L2 only (`__ldcg`), the L1 kept for
    the mask;
  * ``lb8``: the march under `__launch_bounds__(256, 8)` (32 registers);
  * ``ahead``, ``smem``: the kernels of `tools/grid_designs.cuh`, launched
    in place of the shipped march (the loop rotated, the next sample's
    loads issued before this one composites; the mask in shared memory);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    K12 (one launch that loads every sample's sigma).

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians) at
two shapes, each through `chip_smoke.py`'s orbit camera (800x800, fx
1111.111, step_size 1e-3, max_steps 1024):

  * ``a``: the depth-9 shell's sigma on its 512^3 grid (`chip_smoke.py`
    `grid_scene`, the caller's shape: phase 3h and the main path 4o);
  * ``b``: a solid ball of the shell's outer radius at the shell's median
    sigma (`chip_smoke.grid_ball_scene`), a dense scene where the mask
    saves little.

A call is what the wrapper does: both output grids zeroed, the occupancy
pass, the march. Each time is the median over the rounds of the call's
kernels' device time from `torch.profiler` (REPS calls, a 128 MB write
before each so that the grid is read from HBM; the zero fill is a fill
kernel and not counted), split into the occupancy pass and the march. In
every round each design's two outputs are held to the plain version
(`grid_weight_plain`) bit for bit. Each shape prints its census
(`ops.grid.grid_march_mirror`: rays, samples, distinct voxels, sigma loads,
contributing samples, marked bricks, warp iterations in row order and in
8x4 tiles) for bricks of 4, 8 and 16, and the bound of K12 and of each of
its two kernels (`chip_smoke.grid_bounds`). ``--check-only`` builds, checks
every design against plain once at both shapes and prints the census,
without timing.

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import grid as grid_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

ROUNDS = 6
REPS = 10
UNIT = ("grid",)
SOURCE = "grid.cu"
DESIGN_FILE = "grid_designs.cuh"
ENTRY = "int mask_bricks(int reso) {"
LAUNCH = "    grid_kernel<kBrick, int><<<blocks, kThreads, 0, stream>>>("
MARCH = ("grid_kernel",)
OCCUPANCY = ("occupancy_kernel",)
# The parent's svox_grid_weight: the arguments before the row width and the
# mask were added.
PARENT_ARGTYPES = (grid_ops.GRID_WEIGHT.argtypes[:3] + grid_ops.GRID_WEIGHT.argtypes[4:11]
                   + grid_ops.GRID_WEIGHT.argtypes[12:])


def spliced(launch: str) -> tuple:
    """The patches that launch ``launch`` of `tools/grid_designs.cuh` in
    place of the shipped march."""
    return ((ENTRY, f'#include "{DESIGN_FILE}"\n\n' + ENTRY), (LAUNCH, launch))


# {design: (text patches of grid.cu, brick edge)}; ROWS launch with no row
# width.
DESIGNS = {
    "shipped": ((), 8),
    "rows": ((), 8),
    "b4": ((("constexpr int kBrick = 8;", "constexpr int kBrick = 4;"),), 4),
    "b16": ((("constexpr int kBrick = 8;", "constexpr int kBrick = 16;"),), 16),
    "idx64": ((("if (static_cast<int64_t>(reso) * reso * reso < (int64_t{1} << 31))", "if (false)"),), 8),
    "ldcg": ((("s.sigma = s.marked ? __ldg(data + s.node) : 0.f;",
               "s.sigma = s.marked ? __ldcg(data + s.node) : 0.f;"),), 8),
    "lb8": ((("__launch_bounds__(kThreads) grid_kernel(", "__launch_bounds__(kThreads, 8) grid_kernel("),), 8),
    "ahead": (spliced("    grid_kernel_ahead<kBrick, int><<<blocks, kThreads, 0, stream>>>("), 8),
    "smem": (spliced("    launch_smem<kBrick, int>(blocks, stream, "), 8),
}
ROWS = {"rows"}


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: (its csrc copy, its units)}: each design's source patched,
    with `tools/grid_designs.cuh` beside it; the parent's as it is."""
    src = (_build.CSRC / SOURCE).read_text()
    out = {}
    for name, (patches, _) in designs.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{SOURCE} changed: design {name}'s patch no longer applies")
            text = text.replace(old, new)
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        shutil.copy(Path(__file__).resolve().parent / DESIGN_FILE, d / DESIGN_FILE)
        (d / SOURCE).write_text(text)
        out[name] = (d, UNIT)
    if parent is not None:
        out["parent"] = (parent / "svox_t_tpu_torch" / "csrc", UNIT)
    return out


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's K12 kernels."""
    def short(entry):
        m = re.search(r"(grid_kernel\w*|occupancy_kernel)I(\w+?)EEv", entry)
        return f"{m.group(1)}<{m.group(2)}>" if m else entry[:48]
    print(f"ptxas {name}: " + "; ".join(f"{short(e)} {r} regs {s} B spilled" for _, e, r, s in rows if "kernel" in e))


def shapes(dev) -> dict:
    """{shape: `chip_smoke.grid_scene`-style dict}."""
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    g = cs.grid_scene(centers_np, feats_np[:, -1], dev)
    return {"a": g, "b": cs.grid_ball_scene(g, centers_np, feats_np[:, -1])}


def split_ms(fn, reps: int) -> tuple:
    """(occupancy ms, march ms) a call of ``fn`` from one `torch.profiler`
    session of ``reps`` calls, a 128 MB write before each (L2 cold)."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            flush.zero_()
            fn()

    def marches(events):
        return [e for e in events if any(n in e.name for n in MARCH)]

    events = cs.profiled_kernels(run, lambda ev: len(marches(ev)) >= reps, "grid designs")
    cs.check(len(marches(events)) >= reps, "the profiler recorded no K12 march")
    occ = sum(e.time_range.elapsed_us() for e in events if any(n in e.name for n in OCCUPANCY))
    return occ / 1e3 / reps, sum(e.time_range.elapsed_us() for e in marches(events)) / 1e3 / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K12 is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--check-only", action="store_true", help="build, check and take the census; no timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grid_ab.py needs a CUDA GPU")
    chosen = args.designs.split(",") if args.designs else list(DESIGNS)
    unknown = set(chosen) - set(DESIGNS)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(DESIGNS)}")
    designs = {k: v for k, v in DESIGNS.items() if k in chosen or k == "shipped"}
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = fab.compile_libraries(Path(tmp), design_sources(Path(tmp), args.parent, designs), report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        fns = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            march = lib.svox_grid_weight
            march.argtypes = PARENT_ARGTYPES if name == "parent" else grid_ops.GRID_WEIGHT.argtypes
            march.restype = ctypes.c_int
            occ = None
            if name != "parent":
                occ = lib.svox_grid_occupancy
                occ.argtypes = grid_ops.GRID_OCCUPANCY.argtypes
                occ.restype = ctypes.c_int
            fns[name] = (occ, march)
        runs = (["parent"] if "parent" in fns else []) + list(designs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        t_shapes = time.perf_counter()
        scenes = shapes(dev)
        print(f"shapes: {time.perf_counter() - t_shapes:.1f} s")
        for shape, g in scenes.items():
            data, o, d, opt = g["data"], g["origins"], g["dirs"], g["opt"]
            reso, B = data.shape[0], o.shape[0]
            gw = torch.empty_like(data)
            gh = torch.empty_like(data)
            masks = {b: torch.empty(grid_ops.mask_words(reso, b), dtype=torch.int32, device=dev)
                     for b in (4, 8, 16)}
            pw, ph = grid_ops.grid_weight_plain(data, o, d, g["offset"], g["scaling"], opt)
            censuses = {}
            for b in (8, 4, 16):
                t_c = time.perf_counter()
                mw, mh, censuses[b] = grid_ops.grid_march_mirror(data, o, d, g["offset"], g["scaling"], opt,
                                                                 brick=b, width=cs.WIDTH)
                cs.check(torch.equal(mw, pw) and torch.equal(mh, ph), f"{shape}: the mirror (brick {b}) differs "
                         "from plain")
                print(f"census K12 {shape}, bricks of {b}: {censuses[b]} ({time.perf_counter() - t_c:.1f} s)")
                del mw, mh
            bounds = cs.grid_bounds(censuses[8])
            for k, v in bounds.items():
                res[f"bound_{k}_{shape}_ms"] = v["bound_ms"]
                print(f"bound {k} ({shape}): {v['bound_bytes'] / 1e6:.2f} MB, {v['bound_ops'] / 1e9:.4f} Gop -> "
                      f"{v['bound_ms']:.5f} ms ({v['bound_by']}) [{card}]")

            def launcher(name):
                occ, march = fns[name]
                if name == "parent":
                    def launch():
                        gw.zero_()
                        gh.zero_()
                        err = march(o.data_ptr(), d.data_ptr(), B, g["offset"].data_ptr(), g["scaling"].data_ptr(),
                                    data.data_ptr(), reso, opt.step_size, opt.sigma_thresh, opt.max_steps,
                                    gw.data_ptr(), gh.data_ptr(), dev.index, stream)
                        if err:
                            raise RuntimeError(f"parent {shape}: CUDA error {err}")
                    return launch
                mask = masks[designs[name][1]]
                width = 0 if name in ROWS else cs.WIDTH

                def launch():
                    gw.zero_()
                    gh.zero_()
                    err = occ(data.data_ptr(), reso, opt.sigma_thresh, mask.data_ptr(), dev.index, stream)
                    err = err or march(o.data_ptr(), d.data_ptr(), B, width, g["offset"].data_ptr(),
                                       g["scaling"].data_ptr(), data.data_ptr(), reso, opt.step_size,
                                       opt.sigma_thresh, opt.max_steps, mask.data_ptr(), gw.data_ptr(),
                                       gh.data_ptr(), dev.index, stream)
                    if err:
                        raise RuntimeError(f"{name} {shape}: CUDA error {err}")
                return launch

            launches = {name: launcher(name) for name in runs}

            def held(name):
                torch.cuda.synchronize()
                cs.check(torch.equal(gw, pw) and torch.equal(gh, ph), f"{name} {shape}: outputs differ from plain")
                if name != "parent":
                    b = designs[name][1]
                    cs.check(torch.equal(masks[b], grid_ops.grid_occupancy_plain(data, opt.sigma_thresh, b)),
                             f"{name} {shape}: the mask differs from plain")

            if args.check_only:
                for name in runs:
                    launches[name]()
                    held(name)
                print(f"K12 {shape}: every design's outputs and mask equal to plain [{card}]")
                continue
            times = {(n, k): [] for n in runs for k in ("occ", "march")}
            for rnd in range(args.rounds):
                for name in (runs if rnd % 2 == 0 else runs[::-1]):
                    occ_ms, march_ms = split_ms(launches[name], REPS)
                    times[name, "occ"].append(occ_ms)
                    times[name, "march"].append(march_ms)
                    held(name)
            print(f"K12 {shape}: {B} rays on a {reso}^3 grid; {args.rounds} rounds in turns, L2 cold, outputs and "
                  f"masks equal to plain every round [{card}]")
            total = {n: [a + b for a, b in zip(times[n, "occ"], times[n, "march"])] for n in runs}
            base = statistics.median(total[runs[0]])
            for name in runs:
                t_ = statistics.median(total[name])
                oc, mc = (statistics.median(times[name, k]) for k in ("occ", "march"))
                res[f"{name}_{shape}_ms"] = t_
                res[f"{name}_{shape}_occupancy_ms"] = oc
                res[f"{name}_{shape}_march_ms"] = mc
                print(f"  {name:8s} {t_:.4f} ms (occupancy {oc:.4f} + march {mc:.4f}; {base / t_:.3f}x {runs[0]}, "
                      f"{bounds['grid_pass']['bound_ms'] / t_:.3f} of K12's bound); rounds "
                      f"{[round(x, 4) for x in total[name]]}")
            del gw, gh, pw, ph
    print(json.dumps(res))


if __name__ == "__main__":
    main()
