"""Designs of K11's forward, the voxelize splat (`csrc/p2v.cu`
`voxelize_fwd_kernel`), side by side on one CUDA GPU.

    python3 tools/voxelize_ab.py [--parent DIR] [--designs A,B,...] [--rounds N]

This script compiles each design with nvcc, every design a text patch of
`p2v.cu` in a copy of the sources (that unit alone):

  * ``shipped``: the source as it is: each point walks its window cut per
    axis to the indices within the radius of it (`window_span`), skipping
    rows with no voxel within; a block of `kThreads` consecutive points
    reduces their spans to one voxel box; where it holds at most
    `kTileFloats` voxels (4096) the block splats into a shared tile with
    shared adds and adds each non-zero tile voxel into the grid once; any
    other block splats into the grid directly; a warp's lanes take points 8
    rows apart;
  * ``cap8k``, ``cap12k``: tiles of 8192 or 12,000 voxels;
  * ``consecutive``: a warp's lanes on consecutive points (the shipped
    kernel puts them 8 rows apart, so that points whose windows start at
    one voxel do not add into one tile address in one instruction);
  * ``full_walk``: the shipped tile with the whole window walked (the span
    not cut, no row skipped);
  * ``gather``: the shipped box, a thread a tile voxel summing the block's
    points that cover it (`tools/p2v_designs.cuh`, launched in place of the
    shipped kernel);
  * ``pairs``: in a tiled block two threads walk the union of two
    neighbouring rows' spans, each the x planes of one parity, one shared
    add a voxel for both points (the same file);
  * ``no_atomics`` (a census, not a design): the shipped walk and terms, a
    thread a point, with no adds (the same file): the time the adds take is
    the difference;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    kernel (a thread a point, a global float atomic a voxel within the
    radius).

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians of
the kernel's device time from `torch.profiler`, REPS calls of the C entry
into a preallocated grid zeroed before each call, L2 flushed before each
call) on the 257^3 grid over the unit cube (kr 0.00363, cr 0.00727, W 6;
`chip_smoke.py`'s P2V constants) at the shapes its callers give the kernel:

  * ``row``: `chip_smoke.py` phase 3c's cloud, the depth-9 shell's
    1,404,480 leaf centres warped by pose 1 of the seeded 32-joint rig
    (`warp_bwd_ab.deep_rig`), in its own row order: the pose fit and
    phase 4e;
  * ``random``: the same cloud in a seeded random permutation, the order of
    the serving frames' points: nearly every block's box is too large, and
    the kernel splats as the earlier one did.

In every round each design's grid is held to the plain version
(`voxelize_forward_plain`) within ATOMIC_RTOL (the census is not
checked). For each shape it prints the census of the run
(`chip_smoke.p2v_census`: window voxels walked and within the radius), the
shipped kernel's count of tiled blocks (`svox_voxelize_fwd_tiles`) beside
the plain mirror's (`voxelize_forward_tiled_plain`: tiled blocks, shared and
global adds), and the bound.

Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
import time
from ctypes import c_float
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
import warp_bwd_ab as wab  # noqa: E402
from svox_t_tpu_torch.ops import p2v as p2v_ops  # noqa: E402

ROUNDS = 6
REPS = 10
UNIT = ("p2v",)
SOURCE = "p2v.cu"
DESIGN_FILE = "p2v_designs.cuh"
LAUNCH = "  voxelize_fwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol, tiled);\n"
ENTRY = "cudaError_t voxelize_fwd(const float* points, const float* features, int Q, int F,"
CAP = "constexpr int kTileFloats = 4096;"


def spliced(design: str) -> tuple:
    """The patches that launch a design of `tools/p2v_designs.cuh` in place
    of the shipped kernel."""
    return ((ENTRY, f'}}  // namespace\n\n#include "{DESIGN_FILE}"\n\nnamespace {{\n\n' + ENTRY),
            (LAUNCH, f"  return launch_{design}(a, vol, tiled, stream);\n"))


# {design: text patches of p2v.cu}.
DESIGNS = {
    "shipped": (),
    "cap8k": ((CAP, "constexpr int kTileFloats = 8192;"),),
    "cap12k": ((CAP, "constexpr int kTileFloats = 12000;"),),
    "consecutive": (("      blockIdx.x * kThreads + (threadIdx.x & 31) * (kThreads / 32) + (threadIdx.x >> 5);",
                     "      blockIdx.x * kThreads + threadIdx.x;"),),
    "full_walk": (("      if (d * d <= a.cr2) {", "      if (true) {"),
                  ("      if (s > a.cr2) continue;\n", "")),
    "gather": spliced("gather"),
    "pairs": spliced("pairs"),
    "no_atomics": spliced("no_atomics"),
}
CENSUS = ("no_atomics",)


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's voxelize kernels."""
    print(f"ptxas {name}: " + "; ".join(f"{e[:60]} {r} regs {s} B spilled" for _, e, r, s in rows
                                        if "voxelize" in e))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K11 forward is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("voxelize_ab.py needs a CUDA GPU")
    chosen = args.designs.split(",") if args.designs else list(DESIGNS)
    unknown = set(chosen) - set(DESIGNS)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(DESIGNS)}")
    designs = {k: v for k, v in DESIGNS.items() if k in chosen or k == "shipped"}
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = fab.compile_libraries(Path(tmp), wab.design_sources(Path(tmp), args.parent, designs, SOURCE,
                                                                   DESIGN_FILE, UNIT), report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        fns = {}
        for name, path in libs.items():
            fn = getattr(ctypes.CDLL(str(path)), "svox_voxelize_fwd")
            fn.argtypes = p2v_ops.VOXELIZE_FWD.argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        tiles_fn = ctypes.CDLL(str(libs["shipped"])).svox_voxelize_fwd_tiles
        tiles_fn.argtypes = p2v_ops.VOXELIZE_FWD_TILES.argtypes
        tiles_fn.restype = ctypes.c_int
        runs = (["parent"] if "parent" in fns else []) + list(designs)
        t0 = time.perf_counter()
        rig = wab.deep_rig(dev)
        print(f"rig: {rig['warped'].shape[0]} points, {time.perf_counter() - t0:.1f} s to build")
        grid = p2v_ops.grid_consts(0.0, 1.0, cs.P2V_N, cs.P2V_KR, cs.P2V_CR)
        perm = torch.from_numpy(np.random.RandomState(0).permutation(rig["warped"].shape[0])).to(dev)
        cases = {"row": (rig["warped"], rig["feats"]),
                 "random": (rig["warped"][perm].contiguous(), rig["feats"][perm].contiguous())}
        stream = torch.cuda.current_stream(dev).cuda_stream
        for shape, (pts, feats) in cases.items():
            want = p2v_ops.voxelize_forward_plain(pts, feats, grid)
            vols = {name: torch.zeros(grid.n ** 3, device=dev) for name in runs}
            args_ = (pts.data_ptr(), feats.data_ptr(), pts.shape[0], feats.shape[1], (c_float * 3)(*grid.corner),
                     (c_float * 3)(*grid.vs), grid.n, grid.W, grid.cr, grid.cr2, grid.c2k)

            def launcher(name):
                vol = vols[name]

                def launch():
                    vol.zero_()
                    err = fns[name](*args_, vol.data_ptr(), dev.index, stream)
                    if err:
                        raise RuntimeError(f"{name} {shape}: CUDA error {err}")
                return launch

            def held(name):
                if name not in CENSUS:
                    torch.cuda.synchronize()
                    cs.atomic_err(vols[name].reshape(want.shape), want, f"{name} {shape}")

            launches = {name: launcher(name) for name in runs}
            for name in runs:
                launches[name]()
                held(name)
            times = {name: [] for name in runs}
            for rnd in range(args.rounds):
                for name in (runs if rnd % 2 == 0 else runs[::-1]):
                    times[name].append(cs.device_ms(launches[name], REPS, ("voxelize_fwd",), cold=True))
                    launches[name]()
                    held(name)
            tiled = torch.zeros(1, dtype=torch.int32, device=dev)
            vol = torch.zeros(grid.n ** 3, device=dev)
            err = tiles_fn(*args_, vol.data_ptr(), tiled.data_ptr(), dev.index, stream)
            cs.check(err == 0, f"svox_voxelize_fwd_tiles: CUDA error {err}")
            mirror_vol, mirror = p2v_ops.voxelize_forward_tiled_plain(pts, feats, grid)
            cs.atomic_err(mirror_vol, want, f"the tiled mirror, {shape}")
            cs.check(int(tiled.item()) == mirror["tiled"],
                     f"{shape}: the kernel tiled {int(tiled.item())} blocks, the mirror {mirror['tiled']}")
            census = cs.p2v_census(pts, grid)
            b = cs.dynamic_bounds(pts.shape[0], cs.N_BONES, cs.N_JOINTS, feats.shape[1], grid.n, census, 0)
            bound_ms, bound_by = b["voxelize_fwd"]["bound_ms"], b["voxelize_fwd"]["bound_by"]
            res[f"bound_{shape}_ms"] = bound_ms
            print(f"K11 forward {shape}: {pts.shape[0]} points, {grid.n}^3 grid, W {grid.W}; census {census}; "
                  f"tiled blocks {int(tiled.item())} of {mirror['blocks']} (mirror {mirror['tiled']}; shared adds "
                  f"{mirror['shared_adds']}, global adds {mirror['global_adds']}); {args.rounds} rounds in turns, "
                  f"every grid within ATOMIC_RTOL of plain (census unchecked); bound {bound_ms:.5f} ms "
                  f"({bound_by}) [{card}]")
            base = statistics.median(times[runs[0]])
            for name in runs:
                m = statistics.median(times[name])
                res[f"{name}_{shape}_ms"] = m
                print(f"  {name:12s} {m:.4f} ms ({base / m:.3f}x {runs[0]}; {bound_ms / m:.3f} of the bound); "
                      f"rounds {[round(t, 4) for t in times[name]]}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
