"""Designs of K14a, the minibatch subset gather (`csrc/tape_subset.cu`
`gather_kernel`), side by side on one CUDA GPU.

    python3 tools/subset_gather_ab.py [--parent DIR] [--designs A,B,...] [--rounds N]

This script compiles each design with nvcc, every design a text patch of
`tape_subset.cu` in a copy of the sources (that unit alone):

  * ``shipped``: the source as it is: 32 rays a warp, a lane a ray, the
    warp's span of the new streams copied a lane an entry (each entry's ray
    found by a search over the lanes' new offsets through shuffles), the
    optional streams as template parameters, 128-thread blocks;
  * ``b256``: the shipped kernel in 256-thread blocks;
  * ``thread``: a thread a ray that copies its run
    (`tools/subset_gather_designs.cuh`, launched in place of the shipped
    kernel);
  * ``runtime``: the shipped design with the optional streams as run-time
    null tests a sample (the same file);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    kernel (a warp a ray).

It prints each library's registers and spills, then times the designs in
turns (ROUNDS rounds, the order reversed every other round, the medians) at
the shapes its callers give the kernel, on bench.py's minibatch cell
(`chip_smoke.py` `minibatch_scene`: the depth-7 SH9 shell, a 4-view rig as
one compacted tape):

  * ``mb65k``: `train_minibatches`' step, 65,536 ids drawn with
    replacement from the rig's rays (seed 7), the row and step streams;
  * ``mb256k``: the same at 262,144 ids;
  * ``uncompacted``: `chip_smoke.py` phase 3h's check, 65,536 ids (seed 8,
    duplicates certain) on the rig recorded uncompacted (longer runs), with
    the cell stream and the rays;
  * ``orbit``: the orbit camera's 640,000-ray tape (`train_steps`' tape) as
    one subset of every ray in order, the row and step streams.

Each time is the median over the rounds of the kernels' device time from
`torch.profiler` (`chip_smoke.device_ms`: REPS calls of the C entry into
preallocated outputs), L2 cold (a 128 MB write before each call) and warm.
In every round each design's streams are held to the plain version
(`subset_gather_plain`) bit for bit. Each shape's line gives its bound (the
bytes the call must move over the card's memory rate) and one `index_select`
of the row stream at the gathered positions beside it (a census of the copy
alone: the positions are this script's, not the kernel's work).

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

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import tape_subset as subset_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import orbit_camera  # noqa: E402

ROUNDS = 6
REPS = 10
UNIT = ("tape_subset",)
SOURCE = "tape_subset.cu"
DESIGN_FILE = "subset_gather_designs.cuh"
LAUNCH = "  return launch_gather(a, stream);\n}"
ENTRY = "// K14a. src_offsets (n_src + 1,)"


def spliced(design: str) -> tuple:
    """The patches that launch a design of `tools/subset_gather_designs.cuh`
    in place of the shipped kernel."""
    return ((ENTRY, f'#include "{DESIGN_FILE}"\n\n' + ENTRY),
            (LAUNCH, f"  return launch_{design}(a, stream);\n}}"))


# {design: text patches of tape_subset.cu}.
DESIGNS = {
    "shipped": (),
    "b256": (("constexpr int kGatherThreads = 128;", "constexpr int kGatherThreads = 256;"),),
    "thread": spliced("thread"),
    "runtime": spliced("runtime"),
}
SHAPES = ("mb65k", "mb256k", "uncompacted", "orbit")


def design_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """{library: (its csrc copy, its units)}: each design's source patched,
    with `tools/subset_gather_designs.cuh` beside it; the parent's as it is."""
    src = (_build.CSRC / SOURCE).read_text()
    out = {}
    for name, patches in designs.items():
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
    """Registers and spills of a library's K14a kernels."""
    print(f"ptxas {name}: " + "; ".join(f"{re.sub(r'.*_cu_[0-9a-f]{8}', '', e)[:48]} {r} regs {s} B spilled"
                                        for _, e, r, s in rows if "gather" in e))


def shapes(dev) -> dict:
    """{shape: (tape, ids (B,) int32 host, want_t, want_cell, with_rays)}."""
    mb = cs.minibatch_scene(dev)
    rig, r, f0 = mb["rig"], mb["r"], mb["f0"]
    n_rig = rig.n_rays
    full = r.record_persp_rig(mb["c2ws"], cs.WIDTH, cs.HEIGHT, fx=cs.BENCH_FX, features=f0, compact=False)
    orbit = r.record_persp(orbit_camera(), cs.WIDTH, cs.HEIGHT, fx=cs.BENCH_FX, features=f0)
    ids_3h = np.random.RandomState(8).randint(0, n_rig, cs.B_MB)
    ids_3h[:16] = ids_3h[16:32]
    return {
        "mb65k": (rig, np.random.RandomState(7).randint(0, n_rig, cs.B_MB), False, False, False),
        "mb256k": (rig, np.random.RandomState(7).randint(0, n_rig, cs.B_MB2), False, False, False),
        "uncompacted": (full, ids_3h, False, True, True),
        "orbit": (orbit, np.arange(orbit.n_rays), False, False, False),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K14a is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("subset_gather_ab.py needs a CUDA GPU")
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
        libs = fab.compile_libraries(Path(tmp), design_sources(Path(tmp), args.parent, designs), report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        fns = {}
        for name, path in libs.items():
            fn = getattr(ctypes.CDLL(str(path)), "svox_subset_gather")
            fn.argtypes = subset_ops.SUBSET_GATHER.argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        runs = (["parent"] if "parent" in fns else []) + list(designs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for shape, (tp, ids_np, want_t, want_cell, rays) in shapes(dev).items():
            src = subset_ops.TapeRowSource(tp, keep_cells=want_cell)
            offsets_np = subset_ops._subset_plan(src, ids_np)[1]
            ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
            offsets = torch.from_numpy(offsets_np).to(dev)
            B, total = ids.shape[0], int(offsets_np[-1])
            want = subset_ops.subset_gather_plain(tp, ids, offsets, want_t, want_cell, rays)
            outs = {name: subset_ops._empty_streams(tp, B, total, want_t, want_cell, rays) for name in runs}

            def launcher(name):
                o = outs[name]
                p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
                a = (tp.offsets.data_ptr(), ids.data_ptr(), offsets.data_ptr(), B, tp.idx.data_ptr(), o.idx.data_ptr(),
                     tp.dt.data_ptr(), o.dt.data_ptr(), p(tp.tval) if want_t else None, p(o.tval),
                     p(tp.cell) if want_cell else None, p(o.cell), tp.vdirs.data_ptr(), o.vdirs.data_ptr(),
                     tp.dscale.data_ptr(), o.dscale.data_ptr(), o.counts.data_ptr(),
                     p(tp.origins) if rays else None, p(o.origins), p(tp.dirs) if rays else None, p(o.dirs),
                     dev.index, stream)

                def launch():
                    err = fns[name](*a)
                    if err:
                        raise RuntimeError(f"{name} {shape}: CUDA error {err}")
                return launch

            launches = {name: launcher(name) for name in runs}
            # The census: the row stream gathered at the plain version's positions.
            ray = torch.repeat_interleave(torch.arange(B, device=dev), want.counts.long(), output_size=total)
            pos = (tp.offsets[:-1].long()[ids.long()][ray]
                   + torch.arange(total, device=dev) - offsets[:-1].long()[ray])
            sel = torch.empty_like(want.idx)

            def census():
                torch.index_select(tp.idx, 0, pos, out=sel)

            names = runs + ["index_select"]
            times = {(n, c): [] for n in names for c in ("cold", "warm")}
            for rnd in range(args.rounds):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    fn = census if name == "index_select" else launches[name]
                    # The census's one library kernel (its name is PyTorch's); each design's own.
                    kern = None if name == "index_select" else ("gather_",)
                    times[name, "cold"].append(cs.device_ms(fn, REPS, kern, cold=True))
                    times[name, "warm"].append(cs.device_ms(fn, REPS, kern, cold=False))
                    if name == "index_select":
                        continue
                    torch.cuda.synchronize()
                    for field, g, w in zip(want._fields, outs[name], want):
                        cs.check((g is None) == (w is None) and (g is None or torch.equal(g, w)),
                                 f"{name} {shape}: {field} differs from the plain version")
            n_bytes = cs.subset_gather_bytes(B, total, want_t, want_cell, rays)
            bound_ms, bound_by = cs.bound(n_bytes, 0)
            res[f"bound_{shape}_ms"] = bound_ms
            runs_long = int((want.counts > 32).sum())
            print(f"K14a {shape}: {B} ids, {total} samples ({total / B:.2f} a ray, {runs_long} runs over 32), "
                  f"t {want_t}, cell {want_cell}, rays {rays}; {args.rounds} rounds in turns, every stream equal to "
                  f"plain; bound {bound_ms:.5f} ms ({bound_by}: {n_bytes} bytes) [{card}]")
            base = statistics.median(times[runs[0], "cold"])
            for name in names:
                c, w = (statistics.median(times[name, k]) for k in ("cold", "warm"))
                res[f"{name}_{shape}_cold_ms"] = c
                res[f"{name}_{shape}_warm_ms"] = w
                print(f"  {name:12s} L2 cold {c:.4f} ms ({base / c:.3f}x {runs[0]}; {bound_ms / c:.3f} of the "
                      f"bound), warm {w:.4f} ms; rounds cold {[round(x, 4) for x in times[name, 'cold']]}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
