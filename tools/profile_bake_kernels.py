"""The bake's three kernels, each alone, on one CUDA GPU.

    python3 tools/profile_bake_kernels.py [--rounds N]

At `chip_smoke.py` phase 6's shapes: K6's point lookup (`lookup_kernel`)
on the depth-9 shell's bake at its 1,404,480 leaf centres and 2^20 seeded
points; K7a's refresh (`refresh_kernel`) of that bake (5,234,688 cells)
re-pointed by the permuted leaf centres, with the union of their leaf box;
K7b's skip-box regrowth (`distance_pass`, `pack_boxes_kernel`) on bench.py's
dynamic tree after its frame-1 refresh. For each it prints, with the
card's name and power limit, the medians over ROUNDS rounds of:

  * the kernels' device time a call from `torch.profiler`
    (`chip_smoke.device_ms`), L2 cold (a 128 MB write before each call)
    and warm;
  * the CUDA-event time a call over back-to-back wrapper calls
    (`chip_smoke.time_ms`), which counts the host's dispatch where a call's
    kernels are shorter than it;
  * the CUDA-event time of each call alone behind a busy stream, L2 cold
    (`chip_smoke.queued_ms`, the smoke's timer where the profiler records
    no kernel), to hold it to the profiler's;

and each kernel's bound (`chip_smoke.bake_bounds`) and share (bound over
the cold device time). Every kernel is first held to its plain version.

It builds only the compile units these calls launch (UNITS, with nvcc, in
seconds) and loads them as the package's library. It needs a CUDA GPU and
nvcc, and imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import bake as bake_ops  # noqa: E402
from svox_t_tpu_torch.ops import query as query_ops  # noqa: E402
from svox_t_tpu_torch.ops import traversal  # noqa: E402
from svox_t_tpu_torch.utils.scenes import bench_dynamic_cloud, build_shell_tree  # noqa: E402

ROUNDS = 6
# The compile units the calls below launch: the bake's kernels, the
# re-point (construct_tree_aabb, with the library's error strings), the
# query, the warp and the tree edits (bench.py's dynamic tree).
UNITS = ("bake", "construct_tree", "query", "warp", "edit")
# {kernel: the names of its device kernels}.
NAMES = {"bake_lookup": ("lookup_kernel",), "bake_refresh": ("refresh_kernel",),
         "grow_boxes": ("distance_pass", "pack_boxes_kernel")}


def load_units(workdir: Path) -> None:
    """Compile UNITS alone and make them the package's library."""
    t0 = time.perf_counter()
    libs = fab.compile_libraries(workdir, {"bake": (_build.CSRC, UNITS)}, lambda name, rows: print(
        "ptxas: " + "; ".join(f"{e[-40:]} {r} regs {s} B spilled" for u, e, r, s in rows if u == "bake")))
    lib = ctypes.CDLL(str(libs["bake"]))
    lib.svox_error_string.argtypes = [ctypes.c_int]
    lib.svox_error_string.restype = ctypes.c_char_p
    _build._LIB = lib
    print(f"build of {', '.join(UNITS)}: {time.perf_counter() - t0:.1f} s")


def calls(dev) -> dict:
    """{kernel: (a call of its wrapper, what it runs on)}, each checked
    against its plain version once."""
    state, _, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    M = centers_np.shape[0]
    tree = stt.tree_from_numpy(state, device=dev)
    spec = tree._spec()
    baked = tree._baked_spec()
    centers = torch.from_numpy(centers_np).to(dev)
    points = centers[torch.from_numpy(np.random.RandomState(0).permutation(M)).to(dev)].contiguous()
    leaf_pts = traversal.world2tree(centers, spec.offset, spec.scaling)
    lk_pts = torch.cat([leaf_pts, torch.from_numpy(
        (np.random.RandomState(5).rand(cs.N_LOOKUP_POINTS, 3) * 1.2 - 0.1).astype(np.float32)).to(dev)])
    lk_pts = lk_pts.contiguous()
    new_flat, lo, hi = query_ops.construct_tree_aabb_cuda(spec, points, union=(baked.aabb_lo, baked.aabb_hi))
    for a, b in zip(bake_ops.lookup_cuda(baked, lk_pts), bake_ops.lookup_plain(baked, lk_pts)):
        cs.check(torch.equal(a, b), "lookup: kernel and plain differ")
    ref_k = bake_ops.refresh_cuda(baked, new_flat, lo, hi)
    ref_p = bake_ops.refresh_plain(baked, new_flat, lo, hi)
    for name in ("top", "mid", "brick"):
        a, b = getattr(ref_k, name), getattr(ref_p, name)
        cs.check((a is None and b is None) or torch.equal(a, b), f"refresh: kernel and plain {name} differ")

    bd = bench_dynamic_cloud()
    args = [torch.from_numpy(bd[k]).to(dev) for k in ("poses", "src_pose", "points", "skinning_weights",
                                                      "joint_index")]
    gb_tree = stt.N3Tree(N=2, data_dim=4, depth_limit=6, device=dev)
    gb_tree.refine(repeats=5)
    gb_tree.construct_tree(bd["points"])
    gb = gb_tree._baked_spec()
    warped, _ = stt.warp_vertices(stt.get_transformation_matrix(args[1], args[0][1]), *args[2:])
    gb_spec = gb_tree._spec()
    t, g_lo, g_hi = query_ops.construct_tree_aabb_cuda(gb_spec, warped, union=(gb.aabb_lo, gb.aabb_hi))
    gb_ref = bake_ops.refresh_cuda(gb, t, g_lo, g_hi)
    cs.check(torch.equal(bake_ops.grow_boxes_cuda(gb_ref).top, bake_ops.grow_boxes_plain(gb_ref).top),
             "grow_boxes: kernel and plain differ")
    bounds = cs.bake_bounds(lk_pts.shape[0], baked.src_map.numel(), baked.top.numel() + baked.n_mid, gb.R)
    return {
        "bake_lookup": (lambda: bake_ops.lookup_cuda(baked, lk_pts), f"{lk_pts.shape[0]} points", bounds),
        "bake_refresh": (lambda: bake_ops.refresh_cuda(baked, new_flat, lo, hi),
                         f"{baked.src_map.numel()} baked cells", bounds),
        "grow_boxes": (lambda: bake_ops.grow_boxes_cuda(gb_ref), f"{gb.R}^3 top grid", bounds),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_bake_kernels.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        load_units(Path(tmp))
        run(dev, card, args.rounds)


def run(dev, card: str, rounds: int) -> None:
    for name, (fn, what, bounds) in calls(dev).items():
        cold, warm, event, queued = [], [], [], []
        for _ in range(rounds):
            cold.append(cs.device_ms(fn, cs.KERNEL_REPS, NAMES[name], cold=True))
            warm.append(cs.device_ms(fn, cs.KERNEL_REPS, NAMES[name], cold=False))
            event.append(cs.time_ms(fn, cs.KERNEL_REPS))
            queued.append(cs.queued_ms(fn, cs.KERNEL_REPS))
        c, w, e, q = (statistics.median(x) for x in (cold, warm, event, queued))
        b = bounds[name]
        print(f"{name} ({what}): kernel alone {c:.4f} ms L2 cold (warm {w:.4f}), {e:.4f} ms a wrapper call "
              f"back to back (CUDA events), {q:.4f} ms alone behind a busy stream (CUDA events, L2 cold); bound {b['bound_ms']:.5f} ms ({b['bound_by']}), share "
              f"{b['bound_ms'] / c:.3f} of the cold time; rounds cold {[round(x, 4) for x in cold]} [{card}]")


if __name__ == "__main__":
    main()
