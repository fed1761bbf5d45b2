"""Where the time of a pose-fit step and of a warp + voxelize frame goes, on
one CUDA GPU, with this tree's K10 and K11 kernels and, beside them, an
earlier commit's.

    python3 tools/profile_pose_fit.py [--parent DIR] [--rounds N]

Drives the two dynamic paths that run K10 and K11, as `chip_smoke.py`
drives them, on the depth-9 SH9 shell's 1,404,480 leaf centres skinned to
a seeded 32-joint skeleton's 4 nearest joints (`warp_bwd_ab.deep_rig`),
the 257^3 grid over the unit cube:

  * ``pose fit`` (phase 4g): an Adam step on the joints' transforms toward
    the grid that pose 1 splats: `warp_vertices`, `voxelize`, the squared
    error, `backward()` (K11's and K10's backward kernels), `Adam.step`;
  * ``p2v frame`` (phase 4e): a frame's `get_transformation_matrix`,
    `warp_vertices` and `voxelize` (poses 0-2 in turn, no gradient).

The script compiles the `warp` and `p2v` units of this tree (``change``)
and, with ``--parent DIR`` (for example ``git archive`` of the parent
unpacked in DIR), of DIR's tree (``parent``), one nvcc each, and runs this
tree's wrappers on either library's C entries (their signatures are the
same). In each of ROUNDS rounds, libraries in turns (parent, change, change,
parent), it times CALLS synchronized calls of each path on the host clock,
then profiles ACTIVE calls with `torch.profiler`: the device busy ms a
call (the union of the device activity), the idle share of the median host
call, and the device ms a call of each kernel. It prints each library's
medians over the rounds, with the card's name and power limit. Needs one
CUDA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
import warp_bwd_ab as wab  # noqa: E402
from profile_train_step import busy_us  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import p2v as p2v_ops  # noqa: E402
from svox_t_tpu_torch.ops import warp as warp_ops  # noqa: E402

ROUNDS = 4
CALLS = 5
ACTIVE = 3
UNITS = ("warp", "p2v")
KERNELS = {"svox_warp_fwd": warp_ops.WARP_FWD, "svox_warp_bwd": warp_ops.WARP_BWD,
           "svox_voxelize_fwd": p2v_ops.VOXELIZE_FWD, "svox_voxelize_bwd": p2v_ops.VOXELIZE_BWD}


def bind(path: Path):
    """Points the four wrappers' kernels (and the joint limit) at the C
    entries of the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    for symbol, kernel in KERNELS.items():
        fn = getattr(lib, symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        kernel._fn = fn
    warp_ops.kernel_max_joints = lib.svox_warp_max_joints


def measure(fn) -> dict:
    """Host ms of CALLS synchronized calls (median), then the device busy ms
    a call and the device ms a call of each kernel over ACTIVE profiled
    calls."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ACTIVE):
            fn()
            torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    cs.check(len(device) > 0, "the profiler recorded no device activity")
    per_name = defaultdict(float)
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / ACTIVE
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / ACTIVE
    return dict(host=statistics.median(host), busy=busy, kernels=dict(per_name))


def paths(rig: dict, dev) -> dict:
    """{path: a call of it}."""
    centers, sw, ji, poses, src, feats = (rig[k] for k in ("centers", "sw", "ji", "poses", "src", "feats"))
    grid = (0.0, 1.0, cs.P2V_N, cs.P2V_KR, cs.P2V_CR)
    with torch.no_grad():
        target = stt.voxelize(rig["warped"], feats, *grid)
    t_fit = src.clone().requires_grad_()
    adam = torch.optim.Adam([t_fit], lr=cs.POSE_LR)

    def pose_fit():
        adam.zero_grad(set_to_none=True)
        warped, _ = stt.warp_vertices(t_fit, centers, sw, ji)
        loss = ((stt.voxelize(warped, feats, *grid) - target) ** 2).mean()
        loss.backward()
        adam.step()

    frame = [0]

    def p2v_frame():
        k = frame[0] % poses.shape[0]
        frame[0] += 1
        with torch.no_grad():
            tk = stt.get_transformation_matrix(src, poses[k])
            warped, _ = stt.warp_vertices(tk, centers, sw, ji)
            stt.voxelize(warped, feats, *grid)

    return {"pose fit": pose_fit, "p2v frame": p2v_frame}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K10 and K11 kernels run beside this tree's")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_pose_fit.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"change": (_build.CSRC, UNITS)}
        if args.parent is not None:
            sources["parent"] = (args.parent / "svox_t_tpu_torch" / "csrc", UNITS)
        libs = fab.compile_libraries(Path(tmp), sources, wab.report)
        rig = wab.deep_rig(dev)
        res = {(name, path): [] for name in libs for path in ("pose fit", "p2v frame")}
        order = (["parent"] if "parent" in libs else []) + ["change"]
        for rnd in range(args.rounds):
            for name in (order + order[::-1]) if rnd % 2 == 0 else (order[::-1] + order):
                bind(libs[name])
                for path, fn in paths(rig, dev).items():
                    res[name, path].append(measure(fn))
    for path in ("pose fit", "p2v frame"):
        for name in order:
            runs = res[name, path]
            host = statistics.median(r["host"] for r in runs)
            busy = statistics.median(r["busy"] for r in runs)
            names = sorted({k for r in runs for k in r["kernels"]},
                           key=lambda k: -statistics.median(r["kernels"].get(k, 0.0) for r in runs))
            print(f"{path} ({name}): {len(runs)} measurements in turns; host ms a call median {host:.4f} "
                  f"(each {[round(r['host'], 4) for r in runs]}), device busy ms a call {busy:.4f} (each "
                  f"{[round(r['busy'], 4) for r in runs]}), idle share of the median host call "
                  f"{1.0 - busy / host:.4f} [{card}]")
            for k in names[:10]:
                ms = statistics.median(r["kernels"].get(k, 0.0) for r in runs)
                print(f"  {ms:8.4f} ms/call {ms / busy:7.2%}  {k[:100]}")


if __name__ == "__main__":
    main()
