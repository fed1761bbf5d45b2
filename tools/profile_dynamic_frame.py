"""Where the time of a dynamic frame goes, on one CUDA GPU.

    python3 tools/profile_dynamic_frame.py

Drives `VolumeRenderer.render_dynamic_frames` as `chip_smoke.py`'s
dynamic phases do, in three cases, each on the default baked backend and
on the tree walk (`backend="tree"`):

  * deep serving: the depth-9 SH9 shell, its leaf centres skinned to a
    seeded 32-joint rig (4 nearest joints), three poses, 800x800, exact,
    with per-voxel rotations and first-hit depth;
  * deep training: one step on a two-frame pool stack (render, image
    MSE, `backward()`, Adam);
  * bench.py's dynamic configuration: 20,000 points on a depth-5 RGBA
    tree, four frames, 800x800, exact and fast.

Then, for deep serving and bench.py's configuration, exact and fast,
PAIRS alternating pairs of one call per backend, host clock only.

For each it prints, with the card's name and power limit, the host ms
per synchronized call (CALLS calls after a warm-up, and their median),
then from `torch.profiler` over ACTIVE calls the device busy ms per call
(the union of all device activity intervals), the idle share of the
median host call, and device ms per call of each kernel name, largest
first. It needs a CUDA GPU and imports no JAX.
"""

from __future__ import annotations

import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from profile_train_step import busy_us  # noqa: E402
from svox_t_tpu_torch.utils.scenes import (bench_dynamic_cloud, build_shell_tree,  # noqa: E402
                                           joint_pose_sequence, orbit_camera,
                                           skin_to_nearest_joints)

CALLS = 5
ACTIVE = 3
TOP = 14
PAIRS = 10


def profile(name: str, fn, frames: int, card: str) -> None:
    """Time ``fn`` (one synchronized call = ``frames`` frames) and profile it."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(host)
    print(f"{name}: host ms per call {[round(h, 3) for h in host]}, median {med:.4f} "
          f"({med / frames:.4f} per frame) [{card}]")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=ACTIVE, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(1 + ACTIVE):
            fn()
            torch.cuda.synchronize()
            prof.step()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not device:
        raise SystemExit("the profiler recorded no device activity")
    per_name = defaultdict(float)
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / ACTIVE
    print(f"  device busy {busy:.4f} ms per call ({busy / frames:.4f} per frame), idle share of "
          f"the median host call {1.0 - busy / med:.4f} ({ACTIVE} profiled calls) [{card}]")
    for kname, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]:
        ms = us / 1e3 / ACTIVE
        print(f"  {ms:8.4f} ms/call {ms / busy:7.2%}  {kname[:100]}")


def alternating_pairs(name: str, calls: dict, frames: int, card: str) -> None:
    """PAIRS pairs of one synchronized call per backend (``calls`` maps
    "baked" and "tree" to a call of ``frames`` frames), alternating which
    runs first, after a warm-up call each: host ms per frame."""
    def timed(fn):
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / frames

    for fn in calls.values():
        timed(fn)
    per_frame = {b: [] for b in calls}
    for i in range(PAIRS):
        for b in (("baked", "tree") if i % 2 == 0 else ("tree", "baked")):
            per_frame[b].append(timed(calls[b]))
    wins = sum(a < t for a, t in zip(per_frame["baked"], per_frame["tree"]))
    stats = {b: (statistics.median(v), *statistics.quantiles(v, n=4)[::2])
             for b, v in per_frame.items()}
    print(f"{name}, {PAIRS} alternating pairs, ms per frame (median, quartiles): " + ", ".join(
        f"{b} {m:.4f} ({q1:.4f}-{q3:.4f})" for b, (m, q1, q3) in stats.items())
        + f"; the bake faster in {wins} of {PAIRS} [{card}]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_dynamic_frame.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    state, feats_np, centers_np = build_shell_tree(depth=chip_smoke.DEPTH, data_format="SH9",
                                                   data_dim=28)
    M = centers_np.shape[0]
    rng = np.random.RandomState(0)
    joints = chip_smoke.skeleton(rng, M, dev)[0]
    sw, ji = (torch.from_numpy(a).to(dev)
              for a in skin_to_nearest_joints(centers_np, joints, chip_smoke.N_BONES))
    poses = torch.from_numpy(joint_pose_sequence(joints, chip_smoke.N_FRAMES, seed=4)).to(dev)
    src = torch.eye(4, device=dev).repeat(chip_smoke.N_JOINTS, 1, 1)
    centers = torch.from_numpy(centers_np).to(dev)
    feats = torch.from_numpy(feats_np).to(dev)
    c2w = orbit_camera()
    cam = dict(c2w=c2w, width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, fx=chip_smoke.FX)
    T = chip_smoke.DYN_TRAIN_FRAMES
    stack0 = torch.stack([chip_smoke.seeded_pool(rng, M, 28, dev) for _ in range(T)])
    true_stack = torch.stack([chip_smoke.seeded_pool(rng, M, 28, dev) for _ in range(T)])
    bd = bench_dynamic_cloud()
    bargs = [torch.from_numpy(bd[k]).to(dev)
             for k in ("features", "poses", "src_pose", "points", "skinning_weights", "joint_index")]

    for backend in ("baked", "tree"):
        r = stt.VolumeRenderer(stt.tree_from_numpy(state, device=dev), backend=backend)

        def serve():
            with torch.no_grad():
                r.render_dynamic_frames(feats, poses, src, centers, sw, ji, update_tree=False,
                                        with_depth=True, **cam)

        profile(f"deep serving ({backend}; 3 frames, exact, rotations, depth)", serve,
                chip_smoke.N_FRAMES, card)

        stack = stack0.clone().requires_grad_()
        with torch.no_grad():
            targets = r.render_dynamic_frames(true_stack, poses[:T], src, centers, sw, ji,
                                              update_tree=False, **cam)
        adam = torch.optim.Adam([stack], lr=chip_smoke.LR)

        def train_step():
            adam.zero_grad(set_to_none=True)
            out = r.render_dynamic_frames(stack, poses[:T], src, centers, sw, ji,
                                          update_tree=False, **cam)
            ((out - targets) ** 2).mean().backward()
            adam.step()

        profile(f"deep training step ({backend}; {T} frames)", train_step, T, card)

        bench_tree = stt.N3Tree(N=2, data_dim=4, depth_limit=6, device=dev)
        bench_tree.refine(repeats=5)
        bench_tree.construct_tree(bd["points"])
        br = stt.VolumeRenderer(bench_tree, backend=backend)
        for fast in (False, True):

            def bench():
                with torch.no_grad():
                    br.render_dynamic_frames(*bargs, c2w=c2w, width=chip_smoke.WIDTH,
                                             height=chip_smoke.HEIGHT, fx=chip_smoke.BENCH_FX,
                                             update_tree=False, fast=fast)

            profile(f"bench.py dynamic ({backend}; 4 frames, {'fast' if fast else 'exact'})",
                    bench, bargs[1].shape[0], card)

    # Host-clock frame times spread between calls and machines more than
    # the backends differ: alternating pairs of calls settle their order.
    deep = {b: stt.VolumeRenderer(stt.tree_from_numpy(state, device=dev), backend=b)
            for b in ("baked", "tree")}
    bench_r = {}
    for backend in ("baked", "tree"):
        t = stt.N3Tree(N=2, data_dim=4, depth_limit=6, device=dev)
        t.refine(repeats=5)
        t.construct_tree(bd["points"])
        bench_r[backend] = stt.VolumeRenderer(t, backend=backend)
    for fast in (False, True):
        mode = "fast" if fast else "exact"
        alternating_pairs(f"deep serving, {mode}", {
            b: (lambda r=r, fast=fast: r.render_dynamic_frames(
                feats, poses, src, centers, sw, ji, update_tree=False, with_depth=True, fast=fast,
                **cam)) for b, r in deep.items()}, chip_smoke.N_FRAMES, card)
        alternating_pairs(f"bench.py dynamic, {mode}", {
            b: (lambda r=r, fast=fast: r.render_dynamic_frames(
                *bargs, c2w=c2w, width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT,
                fx=chip_smoke.BENCH_FX, update_tree=False, fast=fast)) for b, r in bench_r.items()},
            bargs[1].shape[0], card)


if __name__ == "__main__":
    main()
