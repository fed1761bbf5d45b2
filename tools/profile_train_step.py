"""Where the time of a training step goes, on one CUDA GPU.

    python3 tools/profile_train_step.py

Runs the training step of `chip_smoke.py` (construct_tree with a
permuted point cloud, the pool gather `pool[perm]`, `render_persp` at
800x800, MSE, the point-query prior, `backward()`, Adam) on the depth-9
SH9 shell scene and prints, with the card's name and power limit:

  * host ms per synchronized step, STEPS of them after one warm-up step,
    and the median;
  * from `torch.profiler` over ACTIVE steady steps: device busy ms
    per step (the union of all device activity intervals), the idle share
    of the median host step, and device ms per step of each kernel name,
    largest first.

It needs a CUDA GPU and imports no JAX.
"""

from __future__ import annotations

import statistics
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402

STEPS = 10
ACTIVE = 5
TOP = 15


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    state, _, centers_np = build_shell_tree(depth=chip_smoke.DEPTH, data_format="SH9", data_dim=28)
    M = centers_np.shape[0]
    rng = np.random.RandomState(0)
    centers = torch.from_numpy(centers_np).to(dev)
    true_pool = chip_smoke.seeded_pool(rng, M, 28, dev)
    pool0 = chip_smoke.seeded_pool(rng, M, 28, dev)
    n = 1 + max(STEPS, 2 + ACTIVE)
    perms = [torch.from_numpy(rng.permutation(M)).to(dev) for _ in range(n)]
    prior_points = centers[torch.from_numpy(
        rng.choice(M, min(chip_smoke.N_PRIOR_POINTS, M), replace=False)).to(dev)]

    def run(steps, after_step=None):
        tree = stt.tree_from_numpy(state, device=dev)
        return chip_smoke.train(tree, true_pool, pool0, centers, perms, prior_points,
                                steps, after_step=after_step)[3]

    step_ms = run(1 + STEPS)[1:]
    med = statistics.median(step_ms)
    print(f"depth {chip_smoke.DEPTH}, {M} leaves: host ms per step {[round(s, 3) for s in step_ms]}, "
          f"median {med:.4f} [{card}]")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(skip_first=1, wait=0, warmup=2, active=ACTIVE, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        run(3 + ACTIVE, after_step=prof.step)
    # Device activity: kernels, copies and fills, without the ranges that
    # annotations (ProfilerStep#, Optimizer.step#...) mirror on the device.
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not device:
        raise SystemExit("the profiler recorded no device activity")
    per_name = defaultdict(float)
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / ACTIVE
    print(f"device busy {busy:.4f} ms per step, idle share of the median host step "
          f"{1.0 - busy / med:.4f} ({ACTIVE} profiled steps) [{card}]")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]:
        ms = us / 1e3 / ACTIVE
        print(f"  {ms:8.4f} ms/step {ms / busy:7.2%}  {name[:110]}")


if __name__ == "__main__":
    main()
