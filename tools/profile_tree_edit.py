"""Where the time of the tree-editing path goes, on one CUDA GPU.

    python3 tools/profile_tree_edit.py

On the depth-9 SH9 shell of `chip_smoke.py` it runs `chip_smoke.edit_path`
(corners, set, the unique-leaf query, a weighted frame, merge +
shrink_to_fit, refine, each edit re-baked and rendered on both backends)
once to warm up and once under `torch.profiler`, and prints, with the
card's name and power limit:

  * host ms of each step of the path, and of the whole path;
  * device busy ms of the profiled path and its idle share, and device ms
    of each kernel name, largest first;
  * for each tree-editing kernel at the path's shapes (`calc_corners`,
    `assign`, `unique_leaf_nodes`) and for `torch.unique` on the same ids:
    host ms per synchronized call (least of REPS), CUDA-event ms per call
    over REPS back-to-back calls, device busy ms per call from the
    profiler, and device ms per call of each kernel name: a call whose
    event time exceeds its device time waits on the host.

It needs a CUDA GPU and imports no JAX.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch.ops import query as query_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree  # noqa: E402
from profile_train_step import busy_us  # noqa: E402

REPS = 20
TOP = 12


def device_events(prof):
    """The profiler's device activity: kernels, copies and fills."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not events:
        raise SystemExit("the profiler recorded no device activity")
    return events


def per_name(events, calls: int) -> dict:
    out = defaultdict(float)
    for e in events:
        out[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tree_edit.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    state, feats_np, _ = build_shell_tree(depth=chip_smoke.DEPTH, data_format="SH9", data_dim=28)
    feats = torch.from_numpy(feats_np).to(dev)

    def run():
        tree = stt.tree_from_numpy(state, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = chip_smoke.edit_path(tree, feats.clone(), np.random.RandomState(6))
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    res, _ = run()  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res, host_ms = run()
    events = device_events(prof)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
    print(f"editing path, depth {chip_smoke.DEPTH}: host {host_ms:.1f} ms in all, steps "
          f"{ {k: round(v, 3) for k, v in res['ms'].items()} }; device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / host_ms:.4f} [{card}]")
    for name, ms in list(per_name(events, 1).items())[:TOP]:
        print(f"  {ms:9.4f} ms  {name[:110]}")

    ids, N, n_cells = res["unique_args"]
    ops = {
        "calc_corners": lambda: query_ops.calc_corners_cuda(*res["calc_corners_args"]),
        "assign": lambda: query_ops.assign_cuda(*res["assign_args"]),
        "unique_leaf_nodes": lambda: query_ops.unique_leaf_nodes_cuda(ids, N, n_cells=n_cells),
        "torch.unique": lambda: torch.unique(ids, sorted=True),
    }
    for name, fn in ops.items():
        fn()
        host = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        event_ms = chip_smoke.time_ms(fn, REPS)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / REPS
        kernels = ", ".join(f"{k[:60]} {v:.4f}" for k, v in per_name(events, REPS).items())
        print(f"{name}: host {min(host):.4f} ms per synchronized call (least of {REPS}), events "
              f"{event_ms:.4f} ms per call, device busy {busy:.4f} ms per call; per kernel: {kernels} "
              f"[{card}]")


if __name__ == "__main__":
    main()
