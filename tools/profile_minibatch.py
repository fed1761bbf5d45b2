"""Where the time of a minibatch tape-training step goes, on one CUDA GPU.

    python3 tools/profile_minibatch.py

Builds `chip_smoke.py`'s minibatch cell (bench.py's depth-7 SH9 headline
scene, a 4-view 800x800 rig tape at fx 880, targets the replay of the
true pool) and prints, with the card's name and power limit:

  * host ms per synchronized `train_minibatches` call of N_MB steps of B_MB
    ids (CALLS of them after a warm-up), per step;
  * from `torch.profiler` over one such call: device busy ms per step (the
    union of all device activity intervals), the idle share of the host
    step, and device ms per step of each kernel name, largest first: the
    run gather (K14a), the replay (K13c), the L2 cotangent (K14b, two
    kernels), the gradient zeroing and tape backward (K13d) and the SGD
    update (K14c), each on the card alone, without the host's dispatch;
  * the same for `train_steps` (N_CHAIN steps on the 640,000-ray tape of
    the orbit camera) and for one `grid_weight_render` call (K12 and the
    zeroing of its two grids) on the depth-9 shell's 512^3 grid.

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
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from profile_train_step import busy_us  # noqa: E402
from svox_t_tpu_torch.ops import tape_subset as subset_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera  # noqa: E402

CALLS = 5
TOP = 12


def profile(label: str, fn, n_steps: int, host_ms: float, card: str) -> None:
    """Profile one call of ``fn`` (``n_steps`` steps); print busy ms and the
    kernels' device ms per step beside ``host_ms`` per step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not device:
        raise SystemExit("the profiler recorded no device activity")
    per_name = defaultdict(float)
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3 / n_steps
    print(f"{label}: host {host_ms:.4f} ms per step, device busy {busy:.4f} ms per step, idle share "
          f"{1.0 - busy / host_ms:.4f} [{card}]")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]:
        ms = us / 1e3 / n_steps
        print(f"  {ms:8.4f} ms/step {ms / busy:7.2%}  {name[:110]}")


def host_ms(fn, n_steps: int) -> float:
    fn()
    times = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_steps)
    return min(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_minibatch.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    mb = cs.minibatch_scene(dev)
    rig, spec, opt, tgt, f0 = mb["rig"], mb["spec"], mb["opt"], mb["tgt"], mb["f0"]
    src = stt.TapeRowSource(rig)
    pack = subset_ops.prep_minibatches(
        src, np.random.RandomState(7).randint(0, rig.n_rays, size=(cs.N_MB, cs.B_MB)))

    def minibatches():
        return stt.train_minibatches(src, pack, tgt, f0 * 0.9, opt, lr=cs.MB_LR, spec=spec)

    profile(f"train_minibatches ({cs.N_MB} steps of {cs.B_MB} rays, {rig.n_rays}-ray rig tape)",
            minibatches, cs.N_MB, host_ms(minibatches, cs.N_MB), card)

    tape = mb["r"].record_persp(orbit_camera(), cs.WIDTH, cs.HEIGHT, fx=cs.BENCH_FX, features=f0)
    with torch.no_grad():
        tgt_chain = stt.replay_render(tape, f0, opt, spec)[:, :3].contiguous()

    def chain():
        return stt.train_steps(tape, tgt_chain, f0 * 0.9, opt, cs.N_CHAIN, lr=cs.MB_LR, spec=spec)

    profile(f"train_steps ({cs.N_CHAIN} steps, {tape.n_rays} rays)", chain, cs.N_CHAIN,
            host_ms(chain, cs.N_CHAIN), card)
    del mb, rig, src, pack, tape

    _, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    g = cs.grid_scene(centers_np, feats_np[:, -1], dev)

    def grid():
        return stt.grid_weight_render(g["data"], g["cam"], g["opt"], g["offset"], g["scaling"])

    profile(f"grid_weight_render ({g['data'].shape[0]}^3, {cs.WIDTH}x{cs.HEIGHT})", grid, 1, host_ms(grid, 1),
            card)


if __name__ == "__main__":
    main()
