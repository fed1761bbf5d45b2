"""Smoke run of svox_t_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the package's CUDA kernels from `svox_t_tpu_torch/csrc`, holds
each kernel against its plain PyTorch version at the main paths' shapes
(construct_tree; the forward march in RGBA, SH9, SH9 with rotations,
SG9 and ASG9, with weight accumulation; the backward march in five
cases; the point query forward and backward), then drives the two main
paths through the public entry points on the depth-9 SH9 shell scene at
800x800:

  * serving: three frames of `N3Tree.construct_tree` with the frame's
    point cloud and `VolumeRenderer.render_persp` (exact and fast) with
    the frame's feature pool;
  * training: five Adam steps on a feature pool, each re-pointing the
    tree, rendering with `render_persp`, taking an image loss plus a
    density prior through the point query `N3Tree.forward`, and calling
    `backward()`; one step runs inside `N3Tree.accumulate_weights()`.

It prints kernel and plain-version times with the card's name and power
limit, one JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}. Any failed phase raises and the script
exits nonzero. It needs a CUDA GPU and does not fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu_torch import _build
from svox_t_tpu_torch.ops import query as query_ops
from svox_t_tpu_torch.ops import render as render_ops
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera, random_lobes

DEPTH = 9
WIDTH = HEIGHT = 800
FX = 1111.111
N_FRAMES = 3
N_STEPS = 5
LR = 0.05
# Weight of the density prior (mean |sigma| at sampled leaf centres,
# through the point query) in the training loss; small beside the image
# loss.
PRIOR_WEIGHT = 1e-8
N_PRIOR_POINTS = 65536
RENDER_ATOL = 2e-5  # fma-free builds on both sides; covers expf ulps
ATOMIC_RTOL = 1e-5  # float atomics sum in another order: 1e-5 * max(1, max|plain|)
KERNEL_REPS = 10


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def atomic_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max|got - want|, checked against ATOMIC_RTOL * max(1, max|want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    bound = ATOMIC_RTOL * max(1.0, float(want.abs().max()) if want.numel() else 1.0)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel result")
    check(err <= bound, f"{what}: kernel vs plain {err} > {bound}")
    return err


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the device, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once_ms(fn):
    """(result, device ms) of one call, measured with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def random_rotations(M: int, rng: np.random.RandomState, device) -> torch.Tensor:
    """(M, 4, 4) float32 rotations from normalized random quaternions."""
    q = rng.randn(M, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    m = np.zeros((M, 4, 4), np.float32)
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y - z * w)
    m[:, 0, 2] = 2 * (x * z + y * w)
    m[:, 1, 0] = 2 * (x * y + z * w)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z - x * w)
    m[:, 2, 0] = 2 * (x * z - y * w)
    m[:, 2, 1] = 2 * (y * z + x * w)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    m[:, 3, 3] = 1
    return torch.from_numpy(m).to(device)


def seeded_pool(rng: np.random.RandomState, M: int, D: int, device) -> torch.Tensor:
    """A feature pool like the scene's: coefficients ~0.3, densities 10-40+."""
    f = (rng.randn(M, D) * 0.3).astype(np.float32)
    f[:, -1] = np.abs(rng.randn(M)).astype(np.float32) * 30.0 + 10.0
    return torch.from_numpy(f).to(device)


def camera_rays(device):
    c2w = torch.as_tensor(orbit_camera(), device=device)
    origins, dirs = render_ops.cam2world_rays(c2w, WIDTH, HEIGHT, FX, FX)
    return origins.contiguous(), dirs.contiguous()


def reset_counts() -> None:
    for k in (query_ops.CONSTRUCT_TREE, query_ops.QUERY_FWD, query_ops.QUERY_BWD,
              render_ops.RENDER_FWD, render_ops.RENDER_BWD):
        k.launches = 0


def read_counts() -> dict:
    return {"construct_tree": query_ops.CONSTRUCT_TREE.launches,
            "render_fwd": render_ops.RENDER_FWD.launches,
            "render_bwd": render_ops.RENDER_BWD.launches,
            "query_fwd": query_ops.QUERY_FWD.launches,
            "query_bwd": query_ops.QUERY_BWD.launches}


def train(tree, true_pool, pool0, centers, perms, prior_points, steps,
          width=WIDTH, height=HEIGHT, fx=FX, accumulate_at=-1, after_step=None):
    """`steps` Adam steps on a copy of ``pool0`` (canonical leaf order)
    toward the image that ``true_pool`` renders with the tree pointed at
    ``centers``. Step k points the tree at ``centers[perms[k]]``, so that
    frame's pool is ``pool[perms[k]]``: every frame shows each leaf its
    own canonical row. Step ``accumulate_at`` renders inside
    `N3Tree.accumulate_weights()`; ``after_step()``, if given, is called
    after every step.

    :return: (pool, losses, image losses, host ms per step, weights from
        the accumulated step)
    """
    renderer = stt.VolumeRenderer(tree)
    c2w = orbit_camera()
    tree.construct_tree(centers)
    with torch.no_grad():
        target = renderer.render_persp(true_pool, c2w, width, height, fx=fx)
    pool = pool0.clone().requires_grad_()
    opt = torch.optim.Adam([pool], lr=LR)
    sync = torch.cuda.synchronize if pool.is_cuda else (lambda: None)
    losses, image_losses, step_ms, weights = [], [], [], None
    for k in range(steps):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        tree.construct_tree(centers[perms[k]])
        frame_pool = pool[perms[k]]
        accumulate = tree.accumulate_weights() if k == accumulate_at else contextlib.nullcontext()
        with accumulate as acc:
            img = renderer.render_persp(frame_pool, c2w, width, height, fx=fx)
        image_loss = ((img - target) ** 2).mean()
        prior = tree(frame_pool, prior_points)[:, -1].abs().mean()
        loss = image_loss + PRIOR_WEIGHT * prior
        loss.backward()
        opt.step()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        image_losses.append(image_loss.item())
        if acc is not None:
            weights = acc()
        if after_step is not None:
            after_step()
    return pool, losses, image_losses, step_ms, weights


def main() -> None:
    # 1. Device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. Build
    b = _build.build()
    print(f"build: {b.seconds:.1f} s -> {b.path.name}")
    for line in b.log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  ptxas:", line.strip())

    # Scenes (NumPy, seeded) and device tables
    t0 = time.perf_counter()
    state, feats_np, centers_np = build_shell_tree(depth=DEPTH, data_format="SH9", data_dim=28)
    rgba_state, rgba_np, _ = build_shell_tree(depth=DEPTH, data_format="RGBA", data_dim=4)
    M = feats_np.shape[0]
    print(f"scene: depth {DEPTH}, {state['child'].shape[0]} nodes, {M} leaves, "
          f"{time.perf_counter() - t0:.1f} s to build")
    rng = np.random.RandomState(0)
    centers = torch.from_numpy(centers_np).to(dev)
    origins, dirs = camera_rays(dev)
    B = origins.shape[0]
    kernels = {
        "construct_tree": dict(route="cuda", source="svox_t_tpu_torch/csrc/construct_tree.cu",
                               replaces="svox_t_tpu/ops/query.py:130"),
        "render_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_fwd.cu",
                           replaces="svox_t_tpu/ops/render.py:851"),
        "render_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd.cu",
                           replaces="svox_t_tpu/ops/render.py:1296"),
        "query_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/query.cu",
                          replaces="svox_t_tpu/ops/query.py:46"),
        "query_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/query.cu",
                          replaces="svox_t_tpu/ops/query.py:76"),
    }

    # 3. Kernel vs plain
    tree = stt.tree_from_numpy(state, device=dev)
    spec = tree._spec()
    points = centers[torch.from_numpy(rng.permutation(M)).to(dev)]
    got = query_ops.construct_tree_cuda(spec, points)
    torch.cuda.synchronize()
    want = query_ops.construct_tree_plain(spec, points)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "construct_tree kernel and plain version disagree")
    changed = int((got != spec.data_flat).sum())
    check(changed > 0, "construct_tree changed no slot")
    kernels["construct_tree"]["max_abs_err"] = 0.0
    print(f"construct_tree: {M} points, index tables equal ({changed} slots re-pointed)")

    feats = torch.from_numpy(feats_np).to(dev)
    rgba_tree = stt.tree_from_numpy(rgba_state, device=dev)
    rgba_feats = torch.from_numpy(rgba_np).to(dev)
    rot = random_rotations(M, rng, dev)
    sh_renderer = stt.VolumeRenderer(tree)
    lobe_pool = seeded_pool(rng, M, 28, dev)
    lobe_trees = {fmt: stt.tree_from_numpy(dict(state, data_format=f"{fmt}9",
                                                extra_data=random_lobes(fmt, 9, seed=1)), device=dev)
                  for fmt in ("SG", "ASG")}
    cases = [
        ("RGBA", rgba_tree._spec(), rgba_feats, stt.VolumeRenderer(rgba_tree)),
        ("SH9", tree._spec(), feats, sh_renderer),
        ("SH9+rot", tree._spec(transformation_matrices=rot), feats, sh_renderer),
        ("SG9", lobe_trees["SG"]._spec(), lobe_pool, stt.VolumeRenderer(lobe_trees["SG"])),
        ("ASG9", lobe_trees["ASG"]._spec(), lobe_pool, stt.VolumeRenderer(lobe_trees["ASG"])),
    ]
    worst = 0.0
    fwd_plain_ms = {}
    with torch.no_grad():
        for name, cspec, cfeats, rend in cases:
            for fast in (False, True):
                opt = rend._get_options(fast)
                out_k = render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt)
                out_p, p_ms = timed_once_ms(
                    lambda: render_ops.volume_render_plain(cspec, cfeats, origins, dirs, dirs, opt))
                fwd_plain_ms[(name, fast)] = p_ms
                err = float((out_k - out_p).abs().max())
                worst = max(worst, err)
                hit = float((out_k[:, -1] > 0).float().mean())
                print(f"render_fwd {name} {'fast' if fast else 'exact'}: "
                      f"max_abs_err {err:.3g} (atol {RENDER_ATOL}), hit share {hit:.3f}, "
                      f"plain {p_ms:.1f} ms")
                check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
                check(err <= RENDER_ATOL, f"{name} fast={fast}: kernel vs plain {err} > {RENDER_ATOL}")

        # Weight accumulation (K2 with a weight buffer), SH9 exact and fast.
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            out_k, w_k = render_ops.volume_render_with_weight_accum_cuda(
                spec, feats, origins, dirs, dirs, opt)
            (out_p, w_p), fwd_plain_ms[("SH9+waccum", fast)] = timed_once_ms(
                lambda: render_ops.volume_render_with_weight_accum_plain(
                    spec, feats, origins, dirs, dirs, opt))
            err = float((out_k - out_p).abs().max())
            check(err <= RENDER_ATOL, f"weight-accumulating march: outputs differ by {err}")
            w_err = atomic_err(w_k, w_p, f"waccum fast={fast}")
            worst = max(worst, err, w_err)
            total = float(w_k.sum())
            print(f"render_fwd+waccum SH9 {'fast' if fast else 'exact'}: out max_abs_err {err:.3g}, "
                  f"waccum max_abs_err {w_err:.3g} (max|w| {float(w_p.abs().max()):.4g}), "
                  f"sum {total:.6g}, alpha sum {float(out_k[:, -1].sum()):.6g}, "
                  f"plain {fwd_plain_ms[('SH9+waccum', fast)]:.1f} ms")
            check(total > 0, "no weight accumulated")
            if not fast:
                alpha_sum = float(out_k[:, -1].sum())
                check(abs(total - alpha_sum) <= 1e-4 * abs(alpha_sum),
                      f"exact waccum sum {total} != alpha sum {alpha_sum}")
    kernels["render_fwd"]["max_abs_err"] = worst

    # K3 against plain: one seeded grad_out per case.
    bwd_cases = [
        ("SH9 exact", tree._spec(), feats, sh_renderer, False),
        ("SH9 fast", tree._spec(), feats, sh_renderer, True),
        ("RGBA exact", rgba_tree._spec(), rgba_feats, cases[0][3], False),
        ("SH9+rot exact", tree._spec(transformation_matrices=rot), feats, sh_renderer, False),
        ("SG9 exact", lobe_trees["SG"]._spec(), lobe_pool, cases[3][3], False),
    ]
    worst = 0.0
    bwd_plain_ms = {}
    for name, cspec, cfeats, rend, fast in bwd_cases:
        opt = rend._get_options(fast)
        with torch.no_grad():
            out = render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt)
        g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
        g_k = render_ops.volume_render_backward_cuda(cspec, cfeats, origins, dirs, dirs,
                                                     g_out, opt, out_res=out)
        g_p, bwd_plain_ms[name] = timed_once_ms(lambda: render_ops.volume_render_backward_plain(
            cspec, cfeats, origins, dirs, dirs, g_out, opt, out_res=out))
        err = atomic_err(g_k, g_p, f"render_bwd {name}")
        worst = max(worst, err)
        nz = int((g_k != 0).any(dim=1).sum())
        check(nz > 0, f"render_bwd {name}: zero gradient")
        print(f"render_bwd {name}: max_abs_err {err:.3g} (max|g| {float(g_p.abs().max()):.4g}), "
              f"{nz} rows with a gradient, plain {bwd_plain_ms[name]:.1f} ms")
    kernels["render_bwd"]["max_abs_err"] = worst

    # K8b query against plain: leaf centres in a seeded order plus seeded
    # points, some in empty space.
    q_points = torch.cat([centers[torch.from_numpy(rng.permutation(M)).to(dev)],
                          torch.from_numpy(rng.rand(65536, 3).astype(np.float32)).to(dev)])
    v_k, n_k, d_k = query_ops.query_forward_cuda(spec, feats, q_points)
    v_p, n_p, d_p = query_ops.query_forward_plain(spec, feats, q_points)
    check(torch.equal(v_k, v_p) and torch.equal(n_k, n_p) and torch.equal(d_k, d_p),
          "query forward kernel and plain version disagree")
    empty = int((d_k >= M).sum())
    check(empty > 0, "no query point in empty space")
    g_v = torch.from_numpy(rng.randn(*v_k.shape).astype(np.float32)).to(dev)
    gq_k = query_ops.query_backward_cuda(d_k, g_v, M)
    gq_p = query_ops.query_backward_plain(d_p, g_v, M)
    q_err = atomic_err(gq_k, gq_p, "query_bwd")
    check(float(gq_k.abs().max()) > 0, "query_bwd: zero gradient")
    kernels["query_fwd"]["max_abs_err"] = 0.0
    kernels["query_bwd"]["max_abs_err"] = q_err
    print(f"query: {q_points.shape[0]} points ({empty} in empty space), values and ids equal, "
          f"grad max_abs_err {q_err:.3g}")

    # 4. Main path, serving: three frames through the public entry points
    frame_points = [centers[torch.from_numpy(rng.permutation(M)).to(dev)] for _ in range(N_FRAMES)]
    frame_feats = [seeded_pool(rng, M, 28, dev) for _ in range(N_FRAMES)]
    serve_tree = stt.tree_from_numpy(state, device=dev)
    renderer = stt.VolumeRenderer(serve_tree)
    c2w = orbit_camera()
    sample = torch.arange(0, B, 97, device=dev)
    reset_counts()
    frame_s = []
    images = []
    tables = []
    with torch.no_grad():
        for i in range(N_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_tree.construct_tree(frame_points[i])
            img_exact = renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX)
            img_fast = renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX, fast=True)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            images.append((img_exact, img_fast))
            tables.append(serve_tree._spec().data_flat.clone())
    serve_counts = read_counts()
    print(f"main path, serving: {N_FRAMES} frames, launches {serve_counts}, "
          f"host ms per frame (construct + exact + fast) {[round(s * 1e3, 3) for s in frame_s]}")
    check(serve_counts["construct_tree"] == N_FRAMES, "construct_tree kernel not launched per frame")
    check(serve_counts["render_fwd"] == 2 * N_FRAMES, "render kernel not launched per render")

    # Outputs are right: shape, finite, alpha in [0, 1], hits and misses,
    # and a strided pixel sample equal to the plain version on the same
    # frame state.
    with torch.no_grad():
        for i, (img_exact, img_fast) in enumerate(images):
            for fast, img in ((False, img_exact), (True, img_fast)):
                check(tuple(img.shape) == (HEIGHT, WIDTH, 4), f"image shape {tuple(img.shape)}")
                check(bool(torch.isfinite(img).all()), "non-finite image")
                a = img[..., 3]
                check(bool((a >= 0).all() and (a <= 1).all()), "alpha outside [0, 1]")
                check(bool((a > 0).any() and (a == 0).any()), "no hit or no miss pixels")
        spec_last = serve_tree._spec()
        opt_e = renderer._get_options(False)
        ref = render_ops.volume_render_plain(spec_last, frame_feats[-1], origins[sample],
                                             dirs[sample], dirs[sample], opt_e)
        err = float((images[-1][0].reshape(B, 4)[sample] - ref).abs().max())
        print(f"last frame exact vs plain on {sample.numel()} pixels: max_abs_err {err:.3g}")
        check(err <= RENDER_ATOL, f"served frame disagrees with plain version: {err}")
        for i in range(1, N_FRAMES):
            check(not torch.equal(tables[i - 1], tables[i]), "index table did not change per frame")

    # 4b. Main path, training: five Adam steps through the public entry points
    train_tree = stt.tree_from_numpy(state, device=dev)
    true_pool = seeded_pool(rng, M, 28, dev)
    pool0 = seeded_pool(rng, M, 28, dev)
    perms = [torch.from_numpy(rng.permutation(M)).to(dev) for _ in range(N_STEPS)]
    prior_points = centers[torch.from_numpy(rng.choice(M, N_PRIOR_POINTS, replace=False)).to(dev)]
    reset_counts()
    pool, losses, image_losses, step_ms, weights = train(
        train_tree, true_pool, pool0, centers, perms, prior_points, N_STEPS,
        accumulate_at=N_STEPS // 2)
    train_counts = read_counts()
    print(f"main path, training: {N_STEPS} steps, launches {train_counts}, "
          f"loss {[round(x, 8) for x in losses]}, image loss {[round(x, 8) for x in image_losses]}, "
          f"host ms per step {[round(s, 3) for s in step_ms]}")
    # construct_tree runs once more per call of train(): the target's pointing.
    check(train_counts["construct_tree"] == N_STEPS + 1, "construct_tree not launched per step")
    check(train_counts["render_fwd"] == N_STEPS + 1, "render_fwd not launched per step")
    check(train_counts["render_bwd"] == N_STEPS, "render_bwd not launched once per step")
    check(train_counts["query_fwd"] == N_STEPS and train_counts["query_bwd"] == N_STEPS,
          "query kernels not launched per step")
    check(losses[-1] < losses[0] and image_losses[-1] < image_losses[0], "the loss did not fall")
    check(pool.grad is not None and bool(torch.isfinite(pool.grad).all()), "non-finite gradient")
    check(float(pool.grad.abs().max()) > 0, "zero gradient")
    check(weights is not None and weights.shape == (train_tree.n_leaves,), "no accumulated weights")
    check(bool(torch.isfinite(weights).all()) and float(weights.sum()) > 0, "bad accumulated weights")
    print(f"accumulated weights: {weights.shape[0]} leaves, sum {float(weights.sum()):.6g}, "
          f"{int((weights > 0).sum())} leaves with weight")
    for k in kernels:
        kernels[k]["launches"] = serve_counts[k] + train_counts[k]

    # 5. Times (CUDA events, after one warm-up)
    spec_t = serve_tree._spec()
    pts = frame_points[0]
    f0 = frame_feats[0]
    with torch.no_grad():
        ct_ms = time_ms(lambda: query_ops.construct_tree_cuda(spec_t, pts), KERNEL_REPS)
        ct_plain_ms = time_ms(lambda: query_ops.construct_tree_plain(spec_t, pts), 3)
        kernels["construct_tree"].update(ms=ct_ms, plain_ms=ct_plain_ms)
        print(f"time construct_tree ({M} points): kernel {ct_ms:.4f} ms, plain {ct_plain_ms:.4f} ms [{card}]")
        for fast in (False, True):
            opt = renderer._get_options(fast)
            k_ms = time_ms(lambda: render_ops.volume_render_cuda(spec_t, f0, origins, dirs, dirs, opt), KERNEL_REPS)
            p_ms = time_ms(lambda: render_ops.volume_render_plain(spec_t, f0, origins, dirs, dirs, opt), 1)
            w_ms = time_ms(lambda: render_ops.volume_render_with_weight_accum_cuda(
                spec_t, f0, origins, dirs, dirs, opt), KERNEL_REPS)
            mode = "fast" if fast else "exact"
            print(f"time render_fwd SH9 {mode} {WIDTH}x{HEIGHT}: kernel {k_ms:.4f} ms "
                  f"({B / k_ms / 1e3:.2f} Mrays/s), plain {p_ms:.1f} ms "
                  f"({B / p_ms / 1e3:.4f} Mrays/s); with weight accumulation kernel {w_ms:.4f} ms, "
                  f"plain {fwd_plain_ms[('SH9+waccum', fast)]:.1f} ms (one call, phase 3) [{card}]")
            if not fast:
                kernels["render_fwd"].update(ms=k_ms, plain_ms=p_ms)
            out = render_ops.volume_render_cuda(spec_t, f0, origins, dirs, dirs, opt)
            g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
            b_ms = time_ms(lambda: render_ops.volume_render_backward_cuda(
                spec_t, f0, origins, dirs, dirs, g_out, opt, out_res=out), KERNEL_REPS)
            bp_ms = time_ms(lambda: render_ops.volume_render_backward_plain(
                spec_t, f0, origins, dirs, dirs, g_out, opt, out_res=out), 1)
            passes = "two passes" if fast else "single pass"
            print(f"time render_bwd SH9 {mode} ({passes}) {WIDTH}x{HEIGHT}: kernel {b_ms:.4f} ms, "
                  f"plain {bp_ms:.1f} ms [{card}]")
            if not fast:
                kernels["render_bwd"].update(ms=b_ms, plain_ms=bp_ms)
        for name, cspec, cfeats, rend in cases[3:]:
            opt = rend._get_options(False)
            l_ms = time_ms(lambda: render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt),
                           KERNEL_REPS)
            print(f"time render_fwd {name} exact {WIDTH}x{HEIGHT}: kernel {l_ms:.4f} ms, "
                  f"plain {fwd_plain_ms[(name, False)]:.1f} ms (one call, phase 3) [{card}]")
        qpts = frame_points[0]
        qf_ms = time_ms(lambda: query_ops.query_forward_cuda(spec_t, f0, qpts), KERNEL_REPS)
        qf_plain_ms = time_ms(lambda: query_ops.query_forward_plain(spec_t, f0, qpts), 3)
        _, _, didx = query_ops.query_forward_cuda(spec_t, f0, qpts)
        g_v = torch.from_numpy(rng.randn(M, 28).astype(np.float32)).to(dev)
        qb_ms = time_ms(lambda: query_ops.query_backward_cuda(didx, g_v, M), KERNEL_REPS)
        qb_plain_ms = time_ms(lambda: query_ops.query_backward_plain(didx, g_v, M), 3)
        kernels["query_fwd"].update(ms=qf_ms, plain_ms=qf_plain_ms)
        kernels["query_bwd"].update(ms=qb_ms, plain_ms=qb_plain_ms)
        print(f"time query ({M} points, D 28): forward kernel {qf_ms:.4f} ms, plain {qf_plain_ms:.4f} ms; "
              f"backward kernel {qb_ms:.4f} ms, plain {qb_plain_ms:.4f} ms [{card}]")

    # Forward + backward of a render loss, as bench.py names it:
    # fwd_bwd_ms sustained (CUDA events over KERNEL_REPS calls),
    # fwd_bwd_single_call_ms one synchronized call on the host clock (min of 3).
    opt_e = renderer._get_options(False)
    g_img = torch.from_numpy(rng.randn(B, 4).astype(np.float32)).to(dev)
    fb_pool = f0.clone().requires_grad_()

    def fwd_bwd():
        out = render_ops.volume_render(spec_t, fb_pool, origins, dirs, dirs, opt_e)
        return torch.autograd.grad((out * g_img).sum(), fb_pool)[0]

    fwd_bwd_ms = time_ms(fwd_bwd, KERNEL_REPS)
    single = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)
    step_med = statistics.median(step_ms)
    print(f"time fwd_bwd SH9 exact {WIDTH}x{HEIGHT}: fwd_bwd_ms {fwd_bwd_ms:.4f}, "
          f"fwd_bwd_single_call_ms {min(single):.4f}, fwd_bwd_mrays_s {B / fwd_bwd_ms / 1e3:.2f} [{card}]")
    print(f"time training step (construct_tree + render_persp + loss + query prior + backward + Adam), "
          f"host clock: median {step_med:.3f} ms of {[round(s, 3) for s in step_ms]} [{card}]")

    # 6. Result lines
    print(card)
    print(json.dumps({"kernels": [dict(name=k, **v) for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
