"""Smoke run of svox_t_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the package's CUDA kernels from `svox_t_tpu_torch/csrc`, holds
each kernel against its plain PyTorch version at the main paths' shapes
(construct_tree; the forward march in RGBA, SH9, SH9 with rotations,
SG9 and ASG9, with weight accumulation; the backward march in five
cases; the point query forward and backward; the aux kernels, exact and
fast: the opacity VJP, the first hit, the motion-feature forward and
backward; the LBS warp forward and backward, also at 2 joints and 2
bones; the voxelize splat forward and backward), then drives the main
paths through the public entry points on the depth-9 SH9 shell scene at
800x800, with a seeded 32-joint skeleton for the aux and dynamic paths:

  * serving: three frames of `N3Tree.construct_tree` with the frame's
    point cloud and `VolumeRenderer.render_persp` (exact and fast) with
    the frame's feature pool;
  * training: five Adam steps on a feature pool, each re-pointing the
    tree, rendering with `render_persp`, taking an image loss plus a
    density prior through the point query `N3Tree.forward`, and calling
    `backward()`; one step runs inside `N3Tree.accumulate_weights()`;
  * aux serving: three frames of `construct_tree`, `render_persp`,
    `opacity_render`, `render_depth` and `motion_render`;
  * aux training: five Adam steps over the pool and the joint features,
    each taking an image MSE of `render_persp`, an opacity mask loss of
    `opacity_render` and an MSE of `motion_feature_render`;
  * dynamic serving: `VolumeRenderer.render_dynamic_frames` over three
    poses of the leaf-centre cloud skinned to the skeleton (LBS warp,
    re-pointing, render with per-voxel rotations and first-hit depth),
    fast and exact, checked against the eager loop of the public calls,
    and `voxelize` of each frame's warped cloud into a 257^3 grid;
  * dynamic training: three Adam steps on a two-frame pool stack through
    `render_dynamic_frames`;
  * pose fit: three Adam steps on the joints' transforms through
    `warp_vertices` and `voxelize` (the two backward kernels);
  * bench.py's dynamic configuration: a 20,000-point Gaussian cloud on a
    depth-5 RGBA tree, four frames of `render_dynamic_frames`, timed as
    bench.py times them (`dynamic_fused_frame_ms`, `dynamic_fast_frame_ms`).

Each path's launch counts are read from zero around it. It prints kernel
and plain-version times and each kernel's bound with the card's name and
power limit, one JSON line describing the kernels, and as its last line
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
from svox_t_tpu_torch.ops import p2v as p2v_ops
from svox_t_tpu_torch.ops import query as query_ops
from svox_t_tpu_torch.ops import render as render_ops
from svox_t_tpu_torch.ops import render_aux as aux_ops
from svox_t_tpu_torch.ops import traversal
from svox_t_tpu_torch.ops import warp as warp_ops
from svox_t_tpu_torch.utils.scenes import (bench_dynamic_cloud, build_shell_tree,
                                           joint_pose_sequence, orbit_camera, random_lobes,
                                           skin_to_nearest_joints)

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
# The aux path's skeleton, made from a seed: joint positions (the tree's
# extra_data), joint features, and per pool row N_BONES skinning weights
# and joint indices.
N_JOINTS = 32
JOINT_DIM = 16
N_BONES = 4
MASK_WEIGHT = 0.1  # weight of the opacity mask loss in the aux training loss
# The dynamic paths: the leaf centres skinned to the skeleton's N_BONES
# nearest joints, posed by `joint_pose_sequence`; a voxel grid at benchmarks/configs.py's
# config_5 ratios scaled to depth 9 (voxel ~2 leaves, k ~0.93 voxel, cr
# ~1.86 voxel). The sizes are the port's choice, not a published rig.
P2V_N, P2V_KR, P2V_CR = 257, 0.00363, 0.00727
DYN_TRAIN_FRAMES = 2
DYN_STEPS = 3
POSE_LR = 1e-4
WARP_ATOL = 1e-6  # the warp follows its plain version operation for operation
EXACT_RTOL = 1e-6  # deterministic sums in the plain version's order: 1e-6 * max(1, max|plain|)
BENCH_FX = 880.0  # bench.py: fx = W * 1.1
# The bound of a kernel: the larger of its bytes over the H100 SXM's HBM
# rate and its float32 operations over its peak non-tensor rate
# (NVIDIA's data sheet, at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations counted per unit of work for the bounds: a descent
# level (3 scalings, 3 floors, 3 clamps, 3 fraction subtractions); a
# sample's position, clamps, in-leaf DDA and step; and a contributing
# sample's own math in each kernel (SH9 colors, compositing, blends of
# N_BONES joint rows of JOINT_DIM, sigmoids as 3 operations).
OPS_LEVEL = 12
OPS_SAMPLE = 30
OPS_RAY = 40
OPS_FWD_SH9 = 75
OPS_BWD_SH9 = 115
OPS_OPACITY_BWD = 7
OPS_MF_FWD = 2 * N_BONES * JOINT_DIM + 5 * JOINT_DIM + 5
OPS_MF_BWD = 4 * N_BONES * JOINT_DIM + 7 * JOINT_DIM + 5
# The warp per point: a blend of nb rows of 12 (24 per bone) and the
# transform (18); its backward: G (24), dx (15), per bone dw (24) and the
# dT terms and adds (24). Voxelize, each term formed once where it
# varies: per point its window (two subtractions, a division, a rounding
# and two clamps, for each end of each axis: 36); per kept window index of
# an axis the centre, the offset and its square (4); per (x, y) row of the
# window dx^2 + dy^2 (1); per window voxel r^2 and its gate (2); per voxel
# within the radius an exp, a division and a product or atomic add (6)
# forward, and 17 backward.
OPS_WARP_FWD = 24 * N_BONES + 18
OPS_WARP_BWD = 39 + 48 * N_BONES
OPS_P2V_POINT = 36
OPS_P2V_AXIS = 4
OPS_P2V_ROW = 1
OPS_P2V_VOXEL = 2
OPS_P2V_FWD = 6
OPS_P2V_BWD = 17


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


COUNTERS = {
    "construct_tree": query_ops.CONSTRUCT_TREE,
    "render_fwd": render_ops.RENDER_FWD,
    "render_bwd": render_ops.RENDER_BWD,
    "query_fwd": query_ops.QUERY_FWD,
    "query_bwd": query_ops.QUERY_BWD,
    "opacity_bwd": aux_ops.OPACITY_BWD,
    "first_hit": aux_ops.FIRST_HIT,
    "mf_fwd": aux_ops.MF_FWD,
    "mf_bwd": aux_ops.MF_BWD,
    "warp_fwd": warp_ops.WARP_FWD,
    "warp_bwd": warp_ops.WARP_BWD,
    "voxelize_fwd": p2v_ops.VOXELIZE_FWD,
    "voxelize_bwd": p2v_ops.VOXELIZE_BWD,
}


def reset_counts() -> None:
    for k in COUNTERS.values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in COUNTERS.items()}


def skeleton(rng: np.random.RandomState, M: int, device):
    """(joints (N_JOINTS, 3) inside the shell, joint features
    (N_JOINTS, JOINT_DIM), skinning weights (M, N_BONES) whose rows sum to
    1 with some bones 0, joint indices (M, N_BONES) int32)."""
    joints = (0.3 + 0.4 * rng.rand(N_JOINTS, 3)).astype(np.float32)
    jf = rng.randn(N_JOINTS, JOINT_DIM).astype(np.float32)
    w = rng.rand(M, N_BONES).astype(np.float32)
    w[w < 0.25] = 0.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-6)
    ji = rng.randint(0, N_JOINTS, (M, N_BONES)).astype(np.int32)
    return joints, torch.from_numpy(jf).to(device), torch.from_numpy(w).to(device), \
        torch.from_numpy(ji).to(device)


def march_census(spec, feats, origins, dirs, opt) -> dict:
    """What this run's data makes a march do, under the forward's rules
    with exact options: rays that hit the cube, samples, descent levels,
    contributing samples (resident, sigma > 0) and the distinct rows and
    leaf cells they touch; the same up to each ray's first hit. Only the
    bounds read it."""
    o = traversal.world2tree(origins, spec.offset, spec.scaling)
    d, _ = traversal.get_delta_scale(spec.scaling, dirs)
    invdir = 1.0 / (d + 1e-9)
    tmin, tmax = traversal.dda_unit(o, invdir)
    hit = ~((tmax < 0) | (tmin > tmax))
    M = feats.shape[0]
    n_cells = spec.data_flat.numel()
    dev = origins.device
    cells, cells_fh = (torch.zeros(n_cells, dtype=torch.bool, device=dev) for _ in range(2))
    rows, rows_fh = (torch.zeros(M, dtype=torch.bool, device=dev) for _ in range(2))
    n = {k: torch.zeros((), dtype=torch.float64, device=dev)
         for k in ("samples", "levels", "contrib", "fh_samples", "fh_levels")}
    t, active, searching = tmin, hit.clone(), hit.clone()
    log_n = float(np.log2(spec.N))
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        leaf = traversal.descend(spec, o + t[:, None] * d)
        sub_tmin, sub_tmax = traversal.dda_unit(leaf.frac, invdir)
        dt = (sub_tmax - sub_tmin) / leaf.cube_sz + opt.step_size
        idx = leaf.data_idx
        res = active & (idx >= 0) & (idx < M)
        sigma = torch.where(res, feats[torch.where(res, idx, 0).long(), -1], 0.0)
        contrib = res & (sigma > 0)
        levels = torch.round(torch.log2(leaf.cube_sz) / log_n)
        fh = searching & active
        n["samples"] += active.sum()
        n["levels"] += levels[active].sum()
        n["contrib"] += contrib.sum()
        n["fh_samples"] += fh.sum()
        n["fh_levels"] += levels[fh].sum()
        cells[leaf.node_flat[active].long()] = True
        cells_fh[leaf.node_flat[fh].long()] = True
        rows[idx[contrib].long()] = True
        rows_fh[idx[fh & contrib].long()] = True
        searching = searching & ~contrib
        t = torch.where(active, t + dt, t)
        active = active & (t < tmax)
    out = {k: int(v.item()) for k, v in n.items()}
    out.update(rays=origins.shape[0], hits=int(hit.sum()), cells=int(cells.sum()),
               rows=int(rows.sum()), cells_fh=int(cells_fh.sum()), rows_fh=int(rows_fh.sum()))
    return out


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(c: dict, M: int, D: int, n_cells: int, Q: int, q_levels: int) -> dict:
    """bound_ms and bound_by of every kernel at the main path's shapes,
    from the census `c` of the SH9 camera march and Q points that descend
    q_levels levels in all (construct_tree and query). Each input is read
    once and each output written once: rays 12 bytes per vector; a
    march reads the rows and leaf cells (a data and a child entry) that
    its samples touch; gradients of the pool are (M, D) outputs."""
    B, R, C = c["rays"], c["rows"], c["cells"]
    march_ops = OPS_RAY * c["hits"] + OPS_LEVEL * c["levels"] + OPS_SAMPLE * c["samples"]
    fh_ops = OPS_RAY * c["hits"] + OPS_LEVEL * c["fh_levels"] + OPS_SAMPLE * c["fh_samples"]
    lbs_row = 4 + N_BONES * 8  # sigma, skinning weights and joint indices
    jtab = N_JOINTS * JOINT_DIM * 4
    work = {
        "construct_tree": (Q * 12 + Q * 4 + 2 * n_cells * 4, OPS_LEVEL * q_levels),
        "render_fwd": (B * 36 + B * 16 + R * D * 4 + C * 8,
                       march_ops + OPS_FWD_SH9 * c["contrib"]),
        "render_bwd": (B * 36 + 2 * B * 16 + R * D * 4 + C * 8 + M * D * 4,
                       march_ops + OPS_BWD_SH9 * c["contrib"]),
        "query_fwd": (Q * 12 + Q * 8 + min(Q, M) * D * 4 + Q * D * 4 + Q * 8,
                      OPS_LEVEL * q_levels),
        "query_bwd": (Q * 4 + Q * D * 4 + M * D * 4, Q * D),
        "opacity_bwd": (B * 24 + 2 * B * 4 + R * 4 + C * 8 + M * D * 4,
                        march_ops + OPS_OPACITY_BWD * c["contrib"]),
        "first_hit": (B * 24 + c["rows_fh"] * 4 + c["cells_fh"] * 8 + B * 21, fh_ops),
        "mf_fwd": (B * 24 + R * lbs_row + C * 8 + jtab + B * JOINT_DIM * 4,
                   march_ops + OPS_MF_FWD * c["contrib"]),
        "mf_bwd": (B * 24 + B * JOINT_DIM * 4 + R * lbs_row + C * 8 + 2 * jtab,
                   march_ops + OPS_MF_BWD * c["contrib"]),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        ms, by = bound(n_bytes, n_ops)
        out[name] = dict(bound_ms=ms, bound_by=by, bound_bytes=n_bytes, bound_ops=n_ops)
    return out


def p2v_census(points, grid) -> dict:
    """What this run's cloud makes a voxelize do, summed over all points:
    kept window indices per axis, (x, y) rows and voxels of the window
    walked, and voxels within the radius; only the bounds read it."""
    lo, hi = p2v_ops._windows(points, grid)
    kept = torch.clamp(hi - lo + 1, max=grid.W)
    within = sum(int(valid.sum()) for _, _, valid, _, _ in p2v_ops._walk(points, grid))
    return dict(points=points.shape[0], axis=int(kept.sum()),
                rows=int((kept[:, 0] * kept[:, 1]).sum()), walked=int(kept.prod(dim=1).sum()),
                within=within)


def dynamic_bounds(Q: int, nb: int, J: int, F: int, n: int, c: dict, touched: int) -> dict:
    """bound_ms and bound_by of the warp and voxelize kernels for Q points
    of nb bones over J joints, an n^3 grid, the census ``c`` and the
    ``touched`` voxels of a splat. Bytes: the warp forward reads x, w and
    j and writes the warped point and the blend (T is J x 64 bytes); its
    backward also reads both output gradients and writes dx and dw (the
    dT table is J x 64 bytes); voxelize reads each point and its density
    and writes the grid; its backward reads the gradient at the touched
    voxels and writes both input gradients, d_features (Q, F) whole."""
    walk_ops = (OPS_P2V_POINT * c["points"] + OPS_P2V_AXIS * c["axis"]
                + OPS_P2V_ROW * c["rows"] + OPS_P2V_VOXEL * c["walked"])
    work = {
        "warp_fwd": (Q * (12 + 8 * nb) + Q * 76 + J * 64, Q * OPS_WARP_FWD),
        "warp_bwd": (Q * (12 + 8 * nb + 76) + Q * (12 + 4 * nb) + 2 * J * 64, Q * OPS_WARP_BWD),
        "voxelize_fwd": (Q * 16 + n ** 3 * 4, walk_ops + OPS_P2V_FWD * c["within"]),
        "voxelize_bwd": (Q * 16 + touched * 4 + Q * 12 + Q * F * 4,
                         walk_ops + OPS_P2V_BWD * c["within"]),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        ms, by = bound(n_bytes, n_ops)
        out[name] = dict(bound_ms=ms, bound_by=by, bound_bytes=n_bytes, bound_ops=n_ops)
    return out


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


def train_aux(tree, true_pool, pool0, true_jf, jf0, sw, ji, centers, perms, rays, steps,
              width=WIDTH, height=HEIGHT, fx=FX):
    """`steps` Adam steps over a copy of ``pool0`` and of ``jf0`` on the aux
    path: each step re-points the tree at ``centers[perms[k]]`` and takes
    an image MSE of `render_persp`, an opacity mask loss of
    `opacity_render` and an MSE of `motion_feature_render` on ``rays``,
    against targets that ``true_pool`` and ``true_jf`` give with the tree
    pointed at ``centers``. ``sw``/``ji`` are per canonical row.

    :return: (pool, joint features, losses, host ms per step)
    """
    renderer = stt.VolumeRenderer(tree)
    c2w = orbit_camera()
    tree.construct_tree(centers)
    with torch.no_grad():
        t_img = renderer.render_persp(true_pool, c2w, width, height, fx=fx)
        t_alpha = renderer.opacity_render(true_pool, rays)
        t_mf = renderer.motion_feature_render(true_pool, true_jf, sw, ji, rays)
    pool = pool0.clone().requires_grad_()
    jf = jf0.clone().requires_grad_()
    opt = torch.optim.Adam([pool, jf], lr=LR)
    losses, step_ms = [], []
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        perm = perms[k]
        tree.construct_tree(centers[perm])
        frame_pool = pool[perm]
        img = renderer.render_persp(frame_pool, c2w, width, height, fx=fx)
        alpha = renderer.opacity_render(frame_pool, rays)
        mf = renderer.motion_feature_render(frame_pool, jf, sw[perm], ji[perm], rays)
        loss = (((img - t_img) ** 2).mean() + MASK_WEIGHT * ((alpha - t_alpha) ** 2).mean()
                + ((mf - t_mf) ** 2).mean())
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    return pool, jf, losses, step_ms


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
        if "Compiling entry" in line or "Used" in line or "spill" in line:
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
        "opacity_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd.cu",
                            replaces="svox_t_tpu/ops/render_aux.py:58"),
        "first_hit": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                          replaces="svox_t_tpu/ops/render_aux.py:217"),
        "mf_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                       replaces="svox_t_tpu/ops/render_aux.py:403"),
        "mf_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                       replaces="svox_t_tpu/ops/render_aux.py:526"),
        "warp_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/warp.cu",
                         replaces="svox_t_tpu/ops/warp.py:53"),
        "warp_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/warp.cu",
                         replaces="svox_t_tpu/ops/warp.py:53"),
        "voxelize_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/p2v.cu",
                             replaces="svox_t_tpu/ops/p2v.py:37"),
        "voxelize_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/p2v.cu",
                             replaces="svox_t_tpu/ops/p2v.py:37"),
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

    # 3b. Aux kernels against plain on the same scene, with the aux path's
    # seeded skeleton: joints as the tree's extra_data, LBS tables per row.
    joints, jf_true, sw, ji = skeleton(rng, M, dev)
    aux_state = dict(state, extra_data=joints)
    aux_spec = stt.tree_from_numpy(aux_state, device=dev)._spec(
        joint_features=jf_true, skinning_weights=sw, joint_index=ji)
    aux_err = dict(opacity_bwd=0.0, first_hit=0.0, mf_fwd=0.0, mf_bwd=0.0)
    _, ds = traversal.get_delta_scale(aux_spec.scaling, dirs)
    o_tree = traversal.world2tree(origins, aux_spec.offset, aux_spec.scaling)
    d_tree = traversal.get_delta_scale(aux_spec.scaling, dirs)[0]
    for fast in (False, True):
        opt = sh_renderer._get_options(fast)
        mode = "fast" if fast else "exact"
        with torch.no_grad():
            alpha = aux_ops.opacity_render(aux_spec, feats, origins, dirs, opt)
            full = render_ops.volume_render_cuda(aux_spec, feats, origins, dirs, dirs, opt)
        check(torch.equal(alpha, full[:, -1:]), "opacity forward is not the render's alpha")
        g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
        g_k = aux_ops.opacity_backward_cuda(aux_spec, feats, origins, dirs, g_a, opt, out_res=alpha)
        g_p, p_ms = timed_once_ms(lambda: aux_ops.opacity_backward_plain(
            aux_spec, feats, origins, dirs, g_a, opt, out_res=alpha))
        err = atomic_err(g_k, g_p, f"opacity_bwd {mode}")
        check(not bool(g_k[:, :-1].any()), "opacity VJP wrote a color column")
        check(float(g_k[:, -1].abs().max()) > 0, "opacity VJP: zero gradient")
        aux_err["opacity_bwd"] = max(aux_err["opacity_bwd"], err)
        print(f"opacity {mode}: forward equal to the render's alpha; VJP "
              f"({'two passes' if fast else 'one pass'}) max_abs_err {err:.3g} "
              f"(max|g| {float(g_p.abs().max()):.4g}), plain {p_ms:.1f} ms")

        h_k = aux_ops.first_hit_cuda(aux_spec, feats, origins, dirs, opt)
        h_p, p_ms = timed_once_ms(lambda: aux_ops.first_hit_plain(aux_spec, feats, origins, dirs, opt))
        check(torch.equal(h_k[0], h_p[0]) and torch.equal(h_k[2], h_p[2]),
              "first hit: found or rows differ")
        depth_k = torch.where(h_k[0], h_k[1] * ds, 0.0)
        depth_p = torch.where(h_p[0], h_p[1] * ds, 0.0)
        check(torch.equal(depth_k, depth_p), "first hit: depths differ")
        hp_err = float((o_tree + h_k[1][:, None] * d_tree - (o_tree + h_p[1][:, None] * d_tree))
                       .abs().max())
        frac_err = float((h_k[3] - h_p[3]).abs().max())
        check(hp_err <= RENDER_ATOL and frac_err <= RENDER_ATOL,
              f"first hit: hit point {hp_err} or compat frac {frac_err} > {RENDER_ATOL}")
        n_found = int(h_k[0].sum())
        check(n_found > 0, "first hit found nothing")
        aux_err["first_hit"] = max(aux_err["first_hit"], hp_err, frac_err)
        print(f"first hit {mode}: found, rows and depths equal ({n_found} hits), hit point "
              f"max_abs_err {hp_err:.3g}, frac {frac_err:.3g}, plain {p_ms:.1f} ms")

        with torch.no_grad():
            m_k = aux_ops.motion_feature_forward_cuda(aux_spec, jf_true, feats, origins, dirs, opt)
        m_p, p_ms = timed_once_ms(lambda: aux_ops.motion_feature_render_plain(
            aux_spec, jf_true, feats, origins, dirs, opt))
        err = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(m_k).all()), "mf_fwd: non-finite output")
        check(err <= RENDER_ATOL, f"mf_fwd {mode}: kernel vs plain {err} > {RENDER_ATOL}")
        aux_err["mf_fwd"] = max(aux_err["mf_fwd"], err)
        g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
        b_k = aux_ops.motion_feature_backward_cuda(aux_spec, jf_true, feats, origins, dirs, g_m, opt)
        b_p, bp_ms = timed_once_ms(lambda: aux_ops.motion_feature_backward_plain(
            aux_spec, jf_true, feats, origins, dirs, g_m, opt))
        b_err = atomic_err(b_k, b_p, f"mf_bwd {mode}")
        check(float(b_k.abs().max()) > 0, "mf_bwd: zero gradient")
        aux_err["mf_bwd"] = max(aux_err["mf_bwd"], b_err)
        print(f"motion features {mode}: forward max_abs_err {err:.3g}, plain {p_ms:.1f} ms; "
              f"VJP max_abs_err {b_err:.3g} (max|g| {float(b_p.abs().max()):.4g}), "
              f"plain {bp_ms:.1f} ms")
    for k, v in aux_err.items():
        kernels[k]["max_abs_err"] = v

    # 3c. The LBS warp (K10) and the voxelize splat (K11) against their
    # plain versions on the deep dynamic configuration: the canonical
    # cloud is the leaf centres in row order (point i owns pool row i),
    # skinned to the skeleton's N_BONES nearest joints, posed by a seeded
    # sequence; the grid is P2V_N^3 over the unit cube.
    drng = np.random.RandomState(4)
    t0 = time.perf_counter()
    rig_np = skin_to_nearest_joints(centers_np, joints, N_BONES)
    poses = torch.from_numpy(joint_pose_sequence(joints, N_FRAMES, seed=4)).to(dev)
    src = torch.eye(4, device=dev).repeat(N_JOINTS, 1, 1)
    rig_sw, rig_ji = (torch.from_numpy(a).to(dev) for a in rig_np)
    print(f"rig: {N_JOINTS} joints, {N_BONES} nearest per point, {N_FRAMES} poses, "
          f"{time.perf_counter() - t0:.1f} s to build")
    T1 = stt.get_transformation_matrix(src, poses[1])
    wk = warp_ops.warp_forward_cuda(T1, centers, rig_sw, rig_ji)
    wp, warp_fwd_plain_ms = timed_once_ms(
        lambda: warp_ops.warp_forward_plain(T1, centers, rig_sw, rig_ji))
    w_err = max(float((a - b).abs().max()) for a, b in zip(wk, wp))
    check(bool(torch.isfinite(wk[0]).all()), "warp: non-finite points")
    check(w_err <= WARP_ATOL, f"warp_fwd: kernel vs plain {w_err} > {WARP_ATOL}")
    moved = (wk[0] - centers).norm(dim=1)
    print(f"warp_fwd ({M} points, J {N_JOINTS}, {N_BONES} bones): max_abs_err {w_err:.3g} "
          f"(atol {WARP_ATOL}); points move up to {float(moved.max()):.5f} "
          f"(mean {float(moved.mean()):.5f}), plain {warp_fwd_plain_ms:.2f} ms")
    kernels["warp_fwd"]["max_abs_err"] = w_err
    g_x = torch.from_numpy(drng.randn(M, 3).astype(np.float32)).to(dev)
    g_M = torch.from_numpy(drng.randn(M, 4, 4).astype(np.float32)).to(dev)

    def warp_bwd_check(T, sw_, ji_, what):
        got = warp_ops.warp_backward_cuda(T, centers, sw_, ji_, g_x, g_M)
        want, ms = timed_once_ms(
            lambda: warp_ops.warp_backward_plain(T, centers, sw_, ji_, g_x, g_M))
        errs = [atomic_err(got[0], want[0], f"warp_bwd {what} dT")]
        for name, a, b in (("dx", got[1], want[1]), ("dw", got[2], want[2])):
            e = float((a - b).abs().max())
            check(e <= EXACT_RTOL * max(1.0, float(b.abs().max())), f"warp_bwd {what} {name}: {e}")
            errs.append(e)
        check(float(got[0].abs().max()) > 0 and not bool(got[0][:, 3].any()), "warp_bwd: bad dT")
        print(f"warp_bwd {what}: max_abs_err dT {errs[0]:.3g} (max|dT| "
              f"{float(want[0].abs().max()):.4g}), dx {errs[1]:.3g}, dw {errs[2]:.3g}, "
              f"plain {ms:.2f} ms")
        return max(errs), ms

    e32, warp_bwd_plain_ms = warp_bwd_check(T1, rig_sw, rig_ji, f"J {N_JOINTS} nb {N_BONES}")
    # J = 2, nb = 2 (bench.py's rig): every point adds into the same 24 floats.
    z = centers[:, 2]
    sw2 = torch.stack([1.0 - z, z], dim=1).contiguous()
    ji2 = torch.tensor([0, 1], dtype=torch.int32, device=dev).repeat(M, 1)
    T2 = T1[:2].contiguous()
    e2, _ = warp_bwd_check(T2, sw2, ji2, "J 2 nb 2")
    kernels["warp_bwd"]["max_abs_err"] = max(e32, e2)

    grid = p2v_ops.grid_consts(0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
    check(grid.W == 6, f"p2v window {grid.W}, expected 6")
    warped1 = wk[0]
    vk = p2v_ops.voxelize_forward_cuda(warped1, feats, grid)
    vp, vox_fwd_plain_ms = timed_once_ms(lambda: p2v_ops.voxelize_forward_plain(warped1, feats, grid))
    v_err = atomic_err(vk, vp, "voxelize_fwd")
    touched = int((vk != 0).sum())
    g_vol = torch.from_numpy(drng.randn(P2V_N, P2V_N, P2V_N, 1).astype(np.float32)).to(dev)
    dk = p2v_ops.voxelize_backward_cuda(warped1, feats, grid, g_vol)
    dpl, vox_bwd_plain_ms = timed_once_ms(
        lambda: p2v_ops.voxelize_backward_plain(warped1, feats, grid, g_vol))
    vb_err = 0.0
    for name, a, b in (("d_points", dk[0], dpl[0]), ("d_features", dk[1], dpl[1])):
        e = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()), f"voxelize_bwd {name}: non-finite")
        check(e <= EXACT_RTOL * max(1.0, float(b.abs().max())), f"voxelize_bwd {name}: {e}")
        vb_err = max(vb_err, e)
    check(not bool(dk[1][:, :-1].any()) and float(dk[0].abs().max()) > 0,
          "voxelize_bwd: gradient outside the density column, or none")
    kernels["voxelize_fwd"]["max_abs_err"] = v_err
    kernels["voxelize_bwd"]["max_abs_err"] = vb_err
    print(f"voxelize ({M} points, {P2V_N}^3 grid, W {grid.W}): forward max_abs_err {v_err:.3g} "
          f"(max {float(vp.max()):.4g}, {touched} voxels touched), plain {vox_fwd_plain_ms:.1f} ms; "
          f"backward max_abs_err {vb_err:.3g}, plain {vox_bwd_plain_ms:.1f} ms")

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

    # 4c. Main path, aux serving: per frame, render_persp and then
    # opacity_render, render_depth and motion_render on the same camera
    # rays, through the public entry points.
    aux_tree = stt.tree_from_numpy(aux_state, device=dev)
    aux_renderer = stt.VolumeRenderer(aux_tree)
    cam_rays = stt.Rays(origins, dirs, dirs)
    reset_counts()
    aux_frames, aux_frame_s = [], []
    with torch.no_grad():
        for i in range(N_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux_tree.construct_tree(frame_points[i])
            img = aux_renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX)
            alpha = aux_renderer.opacity_render(frame_feats[i], cam_rays)
            depth = aux_renderer.render_depth(frame_feats[i], cam_rays)
            motion = aux_renderer.motion_render(frame_feats[i], cam_rays)
            torch.cuda.synchronize()
            aux_frame_s.append(time.perf_counter() - t0)
            aux_frames.append((img, alpha, depth, motion))
    aux_serve_counts = read_counts()
    print(f"main path, aux serving: {N_FRAMES} frames, launches {aux_serve_counts}, host ms per "
          f"frame (construct + render + opacity + depth + motion) "
          f"{[round(x * 1e3, 3) for x in aux_frame_s]}")
    check(aux_serve_counts["construct_tree"] == N_FRAMES, "construct_tree not launched per frame")
    check(aux_serve_counts["render_fwd"] == 2 * N_FRAMES, "render_fwd not launched by render + opacity")
    check(aux_serve_counts["first_hit"] == 2 * N_FRAMES, "first_hit not launched by depth + motion")
    with torch.no_grad():
        for img, alpha, depth, (motion, depth_m, hit_pt, didx) in aux_frames:
            check(torch.equal(alpha[:, 0], img.reshape(B, -1)[:, -1]), "opacity is not the image's alpha")
            check(torch.equal(depth, depth_m), "render_depth and motion_render disagree")
            found = depth[:, 0] > 0
            check(bool(found.any()) and bool((~found).any()), "no hit or no miss ray")
            check(not bool((found & (alpha[:, 0] == 0)).any()), "a hit ray with alpha 0")
            check(tuple(motion.shape) == (B, N_JOINTS) and bool(torch.isfinite(motion).all()),
                  "bad motion features")
            check(not bool(motion[~found].any()) and not bool(hit_pt[~found].any()), "a miss with a hit")
            check(bool((didx[found] < M).all()), "data_idx outside the pool")
        ref = aux_ops.first_hit_plain(aux_tree._spec(), frame_feats[-1], origins[sample],
                                      dirs[sample], aux_renderer._get_options(False))
        ref_depth = torch.where(ref[0], ref[1] * ds[sample], 0.0)
        check(torch.equal(aux_frames[-1][2][sample, 0], ref_depth),
              "served depth disagrees with the plain version")
        print(f"aux frames: hit share {float((aux_frames[-1][2] > 0).float().mean()):.4f}; last frame "
              f"depth equal to plain on {sample.numel()} pixels")

    # 4d. Main path, aux training: five Adam steps over the pool and the
    # joint features (image MSE + opacity mask loss + motion-feature MSE).
    aux_train_tree = stt.tree_from_numpy(aux_state, device=dev)
    jf_init = torch.from_numpy(rng.randn(N_JOINTS, JOINT_DIM).astype(np.float32)).to(dev)
    reset_counts()
    a_pool, a_jf, a_losses, a_step_ms = train_aux(
        aux_train_tree, true_pool, pool0, jf_true, jf_init, sw, ji, centers, perms, cam_rays, N_STEPS)
    aux_train_counts = read_counts()
    print(f"main path, aux training: {N_STEPS} steps, launches {aux_train_counts}, "
          f"loss {[round(x, 8) for x in a_losses]}, host ms per step {[round(x, 3) for x in a_step_ms]}")
    want = dict(construct_tree=N_STEPS + 1, render_fwd=2 * (N_STEPS + 1), render_bwd=N_STEPS,
                opacity_bwd=N_STEPS, mf_fwd=N_STEPS + 1, mf_bwd=N_STEPS)
    for k, n in want.items():
        check(aux_train_counts[k] == n, f"aux training: {k} launched {aux_train_counts[k]} times, not {n}")
    check(a_losses[-1] < a_losses[0], "the aux loss did not fall")
    for name, x in (("pool", a_pool), ("joint features", a_jf)):
        check(x.grad is not None and bool(torch.isfinite(x.grad).all())
              and float(x.grad.abs().max()) > 0, f"bad {name} gradient")

    # 4e. Main path, dynamic serving: render_dynamic_frames over the pose
    # sequence (warp, re-point with the table carried, render with the
    # blended matrices as rotations, first-hit depth), fast with the tree
    # left untouched, then exact leaving it at the last frame; then one
    # voxelize of each frame's warped cloud.
    dyn_tree = stt.tree_from_numpy(state, device=dev)
    dyn_r = stt.VolumeRenderer(dyn_tree)
    table0 = dyn_tree._spec().data_flat.clone()
    dyn_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, viewdir_rotation=True,
                  with_depth=True)
    dyn_keys = {True: "dynamic_deep9_fast_frame_ms", False: "dynamic_deep9_frame_ms"}

    def dyn_call(fast):
        return dyn_r.render_dynamic_frames(feats, poses, src, centers, rig_sw, rig_ji,
                                           fast=fast, update_tree=not fast, **dyn_kw)

    dyn_counts, dyn_out = [], {}
    with torch.no_grad():
        for fast in (True, False):
            reset_counts()
            cols, deps = dyn_call(fast)
            torch.cuda.synchronize()
            counts = read_counts()
            dyn_counts.append(counts)
            print(f"main path, dynamic serving {'fast' if fast else 'exact'}: {N_FRAMES} frames, "
                  f"launches {counts}")
            for k in ("warp_fwd", "construct_tree", "render_fwd", "first_hit"):
                check(counts[k] == N_FRAMES, f"dynamic serving: {k} launched {counts[k]} times")
            check(tuple(cols.shape) == (N_FRAMES, HEIGHT, WIDTH, 4)
                  and tuple(deps.shape) == (N_FRAMES, HEIGHT, WIDTH, 1), "dynamic output shapes")
            check(bool(torch.isfinite(cols).all() and torch.isfinite(deps).all()), "non-finite frame")
            a = cols[..., 3]
            check(bool((a >= 0).all() and (a <= 1).all() and (a > 0).any() and (a == 0).any()),
                  "dynamic frames: alpha outside [0, 1], or no hit or no miss")
            check(bool(((deps[..., 0] > 0) <= (a > 0)).all()), "a depth where alpha is 0")
            if fast:
                check(torch.equal(dyn_tree._spec().data_flat, table0), "update_tree=False moved the table")
            dyn_out[fast] = (cols, deps)
        carried = dyn_tree._spec().data_flat.clone()
        # Frame times: the calls above warmed both modes up; then three
        # rounds of exact and fast in turn, the least of each per frame.
        dyn_dts = {True: [], False: []}
        for _ in range(3):
            for fast in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dyn_call(fast)
                torch.cuda.synchronize()
                dyn_dts[fast].append((time.perf_counter() - t0) * 1e3 / N_FRAMES)
        dyn_ms = {dyn_keys[fast]: min(dts) for fast, dts in dyn_dts.items()}
        print("main path, dynamic serving: host ms per frame (least of 3 calls) "
              + ", ".join(f"{k} {v:.4f}" for k, v in dyn_ms.items())
              + f"; all calls {({dyn_keys[f]: [round(x, 4) for x in d] for f, d in dyn_dts.items()})}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = []
        for k in range(N_FRAMES):
            tk = stt.get_transformation_matrix(src, poses[k])
            warped, _ = stt.warp_vertices(tk, centers, rig_sw, rig_ji)
            vols.append(stt.voxelize(warped, feats, 0.0, 1.0, P2V_N, P2V_KR, P2V_CR))
        torch.cuda.synchronize()
        p2v_frame_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        vox_counts = read_counts()
        check(vox_counts["voxelize_fwd"] == N_FRAMES, "voxelize not launched per frame")
        mass = [float(v.sum()) for v in vols]
        check(all(np.isfinite(mass)) and min(mass) > 0, f"bad voxel grids {mass}")
        print(f"main path, p2v: warp + voxelize of {N_FRAMES} frames, launches {vox_counts}, "
              f"host ms per frame {p2v_frame_ms:.4f}, grid mass {[round(m, 2) for m in mass]}")

        # The fused loop against the eager loop of the public calls:
        # warp_vertices -> construct_tree -> forward with the mats.
        eager_tree = stt.tree_from_numpy(state, device=dev)
        eager_r = stt.VolumeRenderer(eager_tree)
        tables = []
        for k in range(N_FRAMES):
            tk = stt.get_transformation_matrix(src, poses[k])
            warped, mats = stt.warp_vertices(tk, centers, rig_sw, rig_ji)
            eager_tree.construct_tree(warped)
            tables.append(eager_tree._spec().data_flat.clone())
        check(torch.equal(tables[-1], carried), "carried table differs from eager")
        check(all(not torch.equal(tables[i - 1], tables[i]) for i in range(1, N_FRAMES)),
              "the index table did not change per frame")
        rays_s = stt.Rays(origins[sample], dirs[sample], dirs[sample])
        ref = eager_r(feats, rays_s, transformation_matrices=mats)
        err = float((dyn_out[False][0][-1].reshape(B, 4)[sample] - ref).abs().max())
        check(err <= RENDER_ATOL, f"dynamic frame vs the eager loop: {err}")
        ref_d = eager_r.render_depth(feats, rays_s)
        check(torch.equal(dyn_out[False][1][-1].reshape(B, 1)[sample], ref_d), "dynamic depth differs")
        print(f"dynamic last frame vs the eager loop on {sample.numel()} pixels: max_abs_err "
              f"{err:.3g}, depths equal, tables equal; hit share "
              f"{float((dyn_out[False][0][-1][..., 3] > 0).float().mean()):.4f}")

    # 4f. Main path, dynamic training: Adam steps on a per-frame pool stack
    # through render_dynamic_frames, toward frames the true stack renders.
    tr_r = stt.VolumeRenderer(stt.tree_from_numpy(state, device=dev))
    true_stack = torch.stack([seeded_pool(drng, M, 28, dev) for _ in range(DYN_TRAIN_FRAMES)])
    stack = torch.stack([seeded_pool(drng, M, 28, dev) for _ in range(DYN_TRAIN_FRAMES)])
    tr_args = (poses[:DYN_TRAIN_FRAMES], src, centers, rig_sw, rig_ji)
    tr_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, update_tree=False)
    with torch.no_grad():
        targets = tr_r.render_dynamic_frames(true_stack, *tr_args, **tr_kw)
    stack.requires_grad_()
    adam = torch.optim.Adam([stack], lr=LR)
    dyn_losses, dyn_step_ms = [], []
    reset_counts()
    for _ in range(DYN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        loss = ((tr_r.render_dynamic_frames(stack, *tr_args, **tr_kw) - targets) ** 2).mean()
        loss.backward()
        adam.step()
        torch.cuda.synchronize()
        dyn_step_ms.append((time.perf_counter() - t0) * 1e3)
        dyn_losses.append(loss.item())
    dyn_train_counts = read_counts()
    print(f"main path, dynamic training: {DYN_STEPS} steps of {DYN_TRAIN_FRAMES} frames, launches "
          f"{dyn_train_counts}, loss {[round(x, 8) for x in dyn_losses]}, host ms per step "
          f"{[round(x, 3) for x in dyn_step_ms]}")
    n_fr = DYN_STEPS * DYN_TRAIN_FRAMES
    for k in ("warp_fwd", "construct_tree", "render_fwd", "render_bwd"):
        check(dyn_train_counts[k] == n_fr, f"dynamic training: {k} launched {dyn_train_counts[k]} times")
    check(dyn_losses[-1] < dyn_losses[0], "the dynamic training loss did not fall")
    check(bool(torch.isfinite(stack.grad).all()) and float(stack.grad.abs().max()) > 0,
          "bad pool-stack gradient")

    # 4g. Main path, pose fit: Adam steps on the joints' transforms toward
    # the grid the true pose splats, through warp_vertices and voxelize
    # (their backward kernels).
    with torch.no_grad():
        t_true = stt.get_transformation_matrix(src, poses[1])
        target_vol = stt.voxelize(stt.warp_vertices(t_true, centers, rig_sw, rig_ji)[0], feats,
                                  0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
    t_fit = src.clone().requires_grad_()
    adam = torch.optim.Adam([t_fit], lr=POSE_LR)
    pose_losses, pose_step_ms, pose_grads = [], [], []
    reset_counts()
    for _ in range(DYN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        warped, _ = stt.warp_vertices(t_fit, centers, rig_sw, rig_ji)
        vol = stt.voxelize(warped, feats, 0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
        loss = ((vol - target_vol) ** 2).mean()
        loss.backward()
        pose_grads.append(t_fit.grad.clone())
        adam.step()
        torch.cuda.synchronize()
        pose_step_ms.append((time.perf_counter() - t0) * 1e3)
        pose_losses.append(loss.item())
    pose_counts = read_counts()
    print(f"main path, pose fit: {DYN_STEPS} steps, launches {pose_counts}, loss "
          f"{[round(x, 6) for x in pose_losses]}, max|dT| "
          f"{[float(f'{float(g.abs().max()):.4g}') for g in pose_grads]}, host ms per step "
          f"{[round(x, 3) for x in pose_step_ms]}")
    for k in ("warp_fwd", "warp_bwd", "voxelize_fwd", "voxelize_bwd"):
        check(pose_counts[k] == DYN_STEPS, f"pose fit: {k} launched {pose_counts[k]} times")
    for g in pose_grads:
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 and not bool(g[:, 3].any()),
              "bad transform gradient")
    check(pose_losses[-1] < pose_losses[0], "the pose-fit loss did not fall")

    # 4h. bench.py's dynamic configuration (bench.py:676-732), with this
    # package's N3Tree: per frame warp, re-point and an 800x800 RGBA
    # render; min over three calls of four frames, per frame.
    bd = bench_dynamic_cloud()
    bench_tree = stt.N3Tree(N=2, data_dim=4, depth_limit=6, device=dev)
    bench_tree.refine(repeats=5)
    bench_tree.construct_tree(bd["points"])
    bench_r = stt.VolumeRenderer(bench_tree)
    bench_feats = torch.from_numpy(bd["features"]).to(dev)
    bench_args = [torch.from_numpy(bd[k]).to(dev)
                  for k in ("poses", "src_pose", "points", "skinning_weights", "joint_index")]
    n_bench = bench_args[0].shape[0]

    def bench_run(i, fast):
        outs = bench_r.render_dynamic_frames(bench_feats * (1.0 + 1e-3 * i), *bench_args, c2w=c2w,
                                             width=WIDTH, height=HEIGHT, fx=BENCH_FX,
                                             update_tree=False, fast=fast)
        return float(outs.sum())

    bench_ms = {}
    reset_counts()
    with torch.no_grad():
        for fast, key in ((False, "dynamic_fused_frame_ms"), (True, "dynamic_fast_frame_ms")):
            total = bench_run(0, fast)
            check(np.isfinite(total), "bench dynamic frames: non-finite")
            dts = []
            for i in range(3):
                t0 = time.perf_counter()
                bench_run(i + 1, fast)
                dts.append(time.perf_counter() - t0)
            bench_ms[key] = min(dts) * 1e3 / n_bench
    bench_counts = read_counts()
    check(bench_counts["warp_fwd"] == 8 * n_bench and bench_counts["render_fwd"] == 8 * n_bench,
          "bench dynamic: kernels not launched per frame")
    print(f"main path, bench.py dynamic ({bd['points'].shape[0]} points, depth 5 RGBA, {n_bench} "
          f"frames, fx {BENCH_FX}): launches {bench_counts}, "
          + ", ".join(f"{k} {v:.4f}" for k, v in bench_ms.items()))

    phases = (serve_counts, train_counts, aux_serve_counts, aux_train_counts, *dyn_counts,
              vox_counts, dyn_train_counts, pose_counts, bench_counts)
    for k in kernels:
        kernels[k]["launches"] = sum(c[k] for c in phases)
    for k in ("opacity_bwd", "first_hit", "mf_fwd", "mf_bwd", "warp_fwd", "warp_bwd",
              "voxelize_fwd", "voxelize_bwd"):
        check(kernels[k]["launches"] > 0, f"{k} not launched on the main path")

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
        check(bool((didx < M).all()), "a leaf centre in empty space")
        didx_l = didx.long()
        qb_lib_ms = time_ms(lambda: torch.zeros(M, 28, device=dev).index_add_(0, didx_l, g_v),
                            KERNEL_REPS)
        kernels["query_fwd"].update(ms=qf_ms, plain_ms=qf_plain_ms)
        kernels["query_bwd"].update(ms=qb_ms, plain_ms=qb_plain_ms, library_ms=qb_lib_ms)
        print(f"time query ({M} points, D 28): forward kernel {qf_ms:.4f} ms, plain {qf_plain_ms:.4f} ms; "
              f"backward kernel {qb_ms:.4f} ms, plain {qb_plain_ms:.4f} ms, "
              f"index_add_ {qb_lib_ms:.4f} ms [{card}]")

        # The aux kernels, on the aux scene pointed at the canonical rows.
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            mode = "fast" if fast else "exact"
            alpha = aux_ops.opacity_render(aux_spec, f0, origins, dirs, opt)
            g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
            g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
            runs = {
                "opacity_bwd": (lambda: aux_ops.opacity_backward_cuda(
                                    aux_spec, f0, origins, dirs, g_a, opt, out_res=alpha),
                                lambda: aux_ops.opacity_backward_plain(
                                    aux_spec, f0, origins, dirs, g_a, opt, out_res=alpha)),
                "first_hit": (lambda: aux_ops.first_hit_cuda(aux_spec, f0, origins, dirs, opt),
                              lambda: aux_ops.first_hit_plain(aux_spec, f0, origins, dirs, opt)),
                "mf_fwd": (lambda: aux_ops.motion_feature_forward_cuda(
                               aux_spec, jf_true, f0, origins, dirs, opt),
                           lambda: aux_ops.motion_feature_render_plain(
                               aux_spec, jf_true, f0, origins, dirs, opt)),
                "mf_bwd": (lambda: aux_ops.motion_feature_backward_cuda(
                               aux_spec, jf_true, f0, origins, dirs, g_m, opt),
                           lambda: aux_ops.motion_feature_backward_plain(
                               aux_spec, jf_true, f0, origins, dirs, g_m, opt)),
            }
            for name, (run_k, run_p) in runs.items():
                k_ms = time_ms(run_k, KERNEL_REPS)
                p_ms = time_ms(run_p, 1)
                print(f"time {name} SH9 {mode} {WIDTH}x{HEIGHT} (J {N_JOINTS}, Kd {JOINT_DIM}, "
                      f"{N_BONES} bones): kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms [{card}]")
                if not fast:
                    kernels[name].update(ms=k_ms, plain_ms=p_ms)

        # The warp and voxelize kernels at the deep configuration's shapes
        # (the warp backward forms all three gradients); plain: one call,
        # phase 3c.
        runs = {
            "warp_fwd": lambda: warp_ops.warp_forward_cuda(T1, centers, rig_sw, rig_ji),
            "warp_bwd": lambda: warp_ops.warp_backward_cuda(T1, centers, rig_sw, rig_ji, g_x, g_M),
            "voxelize_fwd": lambda: p2v_ops.voxelize_forward_cuda(warped1, feats, grid),
            "voxelize_bwd": lambda: p2v_ops.voxelize_backward_cuda(warped1, feats, grid, g_vol),
        }
        plain_once = dict(warp_fwd=warp_fwd_plain_ms, warp_bwd=warp_bwd_plain_ms,
                          voxelize_fwd=vox_fwd_plain_ms, voxelize_bwd=vox_bwd_plain_ms)
        for name, run_k in runs.items():
            k_ms = time_ms(run_k, KERNEL_REPS)
            kernels[name].update(ms=k_ms, plain_ms=plain_once[name])
            print(f"time {name} ({M} points, J {N_JOINTS}, {N_BONES} bones, {P2V_N}^3 grid): "
                  f"kernel {k_ms:.4f} ms, plain {plain_once[name]:.2f} ms (one call) [{card}]")
        w2_ms = time_ms(lambda: warp_ops.warp_backward_cuda(T2, centers, sw2, ji2, g_x, g_M),
                        KERNEL_REPS)
        w2_dt_ms = time_ms(lambda: warp_ops.warp_backward_cuda(T2, centers, sw2, ji2, g_x, None,
                                                               True, False, False), KERNEL_REPS)
        print(f"time warp_bwd J 2 nb 2 ({M} points): kernel {w2_ms:.4f} ms, dT only "
              f"{w2_dt_ms:.4f} ms [{card}]")

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
    print(f"time dynamic frames (render_dynamic_frames, host clock, synchronized): "
          + ", ".join(f"{k} {v:.4f}" for k, v in {**dyn_ms, **bench_ms}.items())
          + f"; dynamic training step median {statistics.median(dyn_step_ms):.3f} ms, pose-fit step "
          f"median {statistics.median(pose_step_ms):.3f} ms, warp + voxelize per frame "
          f"{p2v_frame_ms:.4f} ms [{card}]")

    # 6. Bounds: the least time of each kernel's work at these shapes,
    # from what this run's data makes the march do (exact SH9 camera).
    census = march_census(spec, feats, origins, dirs, sh_renderer._get_options(False))
    leaf = traversal.descend(spec, traversal.world2tree(pts, spec.offset, spec.scaling))
    q_levels = int(torch.round(torch.log2(leaf.cube_sz) / float(np.log2(spec.N))).sum())
    bounds = kernel_bounds(census, M, 28, spec.data_flat.numel(), pts.shape[0], q_levels)
    print(f"census (SH9 exact, {WIDTH}x{HEIGHT}): {census}")
    p2v_c = p2v_census(warped1, grid)
    bounds.update(dynamic_bounds(M, N_BONES, N_JOINTS, 28, P2V_N, p2v_c, touched))
    print(f"census (voxelize, {P2V_N}^3, W {grid.W}): {p2v_c}, {touched} voxels touched")
    for k, b in bounds.items():
        kernels[k].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        kernels[k].setdefault("library_ms", None)
        print(f"bound {k}: {b['bound_bytes'] / 1e6:.2f} MB, {b['bound_ops'] / 1e9:.4f} Gop -> "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}); kernel {kernels[k]['ms']:.4f} ms, "
              f"{b['bound_ms'] / kernels[k]['ms']:.3f} of the bound [{card}]")

    # 7. Result lines
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [dict(name=k, **{key: v[key] for key in keys})
                                  for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
