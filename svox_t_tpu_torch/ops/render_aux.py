"""Auxiliary render passes, the counterpart of
`svox_t_tpu/ops/render_aux.py`: opacity (with its sigma-only VJP), the
first-hit passes `render_depth` and `motion_render`, and volumetric LBS
motion-feature rendering (with its corrected VJP).

Each march dispatches on the device of its tensors, as `ops/render.py`
does: on CUDA it launches its kernel or raises; on the CPU it runs its
plain PyTorch version, a step loop vectorized over rays that the kernel
follows operation for operation. The kernels:

  * opacity forward: K2 (`csrc/render_fwd.cu`) with ``dirs`` as view
    directions, keeping its alpha column, so `opacity_render` equals the
    render's alpha bit for bit;
  * opacity backward (K9a): the sigma-only instance of K3
    (`csrc/render_bwd.cu`, `OPACITY_BWD`);
  * first hit (K9b), motion-feature forward (K9c) and backward (K9d):
    `csrc/render_aux.cu` (`FIRST_HIT`, `MF_FWD`, `MF_BWD`).

On a `BakedTree` each pass runs its baked instance
(`csrc/render_bwd_baked.cu`, `csrc/render_aux_baked.cu`; the counters
with ``_BAKED``). The march rules are those of `ops/render.py` (the
forward's for the forward passes, the backward's for the VJPs; on a bake
the cull, box advance and skip boxes too, except that the motion-feature
passes keep the cube test as their hit); the header of
`csrc/render_aux.cuh` states what each pass adds to them. Joint indices
are clamped to [0, J) where the motion-feature passes read or add a
joint row, as a JAX gather clamps.

Under ``opt.interp`` (K4) every pass reads the trilinear sigma of its
sample's corners (`render.interp_corners`), with no box cull, also in an
empty leaf, as the JAX package does: the opacity VJP adds into the
corners' rows; the first hit's t is the first sample over the threshold,
its row the first such sample whose own row is < M; the motion-feature
passes attenuate wherever sigma passes and blend only where the own row
is < M. Each has its own interp kernel instance (`csrc/*_interp.cu`).

The pool is a float32 or bf16 tensor or a `render.QuantizedFeatures`
(K5, as in `ops/render.py`): every pass reads its sigma column in the
pool's type and turns it into float32 right after the gather
(`render.gather_rows`). The opacity VJP sums a bf16 pool's gradient in
float32 and casts it once; a quantized pool takes no gradient, but
`motion_feature_render` over one still differentiates with respect to
the joint features. The first-hit and motion-feature kernels have bf16
and int8 instances (``_BF16``, ``_I8``), the opacity VJP bf16 ones.
Sharded options raise NotImplementedError, as in `ops/render.py`.

State carried across from the JAX package: the tree (with its
``extra_data`` joints) moves with `tree_state`/`tree_from_numpy`; joint
features, skinning weights and joint indices are plain arrays that both
packages take, so NumPy copies of them serve both.
"""

from __future__ import annotations

import ctypes
from ctypes import c_float, c_int, c_void_p
from typing import NamedTuple

import torch

from .._build import Kernel
from ..utils.spec import RenderOptions, TreeSpec
from . import render as render_ops
from .bake import BakedTree, StructureDesc
from .bake import lookup as bake_lookup
from .render import (Corners, QuantizedFeatures, _check_kernel_tensors, _corners, _interp,
                     _kernel_for, _locate, _ray_setup, _require, _sample_leaf, _scatter_rows,
                     _sigmoid, _stream, _structure_arg, gather_rows, march_instances, pool_args,
                     pool_dtype, sample_position)
from .traversal import LeafInfo, tree2world

# Leading arguments of the four aux entry points, in order.
_AUX_ARGS = [
    ctypes.POINTER(StructureDesc),                  # tree or bake
    c_void_p, c_void_p, c_int,                      # origins, dirs, B
    c_void_p, c_void_p,                             # offset, scaling
    c_void_p, c_void_p, c_void_p, c_int, c_int,     # features, scale, zero, M, D
    c_float, c_int,                                 # step, max_steps
]
_OPACITY_ARGS = _AUX_ARGS + [c_void_p, c_void_p, c_void_p,  # grad_out, out_res, grad
                             c_int, c_void_p]               # device, stream
_FIRST_HIT_ARGS = _AUX_ARGS + [c_float,                     # sigma_thresh
                               c_void_p, c_void_p, c_void_p, c_void_p,  # found, t_hit, row, frac
                               c_int, c_void_p]
_MF_ARGS = _AUX_ARGS + [c_void_p, c_int, c_int,     # joint_features, J, Kd
                        c_void_p, c_void_p, c_int]  # skinning_weights, joint_index, nb
_MF_FWD_ARGS = _MF_ARGS + [c_float, c_float, c_float,          # sigma/stop thresh, bg
                           c_void_p, c_int, c_int, c_void_p]   # out, width, device, stream
_MF_BWD_ARGS = _MF_ARGS + [c_void_p, c_void_p,                 # grad_out, grad
                           c_int, c_int, c_void_p]             # width, device, stream
# Each pass's instances (`render.march_instances`): the opacity VJP for
# float32 and bf16 pools (a quantized pool takes no gradient), the others
# for int8 pools too.
_OPACITY_INSTANCES = march_instances("opacity_bwd", _OPACITY_ARGS, ("f32", "bf16"))
_FIRST_HIT_INSTANCES = march_instances("first_hit", _FIRST_HIT_ARGS, ("f32", "bf16", "i8"))
_MF_FWD_INSTANCES = march_instances("mf_fwd", _MF_FWD_ARGS, ("f32", "bf16", "i8"))
_MF_BWD_INSTANCES = march_instances("mf_bwd", _MF_BWD_ARGS, ("f32", "bf16", "i8"))
OPACITY_BWD, OPACITY_BWD_BAKED, OPACITY_BWD_INTERP, OPACITY_BWD_BAKED_INTERP = \
    _OPACITY_INSTANCES["f32"]
FIRST_HIT, FIRST_HIT_BAKED, FIRST_HIT_INTERP, FIRST_HIT_BAKED_INTERP = _FIRST_HIT_INSTANCES["f32"]
MF_FWD, MF_FWD_BAKED, MF_FWD_INTERP, MF_FWD_BAKED_INTERP = _MF_FWD_INSTANCES["f32"]
MF_BWD, MF_BWD_BAKED, MF_BWD_INTERP, MF_BWD_BAKED_INTERP = _MF_BWD_INSTANCES["f32"]
(OPACITY_BWD_BF16, OPACITY_BWD_BAKED_BF16, OPACITY_BWD_INTERP_BF16,
 OPACITY_BWD_BAKED_INTERP_BF16) = _OPACITY_INSTANCES["bf16"]
(FIRST_HIT_BF16, FIRST_HIT_BAKED_BF16, FIRST_HIT_INTERP_BF16,
 FIRST_HIT_BAKED_INTERP_BF16) = _FIRST_HIT_INSTANCES["bf16"]
(FIRST_HIT_I8, FIRST_HIT_BAKED_I8, FIRST_HIT_INTERP_I8,
 FIRST_HIT_BAKED_INTERP_I8) = _FIRST_HIT_INSTANCES["i8"]
(MF_FWD_BF16, MF_FWD_BAKED_BF16, MF_FWD_INTERP_BF16, MF_FWD_BAKED_INTERP_BF16) = \
    _MF_FWD_INSTANCES["bf16"]
(MF_FWD_I8, MF_FWD_BAKED_I8, MF_FWD_INTERP_I8, MF_FWD_BAKED_INTERP_I8) = _MF_FWD_INSTANCES["i8"]
(MF_BWD_BF16, MF_BWD_BAKED_BF16, MF_BWD_INTERP_BF16, MF_BWD_BAKED_INTERP_BF16) = \
    _MF_BWD_INSTANCES["bf16"]
(MF_BWD_I8, MF_BWD_BAKED_I8, MF_BWD_INTERP_I8, MF_BWD_BAKED_INTERP_I8) = _MF_BWD_INSTANCES["i8"]
# Joint-feature columns the motion-feature kernels hold in registers, and
# the largest joint table the backward sums in 48 KB of shared memory, in
# floats: J * (Kd | 1), its rows padded to an odd stride.
KERNEL_MAX_JOINT_DIM = 32
KERNEL_MAX_JOINT_TABLE = 12288
# Shared memory the vector instances (width 4) of K9c and K9d may take for
# the joint table and K9d's gradient table, in bytes (`csrc/render_aux.cuh`
# kSmemBudget).
KERNEL_MF_VECTOR_SMEM = 40 * 1024
# Launches of K9c and of K9d by vector width (`mf_width`), every structure,
# interp mode and pool type.
MF_FWD_WIDTH_LAUNCHES = {1: 0, 4: 0}
MF_BWD_WIDTH_LAUNCHES = {1: 0, 4: 0}


def _check(spec: TreeSpec, features, origins, dirs, opt: RenderOptions) -> None:
    render_ops._check_supported(spec, features, origins, dirs, dirs, opt)


def _aux_args(spec: TreeSpec, features, origins, dirs, opt: RenderOptions, name: str):
    """Check an aux kernel's inputs and return the leading arguments
    (`_AUX_ARGS`)."""
    _check(spec, features, origins, dirs, opt)
    _check_kernel_tensors(spec, features, (origins, dirs), name)
    M, D = features.shape
    return (
        _structure_arg(spec, opt), origins.data_ptr(), dirs.data_ptr(), origins.shape[0],
        spec.offset.data_ptr(), spec.scaling.data_ptr(), *pool_args(features), M, D,
        opt.step_size, opt.max_steps,
    )


class _Sample(NamedTuple):
    leaf: LeafInfo
    dt: torch.Tensor
    idx: torch.Tensor
    resident: torch.Tensor  # row < M
    rows: torch.Tensor      # idx where resident, else 0 (int64)
    sigma: torch.Tensor     # nearest: 0 in empty space; interp: the corners'
    corners: Corners        # interp: the corners (`render.interp_corners`); else None


def _sample(spec, features, opt: RenderOptions, rays, t) -> _Sample:
    """One sample of every ray at t (plain): its leaf, step, row and
    sigma (in `render.pool_dtype`); under ``opt.interp`` the sigma
    interpolated from its corners, also where its own leaf is empty."""
    leaf, dt = _sample_leaf(spec, opt, rays, t)
    idx = leaf.data_idx
    M = features.shape[0]
    resident = (idx >= 0) & (idx < M)
    rows = torch.where(resident, idx, 0).long()
    if opt.interp:
        corners = _corners(spec, rays, t, leaf, M)
        return _Sample(leaf, dt, idx, resident, rows,
                       _interp(corners, lambda r: gather_rows(features, r, -1)), corners)
    sigma = torch.where(resident, gather_rows(features, rows, -1), 0.0)
    return _Sample(leaf, dt, idx, resident, rows, sigma, None)


# ---------------------------------------------------------------------------
# Opacity
# ---------------------------------------------------------------------------


def opacity_render(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                   dirs: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """Alpha-only render, (B, 1) = 1 - transmittance; differentiable with
    respect to ``features`` (the gradient lands in column D - 1)."""
    return _OpacityFn.apply(spec, features, origins, dirs, opt)


class _OpacityFn(torch.autograd.Function):
    """`opacity_render` with the sigma-only VJP (JAX: its custom_vjp).
    The spec and options are captured at forward time."""

    @staticmethod
    def forward(ctx, spec, features, origins, dirs, opt):
        out, _ = render_ops._render(spec, features, origins, dirs, dirs, opt, False)
        alpha = out[:, -1:].contiguous()
        render_ops._save(ctx, spec, features, opt, origins, dirs, alpha)
        return alpha

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None, None
        features, origins, dirs, alpha = ctx.saved_tensors
        grad = opacity_backward(ctx.spec, features, origins, dirs,
                                grad_out.contiguous(), ctx.opt, out_res=alpha)
        return None, grad, None, None, None


def _single_pass(opt: RenderOptions, out_res) -> bool:
    return opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0 and out_res is not None


def _check_alpha_grads(features, origins, grad_out, out_res) -> None:
    for name, g in (("grad_out", grad_out), ("out_res", out_res)):
        if g is not None and tuple(g.shape) != (origins.shape[0], 1):
            raise ValueError(f"{name} must be (B, 1), got {tuple(g.shape)}")
        if g is not None and g.device != features.device:
            raise ValueError(f"{name} on {g.device}, features on {features.device}")


def opacity_backward(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                     dirs: torch.Tensor, grad_out: torch.Tensor, opt: RenderOptions,
                     out_res=None) -> torch.Tensor:
    """Gradient of `opacity_render` with respect to the pool, (M, D) in
    the pool's type (summed in float32, cast once), zero but in column
    D - 1. With ``out_res`` (the forward alpha) and exact options it takes
    one pass, otherwise two. A quantized pool takes no gradient."""
    if isinstance(features, QuantizedFeatures):
        raise TypeError("a quantized feature pool takes no gradient")
    march = opacity_backward_cuda if origins.is_cuda else opacity_backward_plain
    return march(spec, features, origins, dirs, grad_out, opt, out_res).to(features.dtype)


def opacity_backward_plain(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                           dirs: torch.Tensor, grad_out: torch.Tensor, opt: RenderOptions,
                           out_res=None) -> torch.Tensor:
    """Plain PyTorch version of the opacity VJP kernel (K9a).

    The backward's rules: samples while hit and ``t < tmax``, a sample
    contributes where ``sigma > 0`` (nearest mode: its row is < M), no
    early stop. Each contributing sample adds ``dt*ds * (g * L_ray)`` into
    column D - 1 (under interp ``w_c`` times that into each corner's row),
    with ``L_ray = 1 - alpha`` (single pass) or the final L of a first
    march under the same rules (two passes). Summed in `render.pool_dtype`
    (float32 for a bf16 pool)."""
    _check(spec, features, origins, dirs, opt)
    _check_alpha_grads(features, origins, grad_out, out_res)
    M, D = features.shape
    grad = torch.zeros(M, D, dtype=pool_dtype(features), device=features.device)
    if M == 0 or origins.shape[0] == 0:
        return grad
    rays = _ray_setup(spec, origins, dirs, opt)
    g = grad_out[:, 0]
    if _single_pass(opt, out_res):
        L_ray = 1.0 - out_res[:, 0]
    else:
        L_ray = _opacity_march_plain(spec, features, opt, rays, None, None)
    _opacity_march_plain(spec, features, opt, rays, g * L_ray, grad)
    return grad


def _opacity_march_plain(spec, features, opt, rays, gL, grad):
    """One sigma-only backward march; adds ``dt*ds * gL`` into column
    D - 1 of ``grad`` when given. Returns the final L."""
    o, d, invdir, delta_scale, tmin, tmax, hit = rays
    t = tmin
    L = torch.ones_like(tmin)
    col = torch.zeros(features.shape[0], dtype=L.dtype, device=L.device)
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        # sigma > 0 implies a resident row in nearest mode, not under interp.
        contrib = active & (s.sigma > 0.0)
        att = torch.exp(-s.dt * delta_scale * s.sigma)
        if grad is not None:
            _scatter_rows(col, s.rows, s.corners, contrib, (s.dt * delta_scale) * gL)
        L = torch.where(contrib, L * att, L)
        t = torch.where(active, t + s.dt, t)
    if grad is not None:
        grad[:, -1] = col
    return L


def opacity_backward_cuda(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                          dirs: torch.Tensor, grad_out: torch.Tensor, opt: RenderOptions,
                          out_res=None) -> torch.Tensor:
    """Launch the opacity VJP kernel (K9a, `csrc/render_bwd.cu`) into a
    zeroed float32 (M, D) gradient. An empty pool or ray batch returns
    zeros without a launch."""
    args = _aux_args(spec, features, origins, dirs, opt, "opacity_backward_cuda")
    kernel = _kernel_for(spec, opt, _OPACITY_INSTANCES, features)
    _check_alpha_grads(features, origins, grad_out, out_res)
    single = _single_pass(opt, out_res)
    for t in (grad_out, out_res if single else None):
        if t is not None:
            _require(t.is_contiguous() and t.dtype == torch.float32,
                     "grad_out and out_res must be contiguous float32")
    M, D = features.shape
    dev = features.device
    grad = torch.zeros(M, D, dtype=torch.float32, device=dev)
    if M == 0 or origins.shape[0] == 0:
        return grad
    kernel(
        *args, grad_out.data_ptr(), out_res.data_ptr() if single else None,
        grad.data_ptr(), *_stream(dev))
    return grad


# ---------------------------------------------------------------------------
# First-hit passes: depth and motion features
# ---------------------------------------------------------------------------


def first_hit(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
              dirs: torch.Tensor, opt: RenderOptions):
    """March to the first sample with sigma > sigma_thresh in a resident
    leaf.

    :return: (found (B,) bool, t_hit (B,) float32 — the t of the first
        sample over the threshold —, row (B,) int32 and frac (B, 3), the
        in-leaf fraction of the point o + t_hit * d, both 0 where not
        found)
    """
    if origins.is_cuda:
        return first_hit_cuda(spec, features, origins, dirs, opt)
    return first_hit_plain(spec, features, origins, dirs, opt)


def first_hit_plain(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                    dirs: torch.Tensor, opt: RenderOptions):
    """Plain PyTorch version of the first-hit kernel (K9b)."""
    _check(spec, features, origins, dirs, opt)
    B = origins.shape[0]
    M = features.shape[0]
    dev = origins.device
    rays = _ray_setup(spec, origins, dirs, opt)
    o, d, _, _, tmin, tmax, hit = rays
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    found_t = torch.zeros_like(found)
    same = torch.zeros_like(found)
    t_hit = torch.zeros(B, dtype=torch.float32, device=dev)
    row = torch.zeros(B, dtype=torch.int32, device=dev)
    frac = torch.zeros(B, 3, dtype=torch.float32, device=dev)
    t = tmin
    # With an empty pool no sample is resident: nothing is found.
    active = hit.clone() if M > 0 else torch.zeros_like(hit)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        over = active & (s.sigma > opt.sigma_thresh)
        first = over & ~found_t
        t_hit = torch.where(first, t, t_hit)
        found_t = found_t | over
        now = over & s.resident
        found = found | now
        same = torch.where(now, first, same)
        row = torch.where(now, s.idx, row)
        frac = torch.where(now[:, None], s.leaf.frac, frac)
        active = active & ~now
        t = torch.where(active, t + s.dt, t)
        active = active & (t < tmax)
    redo = found & ~same
    if bool(redo.any()):
        # sigma_thresh < 0: t_hit lies before the resident sample.
        frac[redo] = _locate(spec, sample_position(o[redo], t_hit[redo], d[redo])).frac
    return found, t_hit, row, frac


def first_hit_cuda(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                   dirs: torch.Tensor, opt: RenderOptions):
    """Launch the first-hit kernel (K9b, `csrc/render_aux.cu`), which
    writes every element of its four outputs; an empty pool or ray batch
    returns zeros without a launch."""
    args = _aux_args(spec, features, origins, dirs, opt, "first_hit_cuda")
    kernel = _kernel_for(spec, opt, _FIRST_HIT_INSTANCES, features)
    B = origins.shape[0]
    dev = features.device
    alloc = torch.zeros if B == 0 or features.shape[0] == 0 else torch.empty
    found = alloc(B, dtype=torch.bool, device=dev)
    t_hit = alloc(B, dtype=torch.float32, device=dev)
    row = alloc(B, dtype=torch.int32, device=dev)
    frac = alloc(B, 3, dtype=torch.float32, device=dev)
    if alloc is torch.zeros:
        return found, t_hit, row, frac
    kernel(*args, opt.sigma_thresh, found.data_ptr(), t_hit.data_ptr(), row.data_ptr(),
           frac.data_ptr(), *_stream(dev))
    return found, t_hit, row, frac


def render_depth(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                 dirs: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """First-hit depth ``t_hit * delta_scale``, (B, 1); 0 where no hit."""
    found, t_hit, _, _ = first_hit(spec, features, origins, dirs, opt)
    delta_scale = _ray_setup(spec, origins, dirs)[3]
    return torch.where(found, t_hit * delta_scale, 0.0)[:, None]


def motion_render(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                  dirs: torch.Tensor, opt: RenderOptions):
    """First-hit skeleton-distance features.

    ``spec.extra_data`` rows hold joint positions (first 3 columns). With
    ``opt.compat_hit_point`` the hit point is the world transform of the
    in-leaf fraction at the hit, as in the CUDA reference, instead of the
    sample position; on a bake the fraction comes from one more lookup at
    the hit points (`ops/bake.py` `lookup`, the K6 point kernel on CUDA),
    as in the JAX package.

    :return: (motion_feature (B, n_joints), depth (B, 1), hit_point world
        (B, 3), data_idx (B, 1) int32), all 0 where no hit
    """
    if spec.extra_data is None:
        raise ValueError("motion_render needs extra_data joints")
    found, t_hit, row, frac = first_hit(spec, features, origins, dirs, opt)
    o, d, _, delta_scale = _ray_setup(spec, origins, dirs)[:4]
    pos = torch.where(found[:, None], sample_position(o, t_hit, d), 0.0)
    if opt.compat_hit_point:
        if isinstance(spec, BakedTree):
            frac = bake_lookup(spec, pos)[2]
        pos = torch.where(found[:, None], frac, 0.0)
    world = torch.where(found[:, None], tree2world(pos, spec.offset, spec.scaling), 0.0)
    joints = spec.extra_data[:, :3]
    dist = torch.linalg.norm(world[:, None, :] - joints[None, :, :], dim=-1)
    motion = torch.where(found[:, None], dist, 0.0)
    depth = torch.where(found, t_hit * delta_scale, 0.0)[:, None]
    data_idx = torch.where(found, row, 0)[:, None]
    return motion, depth, world, data_idx


# ---------------------------------------------------------------------------
# Volumetric LBS motion-feature rendering
# ---------------------------------------------------------------------------


def motion_feature_render(spec: TreeSpec, joint_features: torch.Tensor,
                          features: torch.Tensor, origins: torch.Tensor,
                          dirs: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """Volumetric LBS-feature render, (B, Kd) float32, differentiable with
    respect to ``joint_features`` (J, Kd; float32 or bf16, whose gradient
    comes back in its type); ``spec.skinning_weights`` and
    ``spec.joint_index`` (M, n_bones) give each pool row its bones. The
    gradient is the JAX package's corrected one: exact for
    ``stop_thresh == 0``; under fast options it ignores early stop, as
    the JAX package's does."""
    return _MotionFeatureFn.apply(spec, joint_features, features, origins, dirs, opt)


class _MotionFeatureFn(torch.autograd.Function):
    """`motion_feature_render` (JAX: its custom_vjp): a gradient for the
    joint features only, none for the pool. The spec and options are
    captured at forward time."""

    @staticmethod
    def forward(ctx, spec, joint_features, features, origins, dirs, opt):
        if origins.is_cuda:
            out = motion_feature_forward_cuda(spec, joint_features, features, origins, dirs, opt)
        else:
            out = motion_feature_render_plain(spec, joint_features, features, origins, dirs, opt)
        # A quantized pool is not a tensor: it is kept on ctx as it is.
        ctx.quantized = features if isinstance(features, QuantizedFeatures) else None
        ctx.save_for_backward(joint_features, origins, dirs,
                              *(() if ctx.quantized is not None else (features,)))
        ctx.spec, ctx.opt = spec, opt
        return out

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None, None, None
        joint_features, origins, dirs, *pool = ctx.saved_tensors
        features = ctx.quantized if ctx.quantized is not None else pool[0]
        grad = motion_feature_backward(ctx.spec, joint_features, features, origins, dirs,
                                       grad_out.contiguous(), ctx.opt)
        return None, grad, None, None, None, None


def _lbs_tables(spec: TreeSpec, joint_features, features):
    """Check the LBS inputs; return (skinning_weights, joint_index)."""
    sw, ji = spec.skinning_weights, spec.joint_index
    if sw is None or ji is None:
        raise ValueError("motion_feature_render needs skinning_weights and joint_index")
    M = features.shape[0]
    if sw.ndim != 2 or tuple(ji.shape) != tuple(sw.shape) or sw.shape[0] < M:
        raise ValueError(f"skinning_weights and joint_index must be (M, n_bones) with M >= "
                         f"{M}, got {tuple(sw.shape)} and {tuple(ji.shape)}")
    if joint_features.ndim != 2 or joint_features.shape[0] < 1:
        raise ValueError(f"joint_features must be (J, Kd), got {tuple(joint_features.shape)}")
    for t in (sw, ji, joint_features):
        if t.device != features.device:
            raise ValueError(f"LBS tables on {t.device}, features on {features.device}")
    return sw, ji


def _float_table(t):
    """A float32 (or float64) copy of a joint table, as the kernels read it."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _blend(sw_r, ji_r, joint_features, ok):
    """LBS blend per sample, (B, Kd): bones in order, weight sw where
    sw > 0 and the sample is ``ok``, else 0."""
    J = joint_features.shape[0]
    joint_features = _float_table(joint_features)
    b = torch.zeros(sw_r.shape[0], joint_features.shape[1], dtype=joint_features.dtype,
                    device=joint_features.device)
    for n in range(sw_r.shape[1]):
        w = torch.where(ok & (sw_r[:, n] > 0), sw_r[:, n], 0.0)
        b = b + w[:, None] * joint_features[ji_r[:, n].clamp(0, J - 1).long()]
    return b


def motion_feature_render_plain(spec: TreeSpec, joint_features: torch.Tensor,
                                features: torch.Tensor, origins: torch.Tensor,
                                dirs: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """Plain PyTorch version of the motion-feature forward kernel (K9c):
    attenuation where sigma > sigma_thresh, contribution where also the
    row is < M, early stop as the main render, misses 0."""
    _check(spec, features, origins, dirs, opt)
    sw, ji = _lbs_tables(spec, joint_features, features)
    B = origins.shape[0]
    M = features.shape[0]
    rays = _ray_setup(spec, origins, dirs, opt, cube_hit=True)
    delta_scale, tmin, tmax, hit = rays[3:]
    can_stop = opt.stop_thresh > 0.0
    out = torch.zeros(B, joint_features.shape[1], dtype=_float_table(joint_features).dtype,
                      device=origins.device)
    L = torch.ones_like(tmin)
    stopped = torch.zeros_like(hit)
    t = tmin
    # With an empty pool no sample attenuates or contributes.
    active = hit.clone() if M > 0 else torch.zeros_like(hit)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        gate = active & (s.sigma > opt.sigma_thresh)
        contrib = gate & s.resident
        att = torch.exp(-s.dt * delta_scale * s.sigma)
        weight = L * (1.0 - att)
        col = _sigmoid(_blend(sw[s.rows], ji[s.rows], joint_features, contrib))
        out = torch.where(contrib[:, None], out + weight[:, None] * col, out)
        L = torch.where(gate, L * att, L)
        if can_stop:
            stop = gate & (L <= opt.stop_thresh)
            out = torch.where(stop[:, None], out * (1.0 / (1.0 - L))[:, None], out)
            stopped = stopped | stop
            active = active & ~stop
        t = torch.where(active, t + s.dt, t)
        active = active & (t < tmax)
    out = torch.where(stopped[:, None], out, out + (L * opt.background_brightness)[:, None])
    return torch.where(hit[:, None], out, 0.0)


def _mf_kernel_args(spec, joint_features, features, origins, dirs, opt, name, backward):
    """Check a motion-feature kernel's inputs, sizes first, and return
    (its arguments up to nb (`_MF_ARGS`), the float32 joint table they
    point at, which the caller keeps alive until the launch). A bf16
    joint table is read as float32, as the JAX package reads it."""
    sw, ji = _lbs_tables(spec, joint_features, features)
    J, Kd = joint_features.shape
    if Kd > KERNEL_MAX_JOINT_DIM:
        raise NotImplementedError(
            f"the motion-feature kernels take at most {KERNEL_MAX_JOINT_DIM} joint-feature "
            f"columns, got {Kd}"
        )
    if backward and J * (Kd | 1) > KERNEL_MAX_JOINT_TABLE:
        raise NotImplementedError(
            f"the motion-feature backward kernel holds at most {KERNEL_MAX_JOINT_TABLE} "
            f"joint-table floats (48 KB of shared memory), got J * (Kd | 1) = {J * (Kd | 1)}"
        )
    args = _aux_args(spec, features, origins, dirs, opt, name)
    for t in (sw, ji, joint_features):
        _require(t.is_cuda, f"{name} needs CUDA LBS tables")
    for t in (sw, ji):
        _require(t.is_contiguous(), f"{name} needs contiguous LBS tables")
    _require(joint_features.is_floating_point(), "joint_features must be a float table")
    _require(sw.dtype == torch.float32, "skinning_weights must be float32")
    _require(ji.dtype == torch.int32, "joint_index must be int32")
    jf = joint_features.detach().to(torch.float32).contiguous()
    return args + (jf.data_ptr(), J, Kd, sw.data_ptr(), ji.data_ptr(), sw.shape[1]), jf


def mf_width(J: int, Kd: int, nb: int, backward: bool, ptrs) -> int:
    """The vector width of a K9c launch (K9d's with ``backward``): 4, the
    instance that reads a contributing sample's skinning row in one float4
    and its joint-index row in one int4 load, the joint table from a copy
    in shared memory in float4s and the output (K9d: grad_out) row in
    float4s, where nb is 4, Kd a multiple of 4, every pointer of ``ptrs``
    (the skinning weights, the joint indices, and K9c's output or K9d's
    grad_out) 16-byte aligned and the shared tables fit in
    `KERNEL_MF_VECTOR_SMEM`; else 1, the scalar reads."""
    jf_bytes = J * 4 * (((Kd + 3) // 4) | 1) * 4
    table_bytes = (J * (Kd | 1) + 3) // 4 * 16 if backward else 0
    vec = (nb == 4 and Kd % 4 == 0 and all(p % 16 == 0 for p in ptrs)
           and table_bytes + jf_bytes <= KERNEL_MF_VECTOR_SMEM)
    return 4 if vec else 1


def _mf_launch_width(args, backward: bool, row_ptr: int, width) -> int:
    """The width of a motion-feature launch on ``args`` (`_mf_kernel_args`)
    and its output (K9d: grad_out) row pointer: `mf_width`'s, or ``width``
    where the caller forces one; 4 where the launch does not allow it
    raises."""
    J, Kd, sw_ptr, ji_ptr, nb = args[-5:]
    rule = mf_width(J, Kd, nb, backward, (sw_ptr, ji_ptr, row_ptr))
    if width is None:
        return rule
    if type(width) is not int or width not in (1, 4):
        raise ValueError(f"the motion-feature kernels' width must be 1 or 4, got {width!r}")
    if width == 4 and rule != 4:
        raise ValueError("width 4 takes 4 bones, Kd a multiple of 4, LBS tables and the output (grad_out) "
                         f"aligned to 16 bytes and at most {KERNEL_MF_VECTOR_SMEM} bytes of shared tables")
    return width


def motion_feature_forward_cuda(spec: TreeSpec, joint_features: torch.Tensor,
                                features: torch.Tensor, origins: torch.Tensor,
                                dirs: torch.Tensor, opt: RenderOptions, width=None) -> torch.Tensor:
    """Launch the motion-feature forward kernel (K9c, `csrc/render_aux.cu`)
    at `mf_width`'s width; ``width`` (1 or 4) forces one, and 4 where the
    launch does not allow it raises (a comparison of the instances passes
    it)."""
    args, _jf = _mf_kernel_args(spec, joint_features, features, origins, dirs, opt,
                                "motion_feature_forward_cuda", backward=False)
    kernel = _kernel_for(spec, opt, _MF_FWD_INSTANCES, features)
    dev = features.device
    out = torch.empty(origins.shape[0], joint_features.shape[1], dtype=torch.float32, device=dev)
    width = _mf_launch_width(args, False, out.data_ptr(), width)
    if out.shape[0] == 0:
        return out
    kernel(*args, opt.sigma_thresh, opt.stop_thresh, opt.background_brightness, out.data_ptr(),
           width, *_stream(dev))
    MF_FWD_WIDTH_LAUNCHES[width] += 1
    return out


def motion_feature_backward(spec: TreeSpec, joint_features: torch.Tensor,
                            features: torch.Tensor, origins: torch.Tensor,
                            dirs: torch.Tensor, grad_out: torch.Tensor,
                            opt: RenderOptions) -> torch.Tensor:
    """Gradient of `motion_feature_render` with respect to the joint
    features, (J, Kd) in their type (summed in float32 on the card, in
    float64 in the plain version, and cast once)."""
    march = motion_feature_backward_cuda if origins.is_cuda else motion_feature_backward_plain
    return march(spec, joint_features, features, origins, dirs, grad_out,
                 opt).to(joint_features.dtype)


def _check_mf_grad(joint_features, origins, grad_out) -> None:
    want = (origins.shape[0], joint_features.shape[1])
    if tuple(grad_out.shape) != want:
        raise ValueError(f"grad_out must be {want}, got {tuple(grad_out.shape)}")
    if grad_out.device != origins.device:
        raise ValueError(f"grad_out on {grad_out.device}, rays on {origins.device}")


def motion_feature_backward_plain(spec: TreeSpec, joint_features: torch.Tensor,
                                  features: torch.Tensor, origins: torch.Tensor,
                                  dirs: torch.Tensor, grad_out: torch.Tensor,
                                  opt: RenderOptions) -> torch.Tensor:
    """Plain PyTorch version of the motion-feature VJP kernel (K9d): the
    backward's rules (samples while ``t < tmax``, attenuation where
    ``sigma > 0``, no early stop); per contributing sample (also a row
    < M, which under interp is not implied) and bone with ``sw > 0`` it
    adds ``sw * ((weight * s) * (1 - s)) * g`` into the bone's joint row.

    Every joint entry sums the terms of many rays and samples (~10^5 on
    an 800x800 image), so the terms, computed as the kernel computes
    them, are summed in float64: this version is then the exact sum the
    kernel's float32 atomics approximate. It comes back in float32 (float64
    for a float64 table); `motion_feature_backward` casts it to the joint
    table's type."""
    _check(spec, features, origins, dirs, opt)
    sw, ji = _lbs_tables(spec, joint_features, features)
    _check_mf_grad(joint_features, origins, grad_out)
    J = joint_features.shape[0]
    grad = torch.zeros_like(joint_features, dtype=torch.float64)
    out_dtype = _float_table(joint_features).dtype
    if features.shape[0] == 0 or origins.shape[0] == 0:
        return grad.to(out_dtype)
    rays = _ray_setup(spec, origins, dirs, opt, cube_hit=True)
    delta_scale, tmin, tmax, hit = rays[3:]
    t = tmin
    L = torch.ones_like(tmin)
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        gate = active & (s.sigma > 0.0)
        contrib = gate & s.resident
        att = torch.exp(-s.dt * delta_scale * s.sigma)
        weight = L * (1.0 - att)
        sw_r, ji_r = sw[s.rows], ji[s.rows]
        col = _sigmoid(_blend(sw_r, ji_r, joint_features, contrib))
        gb = ((weight[:, None] * col) * (1.0 - col)) * grad_out
        for n in range(sw.shape[1]):
            ok = contrib & (sw_r[:, n] > 0)
            grad.index_add_(0, ji_r[ok, n].clamp(0, J - 1).long(),
                            (sw_r[ok, n, None] * gb[ok]).double())
        L = torch.where(gate, L * att, L)
        t = torch.where(active, t + s.dt, t)
    return grad.to(out_dtype)


def motion_feature_backward_cuda(spec: TreeSpec, joint_features: torch.Tensor,
                                 features: torch.Tensor, origins: torch.Tensor,
                                 dirs: torch.Tensor, grad_out: torch.Tensor,
                                 opt: RenderOptions, width=None) -> torch.Tensor:
    """Launch the motion-feature VJP kernel (K9d, `csrc/render_aux.cu`)
    into a zeroed float32 (J, Kd) gradient. Each block sums its rays into
    a copy of the joint table in shared memory, so J * (Kd | 1) is at most
    `KERNEL_MAX_JOINT_TABLE`. The width is `mf_width`'s, or ``width`` as in
    `motion_feature_forward_cuda`."""
    args, _jf = _mf_kernel_args(spec, joint_features, features, origins, dirs, opt,
                                "motion_feature_backward_cuda", backward=True)
    kernel = _kernel_for(spec, opt, _MF_BWD_INSTANCES, features)
    _check_mf_grad(joint_features, origins, grad_out)
    J, Kd = joint_features.shape
    _require(grad_out.is_contiguous() and grad_out.dtype == torch.float32,
             "grad_out must be contiguous float32")
    dev = features.device
    width = _mf_launch_width(args, True, grad_out.data_ptr(), width)
    grad = torch.zeros(J, Kd, dtype=torch.float32, device=dev)
    if features.shape[0] == 0 or origins.shape[0] == 0:
        return grad
    kernel(*args, grad_out.data_ptr(), grad.data_ptr(), width, *_stream(dev))
    MF_BWD_WIDTH_LAUNCHES[width] += 1
    return grad
