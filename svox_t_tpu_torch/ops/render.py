"""Volume rendering over the sparse voxel octree, forward and backward:
the counterpart of `svox_t_tpu/ops/render.py`.

`volume_render` and `volume_render_with_weight_accum` are differentiable
with respect to the feature pool (`torch.autograd.Function`s, the
counterparts of the JAX package's two `custom_vjp`s). Every op dispatches
on the device of its tensors: on CUDA it launches its kernel
(`csrc/render_fwd.cu`, `csrc/render_bwd.cu`) or raises; on the CPU it
runs its plain PyTorch version, a step loop vectorized over rays that the
kernel follows operation for operation. The march semantics are the JAX
package's, sample for sample:

  * ray setup: ``o = world2tree(origins)``, unit tree-space dirs and
    ``delta_scale`` (`get_delta_scale`), ``invdir = 1/(d + 1e-9)``, unit
    cube DDA; a ray hits unless ``tmax < 0`` or ``tmin > tmax``;
  * forward: a hit ray takes its first sample at ``tmin`` (even if
    tmin == tmax), then ``t += delta_t`` and stays active while
    ``t < tmax``, for at most ``max_steps`` samples; a sample lies at
    ``o + t * d`` rounded once (`sample_position`);
  * ``delta_t = (sub_tmax - sub_tmin) / cube_sz + step_size`` from the
    in-leaf DDA; rows >= M are empty space (sigma 0);
  * a forward sample composites only if ``sigma > sigma_thresh``:
    ``att = exp(-dt * delta_scale * sigma)``, ``weight = L * (1 - att)``;
    with weight accumulation, that weight is added to the sample's leaf
    cell;
  * colors are ``sigmoid(feat[:n_color])`` (RGBA) or
    ``sigmoid(sum_k basis_k * feat[c * basis_dim + k])`` with the SH, SG
    or ASG basis from the view direction, windowed to
    [min_comp, max_comp], rotated per voxel by
    ``transformation_matrices[row][:3, :3]`` when given;
  * early stop (``stop_thresh > 0``): the sample that brings L to or
    below the threshold counts, then colors scale by ``1/(1 - L)`` and
    no background is added;
  * a missed ray is background with alpha 0; any other ray gets
    ``out + L * bg`` and alpha ``1 - L``;
  * the backward marches under its own rules (see
    `volume_render_backward_plain`): samples while ``t < tmax``, a
    sample contributes where ``sigma > 0`` whatever ``sigma_thresh`` is,
    no early stop; one pass in exact mode with the forward output, two
    passes otherwise.

Each march walks either structure: a `TreeSpec` (the root-to-leaf
descent) or a `BakedTree` (the baked lookup, `ops/bake.py`), the default
of `VolumeRenderer`. On a bake the ray setup also culls against the
occupied box (``hit`` tightened, ``tmax`` clamped to the box exit: exact),
fast options move ``tmin`` to the box entry (``box_advance``) and cross
skip boxes in one step (``skip_boxes``, `effective_skip_base`), and
weights add into the tree cell ``src_map[cell]``. In exact mode the two
structures give the same samples, so the same outputs bit for bit. The
kernels take the structure as a template parameter (`csrc/common.cuh`
``TreeWalk`` / ``Baked``); the baked instances are their own entry points
(``RENDER_FWD_BAKED``, ``RENDER_BWD_BAKED``).

Trilinear interpolation (``opt.interp``, K4; JAX `_interp_corners`,
`_gather_interp`): a sample's sigma and colors come from the 8 cells
around it on its own leaf's grid (`interp_corners`), also where its own
leaf is empty; every active sample is valid, and its own row (0 where it
is empty) only picks its rotation. The corners' colors are summed as
``sum_c w_c * (basis . row_c)`` per color (`_interp`), the order of the
kernels, which hold no interpolated row; the gradients go to the
corners' rows, weighted. The bake's box is not used at all (no cull, no
clamp, no box advance) and skip boxes are off. The interp kernels are
their own instances (``RENDER_FWD_INTERP``, ``RENDER_FWD_BAKED_INTERP``,
...; `csrc/render_*_interp.cu`).

Feature pools (K5; JAX `_gather_features`, `QuantizedFeatures`): a pool is
a float32 or bfloat16 (M, D) tensor, or a `QuantizedFeatures` (int8 rows
with per-channel float32 ``scale`` and ``zero``, `quantize_features`).
Every march reads the pool in its own type and turns each row it gathers
into float32 right after the gather (`gather_rows`: a bf16 value exactly,
an int8 one as ``float(q) * scale[c] + zero[c]``, a multiply and an add,
each rounded); sigma, colors, compositing and gradients are then float32
arithmetic, whatever the pool. The backward sums a bf16 pool's gradient
in a float32 (M, D) buffer and casts it once at the end; a quantized pool
takes no gradient (JAX: a zero cotangent). Each pool type has its own
kernel instances (``RENDER_FWD_BF16``, ``RENDER_FWD_I8``, ...;
`_build.POOL_INSTANCES`), and a type without one raises on CUDA.

The JAX package forms L as a per-round cumulative product and scatters
gradients deterministically, while this port multiplies per sample and
the kernels add gradients with float atomics, so the two agree to a few
ulps, not bit for bit.
"""

from __future__ import annotations

import ctypes
from ctypes import c_float, c_int, c_void_p
from typing import NamedTuple

import numpy as np
import torch

from .._build import Kernel
from ..utils.spec import (FORMAT_ASG, FORMAT_RGBA, FORMAT_SG, FORMAT_SH,
                          RenderOptions, TreeSpec, get_out_data_dim)
from .bake import (_SKIP_BITS_SPAN, BakedTree, StructureDesc, _check_baked, check_structure,
                   lookup_plain, structure_desc)
from .sh import SH_DIM_TO_DEG, eval_basis
from .traversal import LeafInfo, dda_unit, descend, get_delta_scale, world2tree

# Arguments the two march kernels share, in order.
_MARCH_ARGS = [
    ctypes.POINTER(StructureDesc),                  # tree or bake
    c_void_p, c_void_p, c_void_p, c_int,            # origins, dirs, vdirs, B
    c_void_p, c_void_p,                             # offset, scaling
    c_void_p, c_void_p, c_void_p, c_int, c_int,     # features, scale, zero, M, D
    c_void_p, c_int, c_void_p, c_int,               # tmats, format, extra, ld_extra
    c_int, c_int, c_int, c_int,                     # basis_dim, min/max_comp, n_color
    c_float, c_float,                               # step, bg
]
_FWD_ARGS = _MARCH_ARGS + [c_float, c_float, c_int,  # sigma/stop thresh, max_steps
                           c_void_p, c_void_p,      # out, waccum
                           c_int, c_int, c_void_p]  # width, device, stream
_BWD_ARGS = _MARCH_ARGS + [c_int,                   # max_steps
                           c_void_p, c_void_p, c_void_p,  # grad_out, out_res, grad
                           c_int, c_int, c_void_p]  # width, device, stream
# The entry-point suffixes of a march kernel's instances: the structure and
# interpolation (in `_kernel_for`'s order: tree walk, bake, tree walk
# interp, bake interp), then the pool type (K5).
_STRUCT_SUFFIXES = ("", "_baked", "_interp", "_baked_interp")
POOL_SUFFIX = {"f32": "", "bf16": "_bf16", "i8": "_i8"}


def march_instances(base: str, args, pools) -> dict:
    """{pool type: (tree, bake, tree interp, bake interp) kernels} of the
    entry point ``svox_<base>``, for the pool types it has instances of."""
    return {pool: tuple(Kernel(f"svox_{base}{s}{POOL_SUFFIX[pool]}", args) for s in _STRUCT_SUFFIXES)
            for pool in pools}


# K2 has float32, bf16 and int8 instances; K3 float32 and bf16 (a
# quantized pool takes no gradient).
_FWD_INSTANCES = march_instances("render_fwd", _FWD_ARGS, ("f32", "bf16", "i8"))
_BWD_INSTANCES = march_instances("render_bwd", _BWD_ARGS, ("f32", "bf16"))
RENDER_FWD, RENDER_FWD_BAKED, RENDER_FWD_INTERP, RENDER_FWD_BAKED_INTERP = _FWD_INSTANCES["f32"]
(RENDER_FWD_BF16, RENDER_FWD_BAKED_BF16, RENDER_FWD_INTERP_BF16,
 RENDER_FWD_BAKED_INTERP_BF16) = _FWD_INSTANCES["bf16"]
(RENDER_FWD_I8, RENDER_FWD_BAKED_I8, RENDER_FWD_INTERP_I8,
 RENDER_FWD_BAKED_INTERP_I8) = _FWD_INSTANCES["i8"]
RENDER_BWD, RENDER_BWD_BAKED, RENDER_BWD_INTERP, RENDER_BWD_BAKED_INTERP = _BWD_INSTANCES["f32"]
(RENDER_BWD_BF16, RENDER_BWD_BAKED_BF16, RENDER_BWD_INTERP_BF16,
 RENDER_BWD_BAKED_INTERP_BF16) = _BWD_INSTANCES["bf16"]
# K2's launches by the vector width in which a sample's row (nearest) or
# its corners' rows (interp) move (`render_fwd_width`), beside their counts,
# every structure and pool type.
FWD_WIDTH_LAUNCHES = {1: 0, 4: 0}
# The same for K3 and K3+K4, the backward march (the same rule; the tape
# backward's are `ops.tape.BWD_WIDTH_LAUNCHES`).
MARCH_BWD_WIDTH_LAUNCHES = {1: 0, 4: 0}
# Color channels the kernels hold in registers, and the largest basis.
KERNEL_MAX_COLORS = 16
KERNEL_MAX_BASIS = 25
# Columns of an extra_data row that SG and ASG read.
_EXTRA_WIDTH = {FORMAT_SG: 4, FORMAT_ASG: 11}


def _basis_window(opt: RenderOptions) -> np.ndarray:
    """0/1 mask over basis components [min_comp, max_comp]."""
    idx = np.arange(opt.basis_dim)
    return ((idx >= opt.min_comp) & (idx <= opt.max_comp)).astype(np.float32)


class QuantizedFeatures(NamedTuple):
    """An int8 affine-quantized feature pool (JAX `QuantizedFeatures`):
    row r's column c is ``float(q[r, c]) * scale[c] + zero[c]``, formed
    in float32 after each gather (a multiply and an add, each rounded).
    Renders take it where they take a pool; it takes no gradient."""

    q: torch.Tensor      # (M, D) int8
    scale: torch.Tensor  # (D,) float32
    zero: torch.Tensor   # (D,) float32

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def to(self, device) -> "QuantizedFeatures":
        return QuantizedFeatures(*(t.to(device) for t in self))

    def dequantize(self) -> torch.Tensor:
        """The (M, D) float32 pool the marches read, row for row."""
        return self.q.to(torch.float32) * self.scale + self.zero


def quantize_features(features, bits: int = 8) -> QuantizedFeatures:
    """Per-channel affine int8 quantization of an (M, D) pool (JAX
    `quantize_features`): ``scale = max(hi - lo, 1e-12) / 254``, ``zero =
    (lo + hi) / 2``, ``q = clip(round((f - zero) / scale), -127, 127)``
    with round-half-even, lo and hi the channel's min and max. An empty
    pool gets scale 1 and zero 0. The divisions are true divisions (by a
    tensor: on CUDA PyTorch divides by a Python scalar through its
    reciprocal)."""
    if bits != 8:
        raise ValueError("int8 is the supported quantized pool width")
    features = torch.as_tensor(features).to(torch.float32)
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    M, D = features.shape
    dev = features.device
    if M == 0:
        return QuantizedFeatures(torch.zeros((0, D), dtype=torch.int8, device=dev),
                                 torch.ones(D, device=dev), torch.zeros(D, device=dev))
    lo = features.amin(dim=0)
    hi = features.amax(dim=0)
    scale = torch.clamp(hi - lo, min=1e-12) / torch.full_like(lo, 254.0)
    zero = (lo + hi) * 0.5
    q = torch.clamp(torch.round((features - zero) / scale), -127, 127).to(torch.int8)
    return QuantizedFeatures(q, scale, zero)


def pool_kind(features) -> str:
    """The pool type's key in the kernel instance tables: "f32", "bf16",
    "i8" (a `QuantizedFeatures`), else the dtype's name."""
    if isinstance(features, QuantizedFeatures):
        return "i8"
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(
        features.dtype, str(features.dtype).replace("torch.", ""))


def pool_dtype(features) -> torch.dtype:
    """The float type a gathered row comes back in: float32, or float64
    for a float64 pool."""
    if isinstance(features, QuantizedFeatures):
        return torch.float32
    return torch.promote_types(features.dtype, torch.float32)


def gather_rows(features, rows, col=None):
    """K5's plain version (JAX `_gather_features`): the pool's rows
    ``rows`` (each < M), or their column ``col``, in `pool_dtype`, turned
    into that type right after the gather as the kernels do (a bf16 value
    exactly; an int8 one dequantized)."""
    if isinstance(features, QuantizedFeatures):
        if col is None:
            return features.q[rows].to(torch.float32) * features.scale + features.zero
        return features.q[rows, col].to(torch.float32) * features.scale[col] + features.zero[col]
    x = features[rows] if col is None else features[rows, col]
    return x.to(pool_dtype(features))


def _ray_setup(spec, origins, dirs, opt: RenderOptions = None, cube_hit: bool = False):
    """Rays to tree space: (o, d, invdir, delta_scale, tmin, tmax, hit).

    With ``opt`` and a baked spec, the rays are culled against the bake's
    occupied box: ``hit`` requires the box (a miss renders exactly the
    background, and an inverted box, lo > hi, culls every ray), ``tmax``
    stops at the box exit (samples beyond it are empty), and with
    ``box_advance`` ``tmin`` moves to the box entry (fast mode only: it
    shifts the samples). ``cube_hit`` keeps ``hit`` the cube test and
    clamps only (the motion-feature passes output 0 for a cube miss but
    the background for a hit that finds nothing). Under ``opt.interp``
    the box is not used at all: corner cells bleed sigma up to half a
    cell outside it (JAX `_clip_to_occupied`)."""
    o = world2tree(origins, spec.offset, spec.scaling)
    d, delta_scale = get_delta_scale(spec.scaling, dirs)
    invdir = 1.0 / (d + 1e-9)
    tmin, tmax = dda_unit(o, invdir)
    hit = ~((tmax < 0) | (tmin > tmax))
    if opt is not None and isinstance(spec, BakedTree) and not opt.interp:
        lo, hi = spec.aabb_lo, spec.aabb_hi
        t1 = (lo - o) * invdir
        t2 = (hi - o) * invdir
        a_lo = torch.minimum(t1, t2).amax(dim=-1)
        a_hi = torch.maximum(t1, t2).amin(dim=-1)
        if not cube_hit:
            box_valid = bool((lo <= hi).all())
            hit = hit & box_valid & (a_hi >= torch.clamp(a_lo, min=0.0)) & (a_hi >= tmin)
        if opt.box_advance:
            tmin = torch.maximum(tmin, a_lo)
        tmax = torch.minimum(tmax, a_hi)
    return o, d, invdir, delta_scale, tmin, tmax, hit


def effective_skip_base(spec, opt: RenderOptions) -> int:
    """The skip-box code base the march honors: the bake's, in fast mode
    (``opt.skip_boxes``) without interpolation; else 0."""
    if opt.skip_boxes and not opt.interp:
        return int(getattr(spec, "skip_base", 0) or 0)
    return 0


def _locate(spec, pos) -> LeafInfo:
    """The leaves of (B, 3) tree-space points in either structure; a
    bake's ``node_flat`` is its baked cell."""
    if isinstance(spec, BakedTree):
        data_idx, cube_sz, frac, cell = lookup_plain(spec, pos)
        return LeafInfo(data_idx=data_idx, node_flat=cell, cube_sz=cube_sz, frac=frac)
    return descend(spec, pos)


def _tree_cells(spec, cells):
    """Tree cells of the cells `_locate` returns (weight accumulation)."""
    return spec.src_map[cells.long()] if isinstance(spec, BakedTree) else cells


def _n_tree_cells(spec) -> int:
    return spec.n_tree_cells if isinstance(spec, BakedTree) else spec.child_flat.numel()


def _step(leaf: LeafInfo, invdir, step_size: float, skip_base: int):
    """Leaf-adaptive step ``(sub_tmax - sub_tmin) / cube_sz + step_size``
    from the in-leaf DDA. With ``skip_base``, an empty leaf whose row is a
    skip-box code exits its box instead of the cell; written so that
    extent 0 is the plain cell DDA bit for bit."""
    if skip_base:
        bits = leaf.data_idx - skip_base
        bz = torch.where((bits >= 0) & (bits < _SKIP_BITS_SPAN), bits, 0)

        def ext(shifts):
            return torch.stack([(bz >> k) & 15 for k in shifts], dim=-1).to(invdir.dtype)

        el, eh = ext((0, 8, 16)), ext((4, 12, 20))
        t1 = -(leaf.frac + el) * invdir
        t2 = t1 + ((1.0 + eh) + el) * invdir
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        sub_tmin = torch.clamp(torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2]), min=0.0)
        sub_tmax = torch.clamp(torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2]), max=1e9)
    else:
        sub_tmin, sub_tmax = dda_unit(leaf.frac, invdir)
    return (sub_tmax - sub_tmin) / leaf.cube_sz + step_size


def sample_position(o, t, d):
    """``o + t * d`` with one rounding, as a fused multiply-add (the
    kernels' ``__fmaf_rn``, and what XLA and nvcc's default contraction
    compute for the JAX package and the CUDA reference): the float32
    product is exact in float64, so only the sum rounds (twice, which
    differs from one rounding with probability ~2^-29)."""
    return (o.double() + t.double()[:, None] * d.double()).to(o.dtype)


def _sample_leaf(spec, opt: RenderOptions, rays, t):
    """The leaf and step of every ray's sample at t (plain)."""
    o, d, invdir = rays[:3]
    leaf = _locate(spec, sample_position(o, t, d))
    return leaf, _step(leaf, invdir, opt.step_size, effective_skip_base(spec, opt))


def interp_corners(spec, pos, cube_sz):
    """K4's corners (JAX `_interp_corners`): the 8 cells around (B, 3)
    tree-space samples on their own leaves' grid, each leaf a point
    sample at its cell centre. ``g = pos * cube_sz - 0.5``, ``b =
    floor(g)``, corner (i, j, k) at ``(b + (i + 0.5)) * (1 / cube_sz)``
    per axis (the lookup clamps it: clamp to the edge), weight ``(fx *
    fy) * fz`` with ``f = w`` or ``1 - w``, ``w = g - b``.

    :return: (rows (8, B) int32 of the corners' leaves, weights (8, B)),
        corners in (i, j, k) order, k fastest
    """
    points, weights = corner_points(pos, cube_sz)
    return torch.stack([_locate(spec, p).data_idx for p in points]), weights


def corner_points(pos, cube_sz):
    """The 8 corner points (8, B, 3), unclamped, and weights (8, B) of
    `interp_corners`."""
    g = pos * cube_sz[:, None] - 0.5
    b = torch.floor(g)
    w = g - b
    inv = 1.0 / cube_sz
    points, weights = [], []
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                ijk = (i, j, k)
                points.append(torch.stack([(b[:, a] + (n + 0.5)) * inv for a, n in enumerate(ijk)], -1))
                f = [w[:, a] if n else 1.0 - w[:, a] for a, n in enumerate(ijk)]
                weights.append((f[0] * f[1]) * f[2])
    return torch.stack(points), torch.stack(weights)


class Corners(NamedTuple):
    """A sample's 8 corners against a pool of M rows."""

    rows: torch.Tensor  # (8, B) int64 rows, 0 where ok is False
    ok: torch.Tensor    # (8, B) bool: the corner's row is < M
    w: torch.Tensor     # (8, B) trilinear weights


def _corners(spec, rays, t, leaf: LeafInfo, M: int) -> Corners:
    """The corners of every ray's sample at t, in the leaf `_sample_leaf`
    found there (plain)."""
    o, d = rays[:2]
    rows, w = interp_corners(spec, sample_position(o, t, d), leaf.cube_sz)
    ok = (rows >= 0) & (rows < M)
    return Corners(torch.where(ok, rows, 0).long(), ok, w)


def _interp(c: Corners, values):
    """``sum_c w_c * values(row_c)`` over the corners whose row is < M,
    in corner order from 0, as the kernels sum (JAX `_gather_interp`
    interpolates the row first; the sums are linear in it, so the two
    agree to rounding). ``values`` maps (B,) rows to (B,) or (B, n)."""
    s = 0.0
    for n in range(8):
        v = values(c.rows[n])
        wv = (c.w[n][:, None] if v.ndim == 2 else c.w[n]) * v
        ok = c.ok[n][:, None] if v.ndim == 2 else c.ok[n]
        s = s + torch.where(ok, wv, 0.0)
    return s


def _check_quantized(features: QuantizedFeatures) -> None:
    q, scale, zero = features
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(f"a quantized pool's q must be (M, D) int8, got {tuple(q.shape)} {q.dtype}")
    for name, t in (("scale", scale), ("zero", zero)):
        if t.dtype != torch.float32 or tuple(t.shape) != (q.shape[1],) or t.device != q.device:
            raise ValueError(f"a quantized pool's {name} must be ({q.shape[1]},) float32 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_supported(spec, features, origins, dirs, vdirs,
                     opt: RenderOptions) -> None:
    if isinstance(features, QuantizedFeatures):
        _check_quantized(features)
    if opt.pool_axis is not None or opt.ray_axis is not None:
        raise NotImplementedError(
            "sharded rendering waits for ROADMAP.md §1 item 17"
        )
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    for name, r in (("origins", origins), ("dirs", dirs), ("vdirs", vdirs)):
        if r.ndim != 2 or r.shape[1] != 3 or r.shape[0] != origins.shape[0]:
            raise ValueError(f"{name} must be (B, 3), got {tuple(r.shape)}")
    devices = {t.device for t in (features, origins, dirs, vdirs)} | {spec.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    if isinstance(spec, BakedTree):
        _check_baked(spec)
        if spec.skip_base and features.shape[0] > spec.skip_base:
            raise ValueError(
                f"feature pool has {features.shape[0]} rows but the baked tree packs "
                f"skip boxes above row {spec.skip_base}; bake with skip_boxes=False"
            )


def _check_ray_grads(features, opt: RenderOptions, origins, grad_out, out_res):
    n_out = get_out_data_dim(opt.format, opt.basis_dim, features.shape[1])
    for name, g in (("grad_out", grad_out), ("out_res", out_res)):
        if g is not None and tuple(g.shape) != (origins.shape[0], n_out):
            raise ValueError(f"{name} must be (B, {n_out}), got {tuple(g.shape)}")
        if g is not None and g.device != features.device:
            raise ValueError(f"{name} on {g.device}, features on {features.device}")


def volume_render(spec: TreeSpec, features: torch.Tensor, origins: torch.Tensor,
                  dirs: torch.Tensor, vdirs: torch.Tensor,
                  opt: RenderOptions) -> torch.Tensor:
    """Per-ray volume render, differentiable with respect to ``features``.

    :return: (B, n_color + 1) colors + alpha.
    """
    return _VolumeRenderFn.apply(spec, features, origins, dirs, vdirs, opt)


def volume_render_with_weight_accum(spec: TreeSpec, features: torch.Tensor,
                                    origins: torch.Tensor, dirs: torch.Tensor,
                                    vdirs: torch.Tensor, opt: RenderOptions):
    """Render that also returns the summed compositing weight of every
    leaf cell. Differentiable with respect to ``features`` through the
    colors; the weights carry no gradient.

    :return: (out (B, n_color + 1), waccum (capacity * N^3,) float32)
    """
    return _VolumeRenderWeightsFn.apply(spec, features, origins, dirs, vdirs, opt)


def volume_render_backward(spec: TreeSpec, features: torch.Tensor,
                           origins: torch.Tensor, dirs: torch.Tensor,
                           vdirs: torch.Tensor, grad_out: torch.Tensor,
                           opt: RenderOptions, out_res=None) -> torch.Tensor:
    """Gradient of a render with respect to the feature pool, (M, D), in
    the pool's type: summed in float32 (`pool_dtype`) and cast once.

    With ``out_res`` (the forward output) and exact options
    (``sigma_thresh == 0``, ``stop_thresh <= 0``) the backward takes one
    pass; otherwise two. A quantized pool takes no gradient.
    """
    if isinstance(features, QuantizedFeatures):
        raise TypeError("a quantized feature pool takes no gradient")
    march = volume_render_backward_cuda if origins.is_cuda else volume_render_backward_plain
    return march(spec, features, origins, dirs, vdirs, grad_out, opt, out_res).to(features.dtype)


def _render(spec, features, origins, dirs, vdirs, opt, want_weights):
    if origins.is_cuda:
        return _march_cuda(spec, features, origins, dirs, vdirs, opt, want_weights)
    return _march_plain(spec, features, origins, dirs, vdirs, opt, want_weights)


def _save(ctx, spec, features, opt, *tensors) -> None:
    """Keep what a render Function's backward reads. A quantized pool
    (not a tensor) takes no gradient, and nothing is kept for it."""
    ctx.spec, ctx.opt = spec, opt
    if not isinstance(features, QuantizedFeatures):
        ctx.save_for_backward(features, *tensors)


def _grad_features(ctx, grad_out):
    """Backward of both render Functions: the feature-pool gradient
    under the spec and options captured at forward time."""
    if not ctx.needs_input_grad[1]:
        return None
    features, origins, dirs, vdirs, out = ctx.saved_tensors
    return volume_render_backward(ctx.spec, features, origins, dirs, vdirs,
                                  grad_out.contiguous(), ctx.opt, out_res=out)


class _VolumeRenderFn(torch.autograd.Function):
    """`volume_render` with its backward march (JAX: `volume_render`'s
    custom_vjp). The spec, rays and options get no gradient."""

    @staticmethod
    def forward(ctx, spec, features, origins, dirs, vdirs, opt):
        out, _ = _render(spec, features, origins, dirs, vdirs, opt, False)
        _save(ctx, spec, features, opt, origins, dirs, vdirs, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return None, _grad_features(ctx, grad_out), None, None, None, None


class _VolumeRenderWeightsFn(torch.autograd.Function):
    """`volume_render_with_weight_accum` (JAX: its custom_vjp): the
    weights are not differentiable."""

    @staticmethod
    def forward(ctx, spec, features, origins, dirs, vdirs, opt):
        out, waccum = _render(spec, features, origins, dirs, vdirs, opt, True)
        ctx.mark_non_differentiable(waccum)
        _save(ctx, spec, features, opt, origins, dirs, vdirs, out)
        return out, waccum

    @staticmethod
    def backward(ctx, grad_out, grad_waccum):
        del grad_waccum
        return None, _grad_features(ctx, grad_out), None, None, None, None


def _sigmoid(x):
    # Written out as the kernel writes it.
    return 1.0 / (1.0 + torch.exp(-x))


def _sum_cols(x):
    """Row sums over the last axis, column by column, as the kernels sum."""
    s = x[:, 0]
    for c in range(1, x.shape[1]):
        s = s + x[:, c]
    return s


def _logits(feat, basis, opt: RenderOptions, n_color: int):
    """Pre-sigmoid colors per row, (B, n_color); basis sums run over k in
    order, as in the kernel."""
    if opt.format == FORMAT_RGBA:
        return feat[:, :n_color]
    bd = opt.basis_dim
    coeffs = feat[:, : n_color * bd].reshape(feat.shape[0], n_color, bd)
    s = basis[:, None, 0] * coeffs[:, :, 0]
    for k in range(1, bd):
        s = s + basis[:, None, k] * coeffs[:, :, k]
    return s


def _sample_colors(features, rows, corners, basis, opt: RenderOptions, n_color: int):
    """Sigmoid colors of each ray's sample, (B, n_color): of its row, or
    under interp of the corners' weighted pre-sigmoid sums (`_interp`);
    every row in `pool_dtype` before any arithmetic (`gather_rows`)."""
    if corners is None:
        return _sigmoid(_logits(gather_rows(features, rows), basis, opt, n_color))
    return _sigmoid(_interp(corners, lambda r: _logits(gather_rows(features, r), basis, opt,
                                                       n_color)))


def _rotated_basis(spec: TreeSpec, opt: RenderOptions, vdirs, rows, window):
    """Basis at view directions rotated by each sample's matrix."""
    m = spec.transformation_matrices[rows]
    rd = torch.stack(
        [(m[:, i, 0] * vdirs[:, 0] + m[:, i, 1] * vdirs[:, 1])
         + m[:, i, 2] * vdirs[:, 2] for i in range(3)],
        dim=-1,
    )
    return eval_basis(opt.format, opt.basis_dim, rd, spec.extra_data) * window


class _Basis:
    """Per-ray basis, or per-sample when per-voxel matrices rotate the
    view direction (None for RGBA)."""

    def __init__(self, spec: TreeSpec, opt: RenderOptions, vdirs):
        self.spec, self.opt, self.vdirs = spec, opt, vdirs
        rgba = opt.format == FORMAT_RGBA
        self.rotate = not rgba and spec.transformation_matrices is not None
        self.window = self.base = None
        if not rgba:
            self.window = torch.as_tensor(_basis_window(opt), device=vdirs.device)
            if not self.rotate:
                self.base = eval_basis(opt.format, opt.basis_dim, vdirs,
                                       spec.extra_data) * self.window

    def at(self, rows):
        if self.rotate:
            return _rotated_basis(self.spec, self.opt, self.vdirs, rows, self.window)
        return self.base


def volume_render_plain(spec: TreeSpec, features: torch.Tensor,
                        origins: torch.Tensor, dirs: torch.Tensor,
                        vdirs: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """Plain PyTorch version of the forward-march kernel: one sample per
    ray per iteration, vectorized over rays (SH, SG, ASG and RGBA)."""
    return _march_plain(spec, features, origins, dirs, vdirs, opt, False)[0]


def volume_render_with_weight_accum_plain(spec: TreeSpec, features: torch.Tensor,
                                          origins: torch.Tensor, dirs: torch.Tensor,
                                          vdirs: torch.Tensor, opt: RenderOptions):
    """Plain PyTorch version of the weight-accumulating forward march:
    (out, waccum)."""
    return _march_plain(spec, features, origins, dirs, vdirs, opt, True)


def _sample_sigma(spec, features, opt: RenderOptions, rays, t, active):
    """Every ray's sample at t (plain): (leaf, dt, valid, rows, corners,
    sigma). ``rows`` is the sample's own row where it is < M and the ray
    active, else 0 (the row its rotation reads). Nearest mode: a sample is
    ``valid`` where that row is < M, and sigma is the row's (corners
    None); under ``opt.interp`` every active sample is valid and sigma is
    the corners' interpolation (`_interp`), whatever its own row."""
    M = features.shape[0]
    leaf, dt = _sample_leaf(spec, opt, rays, t)
    idx = leaf.data_idx
    resident = active & (idx >= 0) & (idx < M)
    rows = torch.where(resident, idx, 0).long()
    if opt.interp:
        corners = _corners(spec, rays, t, leaf, M)
        sigma = torch.where(active, _interp(corners, lambda r: gather_rows(features, r, -1)), 0.0)
        return leaf, dt, active, rows, corners, sigma
    return leaf, dt, resident, rows, None, torch.where(resident, gather_rows(features, rows, -1),
                                                       0.0)


def _scatter_rows(grad, rows, corners, contrib, vals) -> None:
    """Add each contributing sample's gradient ``vals`` ((B, D) rows or
    (B,) values) into ``grad`` at its row; under interp into its corners'
    rows, ``w_c * vals``, where the corner's row is < M (JAX
    `scatter_grads`)."""
    if corners is None:
        grad.index_add_(0, rows[contrib], vals[contrib])
        return
    for n in range(8):
        ok = contrib & corners.ok[n]
        w, v = corners.w[n][ok], vals[ok]
        grad.index_add_(0, corners.rows[n][ok], (w[:, None] if v.ndim == 2 else w) * v)


def _march_plain(spec, features, origins, dirs, vdirs, opt, want_weights):
    _check_supported(spec, features, origins, dirs, vdirs, opt)
    B = origins.shape[0]
    M, D = features.shape
    dev = origins.device
    dtype = torch.promote_types(pool_dtype(features), origins.dtype)
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    rays = _ray_setup(spec, origins, dirs, opt)
    o, d, invdir, delta_scale, tmin, tmax, hit = rays
    basis = _Basis(spec, opt, vdirs)
    can_stop = opt.stop_thresh > 0.0
    waccum = (torch.zeros(_n_tree_cells(spec), dtype=torch.float32, device=dev)
              if want_weights else None)

    t = tmin
    L = torch.ones(B, dtype=dtype, device=dev)
    out_c = torch.zeros(B, n_color, dtype=dtype, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    # With an empty pool no sample can contribute: skip the march.
    active = hit.clone() if M > 0 else torch.zeros_like(hit)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        leaf, dt, valid, rows, corners, sigma = _sample_sigma(spec, features, opt, rays, t, active)
        contrib = valid & (sigma > opt.sigma_thresh)
        att = torch.exp(-dt * delta_scale * sigma)
        weight = L * (1.0 - att)
        col = _sample_colors(features, rows, corners, basis.at(rows), opt, n_color)
        out_c = torch.where(contrib[:, None], out_c + weight[:, None] * col, out_c)
        if want_weights:
            waccum.index_add_(0, _tree_cells(spec, leaf.node_flat[contrib]).long(),
                              weight[contrib].to(waccum.dtype))
        L = torch.where(contrib, L * att, L)
        if can_stop:
            stop = contrib & (L <= opt.stop_thresh)
            out_c = torch.where(stop[:, None], out_c * (1.0 / (1.0 - L))[:, None], out_c)
            stopped = stopped | stop
            active = active & ~stop
        t = torch.where(active, t + dt, t)
        active = active & (t < tmax)

    bg = opt.background_brightness
    out_c = torch.where(stopped[:, None], out_c, out_c + (L * bg)[:, None])
    out_c = torch.where(hit[:, None], out_c, torch.full_like(out_c, bg))
    alpha = torch.where(hit, 1.0 - L, torch.zeros_like(L))
    return torch.cat([out_c, alpha[:, None]], dim=-1), waccum


def volume_render_backward_plain(spec: TreeSpec, features: torch.Tensor,
                                 origins: torch.Tensor, dirs: torch.Tensor,
                                 vdirs: torch.Tensor, grad_out: torch.Tensor,
                                 opt: RenderOptions, out_res=None) -> torch.Tensor:
    """Plain PyTorch version of the backward-march kernel: the gradient of
    a render with respect to the feature pool, (M, D), summed in
    `pool_dtype` (float32 for a bf16 pool; `volume_render_backward` casts
    it to the pool's type).

    The backward marches under its own rules: a ray takes samples while
    hit and ``t < tmax`` (a ray with tmin == tmax takes none), up to
    ``max_steps``; a sample contributes where its row is < M (under
    interp: any sample) and ``sigma > 0``, whatever ``sigma_thresh`` is;
    there is no early stop. Under interp each row below goes to the
    sample's corners' rows, times their weights.
    Per contributing sample, with ``weight = L * (1 - att)``,
    ``s`` the sigmoid colors and ``total_color = sum_c s_c g_c``:

      * coefficient column ``c * basis_dim + k`` (RGBA: ``c``) gets
        ``(weight * s_c (1 - s_c)) * g_c * basis_k``;
      * column ``D - 1`` gets ``dt*ds * (total_color * L_after -
        acc_after) + dt*ds * (g_alpha * L_ray)``; columns between get 0.

    Single pass (``sigma_thresh == 0``, ``stop_thresh <= 0`` and
    ``out_res`` given): ``acc`` starts at ``sum_c out_c g_c`` and falls by
    ``weight * total_color`` per sample, ``L_ray = 1 - out_alpha``. Two
    passes otherwise: pass 1 adds the coefficient rows and sums
    ``accum``, then ``accum += L_ray * bg * sum_c g_c`` with ``L_ray``
    pass 1's final L; pass 2 re-marches and adds the sigma column.
    """
    _check_supported(spec, features, origins, dirs, vdirs, opt)
    _check_ray_grads(features, opt, origins, grad_out, out_res)
    B = origins.shape[0]
    M, D = features.shape
    grad = torch.zeros(M, D, dtype=pool_dtype(features), device=features.device)
    if M == 0 or B == 0:
        return grad
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    rays = _ray_setup(spec, origins, dirs, opt)
    basis = _Basis(spec, opt, vdirs)
    g = grad_out[:, :n_color]
    g_alpha = grad_out[:, n_color]
    march = dict(spec=spec, features=features, opt=opt, rays=rays, basis=basis,
                 g=g, g_alpha=g_alpha, grad=grad)
    if opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0 and out_res is not None:
        acc = _sum_cols(out_res[:, :n_color] * g)
        _march_bwd_plain(**march, color=True, sigma=True, acc=acc,
                         L_ray=1.0 - out_res[:, n_color])
        return grad
    L_ray, accum = _march_bwd_plain(**march, color=True, sigma=False,
                                    acc=torch.zeros_like(g_alpha), L_ray=None)
    accum = accum + (L_ray * opt.background_brightness) * _sum_cols(g)
    _march_bwd_plain(**march, color=False, sigma=True, acc=accum, L_ray=L_ray)
    return grad


def _march_bwd_plain(spec, features, opt, rays, basis, g, g_alpha, grad,
                     color, sigma, acc, L_ray):
    """One backward march, adding into ``grad``. ``color``: coefficient
    rows, with ``acc`` summed upward; ``sigma``: the sigma column, with
    ``acc`` falling. Returns (final L, final acc)."""
    o, d, invdir, delta_scale, tmin, tmax, hit = rays
    D = features.shape[1]
    B = o.shape[0]
    n_color = g.shape[1]
    n_cc = n_color * opt.basis_dim if opt.format != FORMAT_RGBA else n_color
    t = tmin
    L = torch.ones(B, dtype=grad.dtype, device=grad.device)
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        leaf, dt, valid, rows, corners, sig = _sample_sigma(spec, features, opt, rays, t, active)
        contrib = valid & (sig > 0.0)
        att = torch.exp(-dt * delta_scale * sig)
        weight = L * (1.0 - att)
        b = basis.at(rows)
        s = _sample_colors(features, rows, corners, b, opt, n_color)
        total_color = _sum_cols(s * g)
        L_after = L * att
        rows_full = torch.zeros(B, D, dtype=grad.dtype, device=grad.device)
        if color:
            a = (weight[:, None] * (s * (1.0 - s))) * g
            if opt.format == FORMAT_RGBA:
                rows_full[:, :n_cc] = a
            else:
                rows_full[:, :n_cc] = (a[:, :, None] * b[:, None, :]).reshape(B, n_cc)
        if sigma:
            acc_after = acc - weight * total_color
            dts = dt * delta_scale
            rows_full[:, D - 1] = (dts * (total_color * L_after - acc_after)
                                   + dts * (g_alpha * L_ray))
        else:
            acc_after = acc + weight * total_color
        _scatter_rows(grad, rows, corners, contrib, rows_full)
        acc = torch.where(contrib, acc_after, acc)
        L = torch.where(contrib, L_after, L)
        t = torch.where(active, t + dt, t)
    return L, acc


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _pool_tensors(features):
    """The tensors of a pool: (features,) or a quantized pool's three."""
    return tuple(features) if isinstance(features, QuantizedFeatures) else (features,)


def pool_args(features):
    """The (features, scale, zero) pointers of a march kernel: scale and
    zero are null but for an int8 pool."""
    if isinstance(features, QuantizedFeatures):
        return tuple(t.data_ptr() for t in features)
    return features.data_ptr(), None, None


def _check_kernel_tensors(spec, features, rays, name: str) -> None:
    """Devices, layouts and types of a march kernel's rays, pool and
    tables. The pool's type picks the kernel instance (`_kernel_for`)."""
    dev = features.device
    for t in (*_pool_tensors(features), *rays):
        _require(t.is_cuda and t.device == dev, f"{name} needs all tensors on one CUDA device")
        _require(t.is_contiguous(), f"{name} needs contiguous tensors")
    for t in rays:
        _require(t.dtype == torch.float32, "rays must be float32")
    check_structure(spec, dev, name)
    _require(rays[0].shape[0] < 2 ** 31, "too many rays")


def _kernel_for(spec, opt: RenderOptions, instances: dict, features) -> Kernel:
    """The kernel of ``instances`` (`march_instances`) for the pool's type
    (K5), the structure ``spec`` is and ``opt.interp``. A pool type with
    no instance raises: the port never converts a pool to run another."""
    kind = pool_kind(features)
    if kind not in instances:
        raise ValueError(f"{instances['f32'][0].symbol} has no kernel instance for a {kind} "
                         f"feature pool (instances: {', '.join(instances)})")
    return instances[kind][2 * bool(opt.interp) + isinstance(spec, BakedTree)]


def _structure_arg(spec, opt: RenderOptions):
    """The structure argument of a march kernel (kept alive by the
    returned reference for the call). Under interp the box is not used, so
    no box advance."""
    box_advance = 0 if opt.interp else opt.box_advance
    return ctypes.byref(structure_desc(spec, box_advance, effective_skip_base(spec, opt)))


def _kernel_args(spec, features, origins, dirs, vdirs,
                 opt: RenderOptions, name: str):
    """Check a march kernel's inputs and return (the shared leading
    arguments of `_MARCH_ARGS`, n_color). The checks on formats and sizes
    come first, then devices, types and layouts."""
    _check_supported(spec, features, origins, dirs, vdirs, opt)
    n_color = check_format(spec, features, opt)
    _check_kernel_tensors(spec, features, (origins, dirs, vdirs), name)
    args = (
        _structure_arg(spec, opt), origins.data_ptr(), dirs.data_ptr(), vdirs.data_ptr(),
        origins.shape[0], spec.offset.data_ptr(), spec.scaling.data_ptr(),
        *radiometry_args(spec, features, opt, n_color), opt.step_size, opt.background_brightness,
    )
    return args, n_color


def check_format(spec, features, opt: RenderOptions) -> int:
    """Check the format and basis of a kernel's pool against the kernels'
    capacities (SG/ASG need ``spec.extra_data``) and return n_color."""
    fmt, bd = opt.format, opt.basis_dim
    if fmt == FORMAT_SH and bd not in SH_DIM_TO_DEG:
        raise ValueError(f"SH basis_dim must be one of {sorted(SH_DIM_TO_DEG)}")
    if fmt in (FORMAT_SG, FORMAT_ASG):
        _require(1 <= bd <= KERNEL_MAX_BASIS, f"SG/ASG basis_dim must be in [1, {KERNEL_MAX_BASIS}]")
        ex = spec.extra_data
        _require(ex is not None and ex.ndim == 2 and ex.shape[0] >= bd
                 and ex.shape[1] >= _EXTRA_WIDTH[fmt],
                 f"SG/ASG need extra_data of at least ({bd}, {_EXTRA_WIDTH[fmt]})")
    elif fmt not in (FORMAT_RGBA, FORMAT_SH):
        raise ValueError(f"unknown format {fmt}")
    n_color = get_out_data_dim(fmt, bd, features.shape[1]) - 1
    if n_color > KERNEL_MAX_COLORS:
        raise NotImplementedError(
            f"the march kernels take at most {KERNEL_MAX_COLORS} color channels, got {n_color}"
        )
    return n_color


def radiometry_args(spec, features, opt: RenderOptions, n_color: int) -> tuple:
    """The pool and radiometry arguments a march or tape kernel shares,
    features to n_color (`_MARCH_ARGS`), after checking the rotation
    matrices and SG/ASG lobes of ``spec`` (which needs only
    ``transformation_matrices`` and ``extra_data``) on the pool's device."""
    fmt, bd = opt.format, opt.basis_dim
    M, D = features.shape
    dev = features.device
    tm = spec.transformation_matrices if fmt != FORMAT_RGBA else None
    if tm is not None:
        _require(tm.is_cuda and tm.device == dev and tm.is_contiguous()
                 and tm.dtype == torch.float32, "transformation_matrices must be contiguous float32 on the features' device")
        _require(tm.ndim == 3 and tuple(tm.shape[1:]) == (4, 4) and tm.shape[0] >= M,
                 "transformation_matrices must be (M, 4, 4)")
    ex = spec.extra_data if fmt in (FORMAT_SG, FORMAT_ASG) else None
    if ex is not None:
        _require(ex.is_cuda and ex.device == dev and ex.is_contiguous()
                 and ex.dtype == torch.float32, "extra_data must be contiguous float32 on the features' device")
    return (
        *pool_args(features), M, D, None if tm is None else tm.data_ptr(), fmt,
        None if ex is None else ex.data_ptr(), 0 if ex is None else ex.shape[1],
        0 if fmt == FORMAT_RGBA else bd, opt.min_comp, opt.max_comp, n_color,
    )


def _stream(dev: torch.device):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def volume_render_cuda(spec, features: torch.Tensor,
                       origins: torch.Tensor, dirs: torch.Tensor,
                       vdirs: torch.Tensor, opt: RenderOptions, width=None) -> torch.Tensor:
    """Launch the forward-march kernel (csrc/render_fwd.cu, or its baked
    instance csrc/render_fwd_baked.cu on a BakedTree; under interp
    render_fwd_interp.cu / render_fwd_baked_interp.cu; for a bf16 or int8
    pool the same sources with _bf16 / _i8): RGBA, SH (basis_dim 1, 4, 9,
    16, 25), SG and ASG (basis_dim 1-25), exact and thresholded, with
    optional per-voxel rotation matrices. ``width``: the vector instance
    (1 or 4) instead of `render_fwd_width`'s; the kernel refuses one the
    row, the mode or the pointers' alignment does not allow (a comparison
    of the instances passes it)."""
    return _march_cuda(spec, features, origins, dirs, vdirs, opt, False, width)[0]


def volume_render_with_weight_accum_cuda(spec: TreeSpec, features: torch.Tensor,
                                         origins: torch.Tensor, dirs: torch.Tensor,
                                         vdirs: torch.Tensor, opt: RenderOptions, width=None):
    """Launch the forward-march kernel with weight accumulation:
    (out, waccum (capacity * N^3,), summed per tree cell). ``width`` as
    `volume_render_cuda`'s."""
    return _march_cuda(spec, features, origins, dirs, vdirs, opt, True, width)


def _vector_row(fmt: int, basis_dim: int, D: int) -> bool:
    """Whether a row has a width-4 instance (K2, K13c-e): the three-colour
    rows with no spare column (RGBA at D = 4, SH1 at D = 4, SH9 at D = 28)."""
    if fmt == FORMAT_RGBA:
        return D == 4
    return fmt == FORMAT_SH and (basis_dim, D) in ((1, 4), (9, 28))


def render_fwd_width(fmt: int, basis_dim: int, D: int, pool_ptr: int, pool_elem: int,
                     scale_ptrs=()) -> int:
    """The vector width of a K2 launch, nearest or interp (and of K13c's): 4 for the
    three-colour rows with no spare column when the pool (``pool_ptr``,
    ``pool_elem`` bytes a value) is aligned to 4 values and the float32
    ``scale_ptrs`` (an int8 pool's scale and zero; K2's rotation matrices,
    read in 16-byte rows) to 16 bytes, else 1."""
    aligned = pool_ptr % (4 * pool_elem) == 0 and all(q % 16 == 0 for q in scale_ptrs)
    return 4 if _vector_row(fmt, basis_dim, D) and aligned else 1


def _fwd_width(spec, features, opt: RenderOptions) -> int:
    """`render_fwd_width` of a K2 launch on ``spec`` and ``features``, nearest
    or interp (K2+K4 reads each corner's row at the same widths), and of a
    K3 or K3+K4 launch (its gradient buffer is a fresh, aligned one)."""
    q, ptrs = features, []
    if isinstance(features, QuantizedFeatures):
        q, ptrs = features.q, [features.scale.data_ptr(), features.zero.data_ptr()]
    tm = spec.transformation_matrices if opt.format != FORMAT_RGBA else None
    if tm is not None:
        ptrs.append(tm.data_ptr())
    return render_fwd_width(opt.format, opt.basis_dim, features.shape[1], q.data_ptr(), q.element_size(),
                            ptrs)


def _march_cuda(spec, features, origins, dirs, vdirs, opt, want_weights, width=None):
    args, n_color = _kernel_args(spec, features, origins, dirs, vdirs, opt, "volume_render_cuda")
    kernel = _kernel_for(spec, opt, _FWD_INSTANCES, features)
    dev = features.device
    out = torch.empty(origins.shape[0], n_color + 1, dtype=torch.float32, device=dev)
    waccum = (torch.zeros(_n_tree_cells(spec), dtype=torch.float32, device=dev)
              if want_weights else None)
    if out.shape[0] == 0:
        return out, waccum
    if width is None:
        width = _fwd_width(spec, features, opt)
    kernel(
        *args, opt.sigma_thresh, opt.stop_thresh, opt.max_steps,
        out.data_ptr(), None if waccum is None else waccum.data_ptr(), width, *_stream(dev),
    )
    FWD_WIDTH_LAUNCHES[width] += 1
    return out, waccum


def volume_render_backward_cuda(spec: TreeSpec, features: torch.Tensor,
                                origins: torch.Tensor, dirs: torch.Tensor,
                                vdirs: torch.Tensor, grad_out: torch.Tensor,
                                opt: RenderOptions, out_res=None, width=None) -> torch.Tensor:
    """Launch the backward-march kernel (csrc/render_bwd.cu, or
    csrc/render_bwd_baked.cu on a BakedTree; under interp
    render_bwd_interp.cu / render_bwd_baked_interp.cu; a bf16 pool's
    instances of csrc/render_bwd.cuh) into a zeroed float32 (M, D) gradient;
    single pass when `volume_render_backward_plain` takes one. An empty
    pool or ray batch returns zeros without a launch. The vector width is
    K2's (`render_fwd_width`: 4 for the three-colour rows with no spare
    column and aligned pointers, else 1); ``width`` (1 or 4) forces one,
    and 4 on a row or pointers that do not allow it raises (a comparison of
    the instances passes it)."""
    if width not in (None, 1, 4):
        raise ValueError(f"width must be 1 or 4, got {width!r}")
    if width == 4 and _fwd_width(spec, features, opt) != 4:
        raise ValueError("width 4 takes only the three-colour RGBA, SH1 and SH9 rows with no spare "
                         "column (D = 4, 4, 28), the pool aligned to 4 values and the rotations to 16 bytes")
    args, n_color = _kernel_args(spec, features, origins, dirs, vdirs, opt,
                                 "volume_render_backward_cuda")
    kernel = _kernel_for(spec, opt, _BWD_INSTANCES, features)
    _check_ray_grads(features, opt, origins, grad_out, out_res)
    single = opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0 and out_res is not None
    for t in (grad_out, out_res if single else None):
        if t is not None:
            _require(t.is_contiguous() and t.dtype == torch.float32,
                     "grad_out and out_res must be contiguous float32")
    M, D = features.shape
    dev = features.device
    grad = torch.zeros(M, D, dtype=torch.float32, device=dev)
    if M == 0 or origins.shape[0] == 0:
        return grad
    if width is None:
        width = _fwd_width(spec, features, opt)
    kernel(
        *args, opt.max_steps, grad_out.data_ptr(),
        out_res.data_ptr() if single else None, grad.data_ptr(), width, *_stream(dev),
    )
    MARCH_BWD_WIDTH_LAUNCHES[width] += 1
    return grad


def cam2world_rays(c2w, width: int, height: int, fx: float, fy: float):
    """Pinhole rays for every pixel, on c2w's device.

    :return: (origins (H*W, 3), dirs (H*W, 3))
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    ix = torch.arange(width, dtype=torch.float32, device=dev)
    iy = torch.arange(height, dtype=torch.float32, device=dev)
    x = (ix[None, :] - 0.5 * width) / fx
    y = -(iy[:, None] - 0.5 * height) / fy
    x, y = torch.broadcast_tensors(x, y)
    z = torch.sqrt(x * x + y * y + 1.0)
    x, y, z = x / z, y / z, -1.0 / z
    x, y, z = x.reshape(-1), y.reshape(-1), z.reshape(-1)
    r = c2w[:3, :3]
    dirs = torch.stack(
        [(r[i, 0] * x + r[i, 1] * y) + r[i, 2] * z for i in range(3)], dim=-1
    )
    origins = c2w[:3, 3].expand_as(dirs).contiguous()
    return origins, dirs


def world2ndc(opt: RenderOptions, dirs, origins, near: float = 1.0):
    """NDC warp. Returns (dirs, origins)."""
    t = -(near + origins[..., 2]) / dirs[..., 2]
    origins = origins + t[..., None] * dirs
    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ndx = -((2 * opt.ndc_focal) / opt.ndc_width) * (dx / dz - ox / oz)
    ndy = -((2 * opt.ndc_focal) / opt.ndc_height) * (dy / dz - oy / oz)
    ndz = -2 * near / oz
    nox = -((2 * opt.ndc_focal) / opt.ndc_width) * (ox / oz)
    noy = -((2 * opt.ndc_focal) / opt.ndc_height) * (oy / oz)
    noz = 1 + 2 * near / oz
    new_dirs = torch.stack([ndx, ndy, ndz], dim=-1)
    new_dirs = new_dirs / torch.linalg.norm(new_dirs, dim=-1, keepdim=True)
    return new_dirs, torch.stack([nox, noy, noz], dim=-1)
