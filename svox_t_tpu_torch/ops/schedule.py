"""Cost-ordered ray schedules (K15): the counterpart of `svox_t_tpu/ops/schedule.py`.

A plan sorts rays by a predicted march cost: the number of steps the
march's structure walk takes for each ray. Any permutation renders every
ray bit for bit as before (one thread marches one ray), so a plan is a
schedule and never changes an output; only the weight accumulator's
atomics add in another order. On the TPU a chunk's loop ran until its
slowest ray ended, and cost-homogeneous chunks recovered that waste; on
the card a warp waits for its slowest ray in the same way.

  * `march_cost`: per ray the step count of the march's walk (K13a's
    total: `_ray_setup`, the occupied-box cull and in fast mode the box
    advance, the leaf lookups with the skip boxes), at most ``max_steps``.
    Under ``interp`` the cull and the box advance are off, as in the
    march. With ``stop_thresh > 0`` and a density column ``sigmas`` the
    walk also carries the transmittance and retires a ray after the step
    where it falls to ``stop_thresh``, as the march stops early.
  * `ray_costs`: `march_cost` under a call's `RenderOptions`, with the
    skip-box gate the march itself honors (`effective_skip_base`).
  * `cost_order`: the stable sort of those costs: rays of equal cost keep
    their input (tile) order.

`march_cost` dispatches on the device of its rays: on CUDA it launches
K15 (`csrc/tape_record.cuh`, one instance per structure) or raises; on
the CPU it runs `march_cost_plain`, which follows the kernel operation for
operation. Costs stay on the rays' device; the sort runs there too.
"""

from __future__ import annotations

import ctypes
from ctypes import c_float, c_int, c_void_p

import torch

from .._build import Kernel
from ..utils.spec import RenderOptions
from .bake import BakedTree, check_structure, structure_desc
from .render import (_locate, _ray_setup, _require, _step, _stream, effective_skip_base,
                     sample_position)
from .tape import _WALK_ARGS, _occupied

__all__ = ["march_cost", "march_cost_plain", "ray_costs", "cost_order"]

_COST_ARGS = _WALK_ARGS + [c_int, c_float, c_float, c_void_p,  # interp, sigma/stop thresh, sigmas
                           c_void_p, c_int, c_void_p]          # cost, device, stream
MARCH_COST = Kernel("svox_march_cost", _COST_ARGS)
MARCH_COST_BAKED = Kernel("svox_march_cost_baked", _COST_ARGS)

# The JAX package's cost walk chunk (a TPU loop bound); accepted and ignored.
_PLAN_CHUNK = 8192


def _use_stop(stop_thresh: float, sigmas) -> bool:
    return stop_thresh > 0.0 and sigmas is not None


def march_cost_plain(spec, origins, dirs, skip_base: int, n_rows: int, step_size: float,
                     max_steps: int, interp: int = 0, box_advance: int = 0,
                     sigma_thresh: float = 0.0, stop_thresh: float = 0.0, sigmas=None,
                     chunk: int = 0, return_margin: bool = False):
    """Plain PyTorch version of K15: (B,) int32 step counts. With
    ``return_margin`` also (B,) float32: per ray the least |L -
    stop_thresh| over the samples that changed its transmittance (inf for
    none, or without stop prediction), so that a comparison can leave out
    the rays whose stop an ulp of L could move."""
    del chunk
    geom = RenderOptions(interp=int(interp), box_advance=int(box_advance))
    o, d, invdir, dscale, tmin, tmax, hit = _ray_setup(spec, origins, dirs, geom)
    use_stop = _use_stop(stop_thresh, sigmas)
    n = torch.zeros(origins.shape[0], dtype=torch.int32, device=origins.device)
    L = torch.ones_like(tmin)
    margin = torch.full_like(tmin, float("inf"))
    t, active = tmin, hit & (tmin < tmax)
    for _ in range(int(max_steps)):
        if not bool(active.any()):
            break
        leaf = _locate(spec, sample_position(o, t, d))
        dt = _step(leaf, invdir, step_size, skip_base)
        if use_stop:
            occ = _occupied(leaf.data_idx, n_rows)
            sig = torch.where(occ, sigmas[torch.where(occ, leaf.data_idx, 0).long()], 0.0)
            contrib = active & occ & (sig > sigma_thresh)
            L = torch.where(contrib, L * torch.exp(-dt * dscale * sig), L)
            margin = torch.where(contrib, torch.minimum(margin, (L - stop_thresh).abs()), margin)
        t = torch.where(active, t + dt, t)
        n += active.to(torch.int32)
        active = active & (t < tmax)
        if use_stop:
            active = active & (L > stop_thresh)
    return (n, margin) if return_margin else n


def march_cost_cuda(spec, origins, dirs, skip_base: int, n_rows: int, step_size: float,
                    max_steps: int, interp: int = 0, box_advance: int = 0,
                    sigma_thresh: float = 0.0, stop_thresh: float = 0.0, sigmas=None,
                    chunk: int = 0):
    """Launch K15 (csrc/tape_record.cu, or tape_record_baked.cu on a
    BakedTree): (B,) int32 step counts, as `march_cost_plain`."""
    del chunk
    dev = origins.device
    for t in (origins, dirs):
        _require(t.is_cuda and t.device == dev and t.is_contiguous() and t.dtype == torch.float32,
                 "march_cost_cuda needs contiguous float32 rays on one CUDA device")
    check_structure(spec, dev, "march_cost_cuda")
    _require(origins.shape[0] < 2 ** 31, "too many rays")
    if not _use_stop(stop_thresh, sigmas):
        sigmas = None
    else:
        _require(sigmas.is_cuda and sigmas.device == dev and sigmas.dtype == torch.float32
                 and sigmas.is_contiguous() and sigmas.ndim == 1 and sigmas.numel() >= n_rows,
                 "march_cost_cuda needs a contiguous float32 sigma column of at least n_rows "
                 "values on the rays' device")
    cost = torch.empty(origins.shape[0], dtype=torch.int32, device=dev)
    if origins.shape[0]:
        kernel = MARCH_COST_BAKED if isinstance(spec, BakedTree) else MARCH_COST
        desc = structure_desc(spec, box_advance, skip_base)
        kernel(ctypes.byref(desc), origins.data_ptr(), dirs.data_ptr(), origins.shape[0],
               spec.offset.data_ptr(), spec.scaling.data_ptr(), int(n_rows), float(step_size),
               int(max_steps), int(interp), float(sigma_thresh), float(stop_thresh),
               None if sigmas is None else sigmas.data_ptr(), cost.data_ptr(),
               *_stream(dev))
    return cost


def march_cost(spec, origins, dirs, skip_base: int, n_rows: int, step_size: float,
               max_steps: int, interp: int = 0, box_advance: int = 0,
               sigma_thresh: float = 0.0, stop_thresh: float = 0.0, sigmas=None,
               chunk: int = 0) -> torch.Tensor:
    """Per-ray step count (B,) int32 of the march's structure walk, the
    schedule's cost (JAX `march_cost`, see the module docstring).
    ``chunk`` chunked the JAX walk on the TPU; it is accepted and ignored:
    the counts are per ray either way."""
    run = march_cost_cuda if origins.is_cuda else march_cost_plain
    return run(spec, origins, dirs, skip_base, n_rows, step_size, max_steps, interp, box_advance,
               sigma_thresh, stop_thresh, sigmas, chunk)


def ray_costs(spec, origins, dirs, opt: RenderOptions, n_rows: int, sigmas=None,
              chunk: int = _PLAN_CHUNK) -> torch.Tensor:
    """(B,) int32 predicted march costs under ``opt``, on the rays'
    device. The walk honors exactly the skip boxes the march honors
    (`effective_skip_base`); ``sigmas`` (the pool's density column, any
    float type) is widened to float32."""
    if sigmas is not None:
        sigmas = sigmas.detach().to(device=origins.device, dtype=torch.float32).contiguous()
    return march_cost(spec, origins.contiguous(), dirs.contiguous(), effective_skip_base(spec, opt),
                      int(n_rows), float(opt.step_size), int(opt.max_steps), int(opt.interp),
                      int(opt.box_advance), float(opt.sigma_thresh), float(opt.stop_thresh), sigmas,
                      int(chunk))


def cost_order(spec, origins, dirs, opt: RenderOptions, n_rows: int, sigmas=None,
               chunk: int = _PLAN_CHUNK) -> torch.Tensor:
    """Stable cost-sorted ray permutation, (B,) int32 on the rays' device:
    within equal costs the input order (e.g. tile order) stays. Pass
    ``sigmas`` (the pool's density column) so plans under early
    termination predict where rays retire."""
    n = ray_costs(spec, origins, dirs, opt, n_rows, sigmas, chunk)
    return torch.sort(n, stable=True).indices.to(torch.int32)
