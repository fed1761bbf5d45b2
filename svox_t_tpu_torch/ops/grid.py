"""Dense-grid max-weight pass (K12): the counterpart of `svox_t_tpu/ops/grid.py`.

PlenOctrees' conversion and pruning utility (the CUDA reference's
``grid_weight_render``, rt_kernel.cu:1240-1344, 1454-1478): every camera
ray marches a dense reso^3 sigma grid, and each voxel keeps (a) the
largest compositing weight any ray gave it and (b) how many ray samples
hit it. On CUDA tensors K12 (`csrc/grid.cu`) marches one ray per thread
with an ``atomicMax`` on the weight's bits and an ``atomicAdd`` of 1; on
the CPU its plain PyTorch version marches all rays a step at a time with
a scatter-max and an index-add. Both outputs are order-independent, so
the two agree bit for bit. The JAX package's chunking of the rays (and its
padding rays) schedules a TPU and has no counterpart here.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from types import SimpleNamespace
from typing import Tuple

import torch

from .._build import Kernel
from ..utils.spec import CameraSpec, RenderOptions
from .render import _ray_setup, _require, _stream, cam2world_rays, sample_position, world2ndc
from .traversal import clamp_coord, dda_unit

__all__ = ["grid_weight_render"]

GRID_WEIGHT = Kernel("svox_grid_weight", [
    c_void_p, c_void_p, c_int,          # origins, dirs, B
    c_void_p, c_void_p, c_void_p,       # offset, scaling, data
    c_int, c_float, c_float, c_int,     # reso, step_size, sigma_thresh, max_steps
    c_void_p, c_void_p, c_int, c_void_p,  # grid_weight, grid_hit, device, stream
])


def grid_weight_plain(data, origins, dirs, offset, scaling, opt: RenderOptions):
    """Plain PyTorch version of K12: (grid_weight, grid_hit), each
    (reso, reso, reso) float32, for the world-space rays ``origins``,
    ``dirs`` (B, 3) over the sigma grid ``data``."""
    reso = data.shape[0]
    dev = data.device
    flat = data.reshape(-1)
    o, d, invdir, delta_scale, tmin, tmax, hit = _ray_setup(
        SimpleNamespace(offset=offset, scaling=scaling), origins, dirs)
    gw = torch.zeros(reso ** 3, dtype=torch.float32, device=dev)
    gh = torch.zeros_like(gw)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, and the kernel divides.
    res = torch.full_like(tmin, float(reso))
    t, L, active = tmin, torch.ones_like(tmin), hit
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        pos = clamp_coord(sample_position(o, t, d)) * reso
        uvw = torch.clamp(torch.floor(pos), max=reso - 1)
        frac = pos - uvw
        uvw = uvw.long()
        node = (uvw[:, 0] * reso + uvw[:, 1]) * reso + uvw[:, 2]
        sub_tmin, sub_tmax = dda_unit(frac, invdir)
        delta_t = (sub_tmax - sub_tmin) / res + opt.step_size
        sigma = flat[node]
        contrib = active & (sigma > opt.sigma_thresh)
        att = torch.exp(-delta_t * delta_scale * sigma)
        weight = L * (1.0 - att)
        L = torch.where(contrib, L * att, L)
        gw.scatter_reduce_(0, node[contrib], weight[contrib], "amax")
        gh.index_add_(0, node[contrib], torch.ones_like(weight[contrib]))
        t = t + delta_t
        active = active & (t < tmax)
    return gw.reshape(reso, reso, reso), gh.reshape(reso, reso, reso)


def grid_weight_cuda(data, origins, dirs, offset, scaling, opt: RenderOptions):
    """Launch K12 (csrc/grid.cu): (grid_weight, grid_hit) as
    `grid_weight_plain`."""
    dev = data.device
    for t in (data, origins, dirs, offset, scaling):
        _require(t.is_cuda and t.device == dev and t.is_contiguous() and t.dtype == torch.float32,
                 "grid_weight_cuda needs contiguous float32 tensors on one CUDA device")
    reso = data.shape[0]
    _require(origins.shape[0] < 2 ** 31, "too many rays")
    gw = torch.zeros(reso, reso, reso, dtype=torch.float32, device=dev)
    gh = torch.zeros_like(gw)
    if origins.shape[0]:
        GRID_WEIGHT(origins.data_ptr(), dirs.data_ptr(), origins.shape[0], offset.data_ptr(),
                    scaling.data_ptr(), data.data_ptr(), reso, opt.step_size, opt.sigma_thresh,
                    opt.max_steps, gw.data_ptr(), gh.data_ptr(), *_stream(dev))
    return gw, gh


def grid_weight_render(
    data,
    cam: CameraSpec,
    opt: RenderOptions,
    offset,
    scaling,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:param data: (reso, reso, reso) density grid; a tensor's device is
        the call's, anything else goes to the CUDA card
    :return: (grid_weight (reso,reso,reso) max weights,
              grid_hit (reso,reso,reso) hit counts)

    One ray per pixel of ``cam`` (warped to NDC when ``opt.ndc_width >=
    0``), marched in tree space (``offset + scaling * x``): K12 on CUDA,
    its plain version on the CPU."""
    dev = data.device if isinstance(data, torch.Tensor) else torch.device("cuda")
    data = torch.as_tensor(data, dtype=torch.float32, device=dev).contiguous()
    if data.ndim != 3 or not data.shape[0] == data.shape[1] == data.shape[2]:
        raise ValueError(f"data must be (reso, reso, reso), got {tuple(data.shape)}")
    vec = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(3).contiguous()  # noqa: E731
    offset, scaling = vec(offset), vec(scaling)
    c2w = torch.as_tensor(cam.c2w, dtype=torch.float32, device=dev)
    origins, dirs = cam2world_rays(c2w, cam.width, cam.height, cam.fx, cam.fy)
    if opt.ndc_width >= 0:
        dirs, origins = world2ndc(opt, dirs, origins)
    origins, dirs = origins.contiguous(), dirs.contiguous()
    run = grid_weight_cuda if data.is_cuda else grid_weight_plain
    return run(data, origins, dirs, offset, scaling, opt)
