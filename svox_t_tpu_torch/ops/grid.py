"""Dense-grid max-weight pass (K12): the counterpart of `svox_t_tpu/ops/grid.py`.

PlenOctrees' conversion and pruning utility (the CUDA reference's
``grid_weight_render``, rt_kernel.cu:1240-1344, 1454-1478): every camera
ray marches a dense reso^3 sigma grid, and each voxel keeps (a) the
largest compositing weight any ray gave it and (b) how many ray samples
hit it. On CUDA tensors K12 (`csrc/grid.cu`) marches one ray per thread
with an ``atomicMax`` on the weight's bits and an ``atomicAdd`` of 1,
after an occupancy pass that marks the GRID_BRICK^3 bricks holding a
sigma above the threshold: the march loads sigma only in marked bricks.
On the CPU its plain PyTorch version marches all rays a step at a time
with a scatter-max and an index-add. Both outputs are order-independent,
so the two agree bit for bit. The JAX package's chunking of the rays (and
its padding rays) schedules a TPU and has no counterpart here.

`grid_occupancy_plain` is the occupancy pass's plain version, and
`grid_march_mirror` the kernel's masked march in PyTorch (sigma read only
where the mask is set), with the census of what the march reads.
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

# The occupancy mask's brick edge (csrc/grid.cu kBrick).
GRID_BRICK = 8

GRID_OCCUPANCY = Kernel("svox_grid_occupancy", [
    c_void_p, c_int, c_float,           # data, reso, sigma_thresh
    c_void_p, c_int, c_void_p,          # mask, device, stream
])
GRID_WEIGHT = Kernel("svox_grid_weight", [
    c_void_p, c_void_p, c_int, c_int,   # origins, dirs, B, width
    c_void_p, c_void_p, c_void_p,       # offset, scaling, data
    c_int, c_float, c_float, c_int,     # reso, step_size, sigma_thresh, max_steps
    c_void_p,                           # mask
    c_void_p, c_void_p, c_int, c_void_p,  # grid_weight, grid_hit, device, stream
])


def mask_words(reso: int, brick: int = GRID_BRICK) -> int:
    """32-bit words of a reso^3 grid's occupancy mask: one bit per brick."""
    nb = -(-reso // brick)
    return -(-nb ** 3 // 32)


def grid_occupancy_plain(data, sigma_thresh: float, brick: int = GRID_BRICK) -> torch.Tensor:
    """Plain PyTorch version of K12's occupancy pass: (mask_words(reso),)
    int32, bit b of word w set where brick 32 w + b (x-major over the
    ceil(reso / brick)^3 bricks) holds a voxel with sigma > sigma_thresh,
    the march's own predicate (NaN never passes); edge bricks are partial."""
    reso = data.shape[0]
    nb = -(-reso // brick)
    pad = torch.zeros((nb * brick,) * 3, dtype=torch.bool, device=data.device)
    pad[:reso, :reso, :reso] = data > sigma_thresh
    flags = pad.reshape(nb, brick, nb, brick, nb, brick).any(5).any(3).any(1).reshape(-1)
    n = mask_words(reso, brick)
    bits = torch.zeros(n * 32, dtype=torch.int64, device=data.device)
    bits[:flags.numel()] = flags.long()
    words = (bits.reshape(n, 32) << torch.arange(32, device=data.device)).sum(1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def grid_occupancy_cuda(data, sigma_thresh: float) -> torch.Tensor:
    """Launch K12's occupancy pass (csrc/grid.cu): the mask as
    `grid_occupancy_plain`."""
    dev = data.device
    _require(data.is_cuda and data.is_contiguous() and data.dtype == torch.float32,
             "grid_occupancy_cuda needs a contiguous float32 CUDA grid")
    reso = data.shape[0]
    mask = torch.empty(mask_words(reso), dtype=torch.int32, device=dev)
    GRID_OCCUPANCY(data.data_ptr(), reso, sigma_thresh, mask.data_ptr(), *_stream(dev))
    return mask


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


def grid_march_mirror(data, origins, dirs, offset, scaling, opt: RenderOptions, mask=None,
                      brick: int = GRID_BRICK, width: int = 0):
    """K12's masked march in PyTorch: (grid_weight, grid_hit, census). The
    sample chain of `grid_weight_plain`, with sigma read only where the
    sample's brick is set in ``mask`` (`grid_occupancy_plain` when None):
    the outputs equal `grid_weight_plain`'s bit for bit. The census counts
    the rays, the samples, the distinct voxels they land in, the samples
    in marked bricks (the kernel's sigma loads) and their distinct voxels,
    the contributing samples and their distinct voxels (those the atomics
    write), the marked bricks, and the iterations the
    march's warps run (a warp runs as long as its longest ray): 32
    consecutive rays a warp, and with ``width`` (rays in rows of that many
    pixels) 8x4 pixel tiles."""
    reso = data.shape[0]
    dev = data.device
    flat = data.reshape(-1)
    if mask is None:
        mask = grid_occupancy_plain(data, opt.sigma_thresh, brick)
    words = mask.long() & 0xFFFFFFFF
    nb = -(-reso // brick)
    o, d, invdir, delta_scale, tmin, tmax, hit = _ray_setup(
        SimpleNamespace(offset=offset, scaling=scaling), origins, dirs)
    gw = torch.zeros(reso ** 3, dtype=torch.float32, device=dev)
    gh = torch.zeros_like(gw)
    seen = torch.zeros(reso ** 3, dtype=torch.bool, device=dev)
    seen_marked = torch.zeros_like(seen)
    steps = torch.zeros(tmin.shape[0], dtype=torch.int64, device=dev)
    res = torch.full_like(tmin, float(reso))
    t, L, active = tmin, torch.ones_like(tmin), hit
    samples = loads = contrib_n = 0
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
        b = ((uvw[:, 0] // brick) * nb + uvw[:, 1] // brick) * nb + uvw[:, 2] // brick
        marked = active & (((words[b >> 5] >> (b & 31)) & 1) == 1)
        sigma = torch.zeros_like(t)
        sigma[marked] = flat[node[marked]]
        contrib = marked & (sigma > opt.sigma_thresh)
        att = torch.exp(-delta_t * delta_scale * sigma)
        weight = L * (1.0 - att)
        L = torch.where(contrib, L * att, L)
        gw.scatter_reduce_(0, node[contrib], weight[contrib], "amax")
        gh.index_add_(0, node[contrib], torch.ones_like(weight[contrib]))
        seen[node[active]] = True
        seen_marked[node[marked]] = True
        steps += active.long()
        samples += int(active.sum())
        loads += int(marked.sum())
        contrib_n += int(contrib.sum())
        t = t + delta_t
        active = active & (t < tmax)
    n = steps.shape[0]
    pad = torch.zeros(-(-n // 32) * 32, dtype=torch.int64, device=dev)
    pad[:n] = steps
    census = dict(rays=n, samples=samples, voxels=int(seen.sum()), loads=loads,
                  voxels_marked=int(seen_marked.sum()), contrib=contrib_n, voxels_contrib=int((gh > 0).sum()),
                  bricks=int(((words.reshape(-1, 1) >> torch.arange(32, device=dev)) & 1).sum()),
                  brick=brick, reso=reso, warp_steps=int(pad.reshape(-1, 32).max(1).values.sum()))
    if width and n % (width * 4) == 0 and width % 8 == 0:
        tiles = steps.reshape(n // (width * 4), 4, width // 8, 8).permute(0, 2, 1, 3).reshape(-1, 32)
        census["tile_warp_steps"] = int(tiles.max(1).values.sum())
    return gw.reshape(reso, reso, reso), gh.reshape(reso, reso, reso), census


def grid_weight_cuda(data, origins, dirs, offset, scaling, opt: RenderOptions, width: int = 0):
    """Launch K12 (csrc/grid.cu): the occupancy pass, then the march;
    (grid_weight, grid_hit) as `grid_weight_plain`. ``width``: the rays
    come in rows of that many pixels (a warp then marches an 8x4 tile);
    0 for rays in any order."""
    dev = data.device
    for t in (data, origins, dirs, offset, scaling):
        _require(t.is_cuda and t.device == dev and t.is_contiguous() and t.dtype == torch.float32,
                 "grid_weight_cuda needs contiguous float32 tensors on one CUDA device")
    reso = data.shape[0]
    _require(origins.shape[0] < 2 ** 31, "too many rays")
    gw = torch.zeros(reso, reso, reso, dtype=torch.float32, device=dev)
    gh = torch.zeros_like(gw)
    if origins.shape[0]:
        mask = grid_occupancy_cuda(data, opt.sigma_thresh)
        GRID_WEIGHT(origins.data_ptr(), dirs.data_ptr(), origins.shape[0], width, offset.data_ptr(),
                    scaling.data_ptr(), data.data_ptr(), reso, opt.step_size, opt.sigma_thresh,
                    opt.max_steps, mask.data_ptr(), gw.data_ptr(), gh.data_ptr(), *_stream(dev))
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
    if data.is_cuda:
        return grid_weight_cuda(data, origins, dirs, offset, scaling, opt, width=cam.width)
    return grid_weight_plain(data, origins, dirs, offset, scaling, opt)
