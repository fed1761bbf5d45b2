"""Point-to-voxel (p2v) Gaussian density splatting, the counterpart of
`svox_t_tpu/ops/p2v.py`: the real-time octree construction front end.

`voxelize` splats each point's density (the last feature column) into a
dense (n, n, n, 1) grid with a Gaussian kernel, over exactly the JAX
package's static (W, W, W) voxel window. It is a
`torch.autograd.Function` (`_VoxelizeFn`) with gradients for the points
and the features; the feature gradient lands in the last column, the
channel that was read (the JAX package's fix). On CUDA tensors the
forward and backward launch their kernels (`csrc/p2v.cu`) or raise; on
CPU tensors the plain PyTorch versions run. The corner, size, grid
resolution and radii are host constants and carry no gradient.

Parity notes (see `csrc/p2v.cu` for the formulas):
  * voxel centres at ``idx * voxel_size + corner`` with ``voxel_size =
    size / (n - 1)`` in float32;
  * W, ``cr``, ``cr^2`` and ``2 k^2`` are formed on the host as the JAX
    package forms them: W with NumPy from the float32 voxel size, the
    others in double and rounded once to float32;
  * contributions are gated by ``r^2 <= cr^2``.
"""

from __future__ import annotations

from ctypes import POINTER, c_float, c_int, c_void_p
from typing import NamedTuple

import numpy as np
import torch

from .._build import Kernel
from .render import _stream

_GRID_ARGS = [
    c_void_p, c_void_p, c_int, c_int,             # points, features, Q, F
    POINTER(c_float), POINTER(c_float), c_int, c_int,  # corner[3], vs[3], n, W
    c_float, c_float, c_float,                    # cr, cr^2, 2 k^2
]
VOXELIZE_FWD = Kernel("svox_voxelize_fwd", _GRID_ARGS + [c_void_p, c_int, c_void_p])
# The same kernel with a count of the blocks that took the shared tile
# (a census; the main paths launch VOXELIZE_FWD).
VOXELIZE_FWD_TILES = Kernel("svox_voxelize_fwd_tiles",
                            _GRID_ARGS + [c_void_p, c_void_p, c_int, c_void_p])
VOXELIZE_BWD = Kernel(
    "svox_voxelize_bwd",
    _GRID_ARGS + [c_void_p, c_void_p, c_void_p,   # grad_vol, d_points, d_features
                  c_int, c_void_p],               # device, stream
)
# Points per chunk of the plain versions' window walk.
_PLAIN_CHUNK = 1 << 18
# The forward kernel's points a block and voxels its shared tile holds
# (`kThreads`, `kTileFloats` in csrc/p2v.cu).
TILE_BLOCK = 256
TILE_FLOATS = 4096


class GridConsts(NamedTuple):
    """Host constants of one voxelize call, as the kernels take them."""

    corner: tuple
    vs: tuple
    n: int
    W: int
    cr: float
    cr2: float
    c2k: float


def grid_consts(volume_corner, volume_size, n_voxels, kernel_radius, conv_radius) -> GridConsts:
    """Corner, voxel size and window width of the grid, and the radii as
    float32 values, formed as `svox_t_tpu/ops/p2v.py` forms them."""
    corner = np.broadcast_to(np.asarray(volume_corner, np.float32), (3,))
    size = np.broadcast_to(np.asarray(volume_size, np.float32), (3,))
    n = int(n_voxels)
    if n < 2:
        raise ValueError(f"n_voxels must be at least 2, got {n}")
    kr = float(kernel_radius)
    cr = float(conv_radius)
    voxel_size = size / (n - 1)
    W = int(np.max(np.ceil(2.0 * cr / voxel_size))) + 2
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return GridConsts(tuple(map(float, corner)), tuple(map(float, voxel_size)), n, W,
                      f32(cr), f32(cr * cr), f32(2.0 * kr * kr))


def voxelize(points: torch.Tensor, point_features: torch.Tensor, volume_corner, volume_size,
             n_voxels: int, kernel_radius: float, conv_radius: float) -> torch.Tensor:
    """Splat point densities into a dense sigma volume; differentiable with
    respect to ``points`` and ``point_features``.

    :param points: (Q, 3) float32
    :param point_features: (Q, F) float32; only the last column (density)
        is used
    :param volume_corner: (3,) or scalar lower corner (host values)
    :param volume_size: (3,) or scalar extent (host values)
    :param n_voxels: grid resolution per axis
    :param kernel_radius: Gaussian bandwidth k
    :param conv_radius: cutoff radius
    :return: (n_voxels, n_voxels, n_voxels, 1) float32 density volume
    """
    c = grid_consts(volume_corner, volume_size, n_voxels, kernel_radius, conv_radius)
    return _VoxelizeFn.apply(points, point_features, c)


class _VoxelizeFn(torch.autograd.Function):
    """`voxelize` with its backward kernel; only the gradients the inputs
    need are formed."""

    @staticmethod
    def forward(ctx, points, features, c):
        fwd = voxelize_forward_cuda if points.is_cuda else voxelize_forward_plain
        vol = fwd(points, features, c)
        ctx.save_for_backward(points, features)
        ctx.consts = c
        return vol

    @staticmethod
    def backward(ctx, grad_vol):
        want_p, want_f = ctx.needs_input_grad[:2]
        if not (want_p or want_f):
            return None, None, None
        points, features = ctx.saved_tensors
        bwd = voxelize_backward_cuda if points.is_cuda else voxelize_backward_plain
        dp, df = bwd(points, features, ctx.consts, grad_vol.contiguous(), want_p, want_f)
        return dp, df, None


def _check(points, features) -> None:
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (Q, 3), got {tuple(points.shape)}")
    if features.ndim != 2 or features.shape[0] != points.shape[0] or features.shape[1] < 1:
        raise ValueError(f"point_features must be (Q, F) with Q = {points.shape[0]}, "
                         f"got {tuple(features.shape)}")
    if points.dtype != torch.float32 or features.dtype != torch.float32:
        raise ValueError("points and point_features must be float32")
    if points.device != features.device:
        raise ValueError(f"points on {points.device}, features on {features.device}")


def _windows(points, c: GridConsts):
    """Per point and axis the first window index lo and the last kept one
    hi, (Q, 3) int64 each."""
    corner = torch.tensor(c.corner, dtype=torch.float32, device=points.device)
    vs = torch.tensor(c.vs, dtype=torch.float32, device=points.device)
    top = float(c.n - 1)
    lo = torch.floor(((points - c.cr) - corner) / vs).clamp(0.0, top).long()
    hi = torch.ceil(((points + c.cr) - corner) / vs).clamp(0.0, top).long()
    return lo, hi


def _walk(points, c: GridConsts):
    """Yield, chunk by chunk and in the kernels' (x, y, z) window order,
    (the chunk's row slice, flat voxel index, valid, d (3 tensors), r2) of
    every window voxel; ``valid`` marks the kept indices within the
    radius."""
    for s in range(0, points.shape[0], _PLAIN_CHUNK):
        rows = slice(s, s + _PLAIN_CHUNK)
        p = points[rows]
        lo, hi = _windows(p, c)
        for ox in range(c.W):
            ix = lo[:, 0] + ox
            dx = p[:, 0] - (ix.float() * c.vs[0] + c.corner[0])
            for oy in range(c.W):
                iy = lo[:, 1] + oy
                dy = p[:, 1] - (iy.float() * c.vs[1] + c.corner[1])
                for oz in range(c.W):
                    iz = lo[:, 2] + oz
                    dz = p[:, 2] - (iz.float() * c.vs[2] + c.corner[2])
                    r2 = (dx * dx + dy * dy) + dz * dz
                    valid = ((ix <= hi[:, 0]) & (iy <= hi[:, 1]) & (iz <= hi[:, 2])
                             & (r2 <= c.cr2))
                    flat = (ix * c.n + iy) * c.n + iz
                    yield rows, flat, valid, (dx, dy, dz), r2


def voxelize_forward_plain(points, features, c: GridConsts) -> torch.Tensor:
    """Plain PyTorch version of the voxelize forward kernel."""
    _check(points, features)
    vol = torch.zeros(c.n ** 3, dtype=torch.float32, device=points.device)
    dens = features[:, -1]
    for rows, flat, valid, _, r2 in _walk(points, c):
        contrib = torch.exp((-r2) / c.c2k) * dens[rows]
        vol.index_add_(0, flat[valid], contrib[valid])
    return vol.reshape(c.n, c.n, c.n, 1)


def window_spans(points, c: GridConsts):
    """The forward kernel's walk of each point's window (`window_span` in
    csrc/p2v.cu): per axis the kept indices ``[lo, min(hi, lo + W - 1)]``
    cut to those whose offset d has ``d * d <= cr^2``, ``(first (Q, 3),
    last (Q, 3))`` int64, and whether every axis keeps one, (Q,) bool."""
    lo, hi = _windows(points, c)
    top = torch.minimum(hi, lo + (c.W - 1))
    corner = torch.tensor(c.corner, dtype=torch.float32, device=points.device)
    vs = torch.tensor(c.vs, dtype=torch.float32, device=points.device)
    first = top + 1
    last = top.clone()
    for o in range(c.W):
        k = lo + o
        d = points - (k.float() * vs + corner)
        ok = (k <= top) & (d * d <= c.cr2)
        first = torch.where(ok, torch.minimum(first, k), first)
        last = torch.where(ok, k, last)
    return first, last, (first <= last).all(dim=1)


def tile_boxes(points, c: GridConsts, block: int = TILE_BLOCK, cap: int = TILE_FLOATS):
    """The forward kernel's blocks: per block of ``block`` consecutive
    points the box of their spans (`window_spans`; a point with an empty
    span adds nothing), ``(lo (B, 3), top (B, 3))`` int64 (a block with no
    span: top < lo), and whether it fits a tile of ``cap`` voxels, (B,)
    bool."""
    first, last, live = window_spans(points, c)
    Q = points.shape[0]
    B = -(-Q // block)
    pad = B * block - Q
    big = torch.iinfo(torch.int64).max
    first = torch.where(live[:, None], first, big)
    last = torch.where(live[:, None], last, -1)
    box_lo = torch.cat([first, first.new_full((pad, 3), big)]).reshape(B, block, 3).amin(dim=1)
    box_top = torch.cat([last, last.new_full((pad, 3), -1)]).reshape(B, block, 3).amax(dim=1)
    empty = ~torch.cat([live, live.new_zeros(pad)]).reshape(B, block).any(dim=1)
    box_top = torch.where(empty[:, None], box_lo - 1, box_top)
    return box_lo, box_top, (box_top - box_lo + 1).clamp(min=0).prod(dim=1) <= cap


def voxelize_forward_tiled_plain(points, features, c: GridConsts, block: int = TILE_BLOCK,
                                 cap: int = TILE_FLOATS):
    """Plain mirror of the forward kernel's sum order: (volume (n, n, n,
    1), census). A block whose box fits ``cap`` voxels sums its points'
    terms into its tile (shared adds), then adds each non-zero tile voxel
    into the grid (global adds); any other block adds its terms into the
    grid. Terms are the plain version's; the census counts ``blocks``,
    ``tiled`` blocks, ``shared_adds`` and ``global_adds``."""
    _check(points, features)
    dev = points.device
    box_lo, box_top, tiled = tile_boxes(points, c, block, cap)
    dims = (box_top - box_lo + 1).clamp(min=0)
    size = torch.where(tiled, dims.prod(dim=1), 0)
    start = torch.cumsum(size, 0) - size
    tiles = torch.zeros(int(size.sum()), dtype=torch.float32, device=dev)
    vol = torch.zeros(c.n ** 3, dtype=torch.float32, device=dev)
    dens = features[:, -1]
    n2 = c.n * c.n
    shared = direct = 0
    for rows, flat, valid, _, r2 in _walk(points, c):
        contrib = torch.exp((-r2) / c.c2k) * dens[rows]
        b = torch.arange(rows.start, rows.start + flat.shape[0], device=dev) // block
        on_tile = valid & tiled[b]
        off = valid & ~tiled[b]
        ix, iy, iz = flat // n2, (flat // c.n) % c.n, flat % c.n
        d, lo_b = dims[b], box_lo[b]
        local = start[b] + ((ix - lo_b[:, 0]) * d[:, 1] + (iy - lo_b[:, 1])) * d[:, 2] + (iz - lo_b[:, 2])
        tiles.index_add_(0, local[on_tile], contrib[on_tile])
        vol.index_add_(0, flat[off], contrib[off])
        shared += int(on_tile.sum())
        direct += int(off.sum())
    # Each tile's non-zero voxels into the grid, block by block.
    tb = torch.repeat_interleave(torch.arange(tiled.shape[0], device=dev), size)
    e = torch.arange(tiles.shape[0], device=dev) - start[tb]
    d, lo_b = dims[tb], box_lo[tb]
    plane = d[:, 1] * d[:, 2]
    ix, r = lo_b[:, 0] + e // plane, e % plane
    iy, iz = lo_b[:, 1] + r // d[:, 2], lo_b[:, 2] + r % d[:, 2]
    keep = tiles != 0
    vol.index_add_(0, ((ix * c.n + iy) * c.n + iz)[keep], tiles[keep])
    census = dict(blocks=int(tiled.shape[0]), tiled=int(tiled.sum()), shared_adds=shared,
                  global_adds=direct + int(keep.sum()))
    return vol.reshape(c.n, c.n, c.n, 1), census


def voxelize_backward_plain(points, features, c: GridConsts, grad_vol, want_points=True,
                            want_features=True):
    """Plain PyTorch version of the voxelize backward kernel: (d_points
    (Q, 3), d_features (Q, F) zero but in the last column), each None
    where not wanted. Window terms are summed per point in window order,
    as the kernel sums them."""
    _check(points, features)
    Q, F = features.shape
    g_flat = grad_vol.reshape(-1)
    dens = features[:, -1]
    gd = torch.zeros(Q, dtype=torch.float32, device=points.device)
    gp = torch.zeros(Q, 3, dtype=torch.float32, device=points.device)
    for rows, flat, valid, d, r2 in _walk(points, c):
        wt = torch.exp((-r2) / c.c2k)
        g = torch.where(valid, g_flat[torch.where(valid, flat, 0)], 0.0)
        gd[rows] = torch.where(valid, gd[rows] + g * wt, gd[rows])
        u = ((g * dens[rows]) * wt) / c.c2k
        for a in range(3):
            gp[rows, a] = torch.where(valid, gp[rows, a] + -2.0 * (u * d[a]), gp[rows, a])
    d_points = gp if want_points else None
    d_features = None
    if want_features:
        d_features = torch.zeros(Q, F, dtype=torch.float32, device=points.device)
        d_features[:, -1] = gd
    return d_points, d_features


def _check_cuda(points, features, c: GridConsts, name: str) -> None:
    _check(points, features)
    for t in (points, features):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} needs contiguous CUDA tensors")
    if points.shape[0] >= 2 ** 31 or features.numel() >= 2 ** 31 or c.n ** 3 >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^31 points, features and voxels")


def _grid_args(points, features, c: GridConsts):
    return (points.data_ptr(), features.data_ptr(), points.shape[0], features.shape[1],
            (c_float * 3)(*c.corner), (c_float * 3)(*c.vs), c.n, c.W, c.cr, c.cr2, c.c2k)


def voxelize_forward_cuda(points, features, c: GridConsts) -> torch.Tensor:
    """Launch the voxelize forward kernel (csrc/p2v.cu) into a zeroed grid."""
    _check_cuda(points, features, c, "voxelize_forward_cuda")
    dev = points.device
    vol = torch.zeros(c.n ** 3, dtype=torch.float32, device=dev)
    if points.shape[0]:
        VOXELIZE_FWD(*_grid_args(points, features, c), vol.data_ptr(), *_stream(dev))
    return vol.reshape(c.n, c.n, c.n, 1)


def voxelize_tiles_cuda(points, features, c: GridConsts):
    """The forward kernel with its census (`svox_voxelize_fwd_tiles`):
    (volume, the number of blocks that took the shared tile)."""
    _check_cuda(points, features, c, "voxelize_tiles_cuda")
    dev = points.device
    vol = torch.zeros(c.n ** 3, dtype=torch.float32, device=dev)
    tiled = torch.zeros(1, dtype=torch.int32, device=dev)
    if points.shape[0]:
        VOXELIZE_FWD_TILES(*_grid_args(points, features, c), vol.data_ptr(), tiled.data_ptr(),
                           *_stream(dev))
    return vol.reshape(c.n, c.n, c.n, 1), int(tiled.item())


def voxelize_backward_cuda(points, features, c: GridConsts, grad_vol, want_points=True,
                           want_features=True):
    """Launch the voxelize backward kernel (csrc/p2v.cu): (d_points,
    d_features), each None where not wanted."""
    _check_cuda(points, features, c, "voxelize_backward_cuda")
    if (grad_vol.numel() != c.n ** 3 or grad_vol.dtype != torch.float32
            or not grad_vol.is_contiguous() or grad_vol.device != points.device):
        raise ValueError(f"grad_vol must be contiguous float32 with {c.n ** 3} voxels "
                         f"on the points' device")
    Q, F = features.shape
    dev = points.device
    d_points = torch.empty(Q, 3, dtype=torch.float32, device=dev) if want_points else None
    d_features = torch.zeros(Q, F, dtype=torch.float32, device=dev) if want_features else None
    if Q and (want_points or want_features):
        VOXELIZE_BWD(*_grid_args(points, features, c), grad_vol.data_ptr(),
                     None if d_points is None else d_points.data_ptr(),
                     None if d_features is None else d_features.data_ptr(), *_stream(dev))
    return d_points, d_features
