"""Baked render structure, the counterpart of `svox_t_tpu/ops/bake.py`:
a dense top grid plus a brick atlas of packed leaf entries, so that a
sample finds its leaf with at most two or three dependent loads instead
of one per tree level.

  * ``top``: a dense (R^3,) grid at tree level T (R = N^T). An entry
    ``< 0`` encodes a brick id ``-(brick_id + 1)``; otherwise it packs
    the covering leaf's depth and feature row, ``(depth << 27) | row``.
  * ``brick``: (n_bricks * B^3,) packed entries at the finest level, one
    brick per subdivided top cell.
  * ``mid`` (very deep trees): an optional middle stage between the two
    (top entry < 0 -> mid brick; mid entry < 0 -> fine brick).

Cell ids index the concatenation [top, mid, brick]; ``src_map`` maps each
baked cell to the tree cell its row came from (weight accumulation,
`refresh`) and ``depth_parts`` holds its ``depth << 27``. The tables are
flat and unpadded: the JAX package pads each to a row width for the TPU's
gather (`top_width`, `brick_width`), which the card does not need, so a
cell id here differs from the JAX package's and the two are compared
through ``src_map``.

Empty cells pack a row >= the pool size (``EMPTY_ROW``, or a skip-box code
``SKIP_BASE + bits`` whose six 4-bit face extents grow a guaranteed-empty
box around the leaf; only the fast march decodes them). ``aabb_lo`` /
``aabb_hi`` bound the occupied cells; the renderer culls rays against it.

The bake itself (`bake_arrays`, `bake`) is host NumPy, as in the JAX
package. The device ops dispatch on the device of their tensors, as
`ops/query.py` does: on CUDA they launch their kernel (`csrc/bake.cu`,
counted by ``LOOKUP``, ``REFRESH`` and ``GROW_BOXES``) or raise; on the
CPU their plain PyTorch version runs:

  * `lookup`: the baked point lookup (K6); the march kernels carry the
    same lookup as a device function (`csrc/common.cuh`, ``Baked``);
  * `refresh`: re-pack every baked cell's row from a re-pointed index
    table (K7a);
  * `grow_boxes_device`: regrow symmetric skip boxes on the top grid after
    a refresh (K7b).
"""

from __future__ import annotations

import ctypes
import dataclasses
from ctypes import c_int, c_void_p
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from .._build import Kernel
from ..utils.spec import TreeSpec
from .traversal import clamp_coord

ROW_BITS = 27
EMPTY_ROW = (1 << ROW_BITS) - 1
ROW_MASK = EMPTY_ROW

# Skip boxes (fast-mode acceleration): an empty leaf's row is
# SKIP_BASE + bits, bits packing the face extents lo_x, hi_x, lo_y, hi_y,
# lo_z, hi_z (4 bits each, low to high) in units of the leaf's own size.
SKIP_BASE = 1 << 26
_SKIP_EXT_MAX = 15
_SKIP_BITS_SPAN = 1 << 24
# Largest finest grid the host bake grows boxes on ((F+1)^3 int32 sums).
_SKIP_MAX_FINE = 256


class StructureDesc(ctypes.Structure):
    """What a march kernel reads of the structure it walks: the tree's
    tables, or the bake's tables and box (csrc/common.cuh
    ``StructDesc``, field for field)."""

    _fields_ = [
        ("child", c_void_p), ("data", c_void_p), ("N", c_int), ("n_levels", c_int),
        ("top", c_void_p), ("mid", c_void_p), ("brick", c_void_p), ("src_map", c_void_p),
        ("top_levels", c_int), ("mid_levels", c_int), ("brick_levels", c_int),
        ("n_mid", c_int),
        ("aabb_lo", c_void_p), ("aabb_hi", c_void_p),
        ("box_advance", c_int), ("skip_base", c_int),
    ]


LOOKUP = Kernel(
    "svox_bake_lookup",
    [ctypes.POINTER(StructureDesc), c_void_p, c_int,  # structure, points, Q
     c_void_p, c_void_p, c_void_p, c_void_p,          # row, cube, frac, cell
     c_int, c_void_p],                                # device, stream
)
REFRESH = Kernel(
    "svox_bake_refresh",
    [c_void_p, c_void_p, c_void_p,                    # data, src_map, depth_parts
     c_void_p, c_void_p, c_int, c_int, c_int,         # top, mid, n_top, n_mid, n_brick
     c_void_p, c_void_p, c_void_p,                    # top, mid, brick out
     c_int, c_void_p],
)
GROW_BOXES = Kernel(
    "svox_grow_boxes",
    [c_void_p, c_int, c_int,                          # top, R, N
     c_void_p, c_void_p, c_void_p,                    # distance scratch a, b, top out
     c_int, c_void_p],
)


@dataclasses.dataclass(frozen=True)
class BakedTree:
    """Render-optimized octree (see the module docstring).

      top:         (R^3,) int32 packed entries or -(brick_id + 1)
      mid:         (n_mid * M1^3,) int32 or None (two-stage bake)
      brick:       (n_bricks * B^3,) int32 packed entries
      src_map:     (n_cells,) int32 tree cell of each baked cell
      depth_parts: (n_cells,) int32 ``depth << 27`` of each baked cell
      offset, scaling: (3,) float32 world->tree transform
      aabb_lo, aabb_hi: (3,) float32 tree-space box of the occupied cells
        (lo > hi: nothing is occupied)
    The optional per-pool tensors are as in TreeSpec.
    """

    top: torch.Tensor
    brick: torch.Tensor
    src_map: torch.Tensor
    depth_parts: torch.Tensor
    offset: torch.Tensor
    scaling: torch.Tensor
    mid: Optional[torch.Tensor] = None
    extra_data: Optional[torch.Tensor] = None
    transformation_matrices: Optional[torch.Tensor] = None
    skinning_weights: Optional[torch.Tensor] = None
    joint_index: Optional[torch.Tensor] = None
    aabb_lo: Optional[torch.Tensor] = None
    aabb_hi: Optional[torch.Tensor] = None
    N: int = 2
    top_levels: int = 5
    brick_levels: int = 0
    mid_levels: int = 0
    n_tree_cells: int = 0
    skip_base: int = 0
    # Mesh axis of a row-sharded brick atlas: ROADMAP.md §1 item 17.
    brick_axis: Optional[str] = None

    @property
    def R(self) -> int:
        return self.N ** self.top_levels

    @property
    def B(self) -> int:
        return self.N ** self.brick_levels

    @property
    def M1(self) -> int:
        return self.N ** self.mid_levels

    @property
    def n_mid(self) -> int:
        return 0 if self.mid is None else self.mid.numel()

    @property
    def device(self) -> torch.device:
        return self.top.device

    def with_(self, **kw) -> "BakedTree":
        return dataclasses.replace(self, **kw)


def _leaf_cells(child: np.ndarray, parent_depth: np.ndarray, n_internal: int):
    """All leaf cells, breadth first: (corner (L, 3) int64 in finest-grid
    units, depth (L,), tree cell (L,), D = max node depth + 1)."""
    N = child.shape[1]
    max_depth = int(parent_depth[: max(n_internal, 1), 1].max()) if len(parent_depth) else 0
    D = max_depth + 1
    F = N ** D
    cells_corner, cells_depth, cells_src = [], [], []
    nodes = np.array([0], np.int64)
    corners = np.zeros((1, 3), np.int64)
    u, v, w = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    uvw = np.stack([u.ravel(), v.ravel(), w.ravel()], -1)
    child_flat = child.reshape(-1)
    for level in range(D):
        cell_f = F // (N ** (level + 1))
        n = len(nodes)
        all_nodes = np.repeat(nodes, N ** 3)
        tiled_uvw = np.tile(uvw, (n, 1))
        all_corners = np.repeat(corners, N ** 3, axis=0) + tiled_uvw * cell_f
        flat = ((all_nodes * N + tiled_uvw[:, 0]) * N + tiled_uvw[:, 1]) * N + tiled_uvw[:, 2]
        skips = child_flat[flat]
        is_leaf = skips == 0
        cells_corner.append(all_corners[is_leaf])
        cells_depth.append(np.full(int(is_leaf.sum()), level, np.int64))
        cells_src.append(flat[is_leaf])
        nxt = ~is_leaf
        nodes = all_nodes[nxt] + skips[nxt]
        corners = all_corners[nxt]
        if len(nodes) == 0:
            break
    return (np.concatenate(cells_corner), np.concatenate(cells_depth),
            np.concatenate(cells_src), D)


def _paint(atlas, aux, brick_of, corner, span, values, depths, srcs):
    """Paint leaves of ``span`` cells a side into an (n, S, S, S) atlas
    and its (depth, src) companions; ``corner`` in atlas cells relative to
    each brick's origin."""
    a_depth, a_src = aux
    for s in np.unique(span):
        m = span == s
        bi, cs = brick_of[m], corner[m]
        off = np.arange(s)
        ox, oy, oz = (o.ravel() for o in np.meshgrid(off, off, off, indexing="ij"))
        rep = int(s ** 3)
        idx = (np.repeat(bi, rep), (cs[:, 0, None] + ox).ravel(),
               (cs[:, 1, None] + oy).ravel(), (cs[:, 2, None] + oz).ravel())
        atlas[idx] = np.repeat(values[m], rep)
        a_depth[idx] = np.repeat(depths[m], rep)
        a_src[idx] = np.repeat(srcs[m], rep)


def _grow_skip_boxes(rows, corners, depths, N, F):
    """Grow each empty leaf's guaranteed-empty box (greedy, round robin,
    one leaf size per face per round, at most _SKIP_EXT_MAX); emptiness
    is checked on a summed-area table of the occupied finest cells, and
    space outside the cube counts as empty. Returns the packed rows."""
    empty = rows == EMPTY_ROW
    occ = ~empty
    if not (empty.any() and occ.any()):
        return rows
    size = (F // (N ** (depths + 1))).astype(np.int64)
    grid = np.zeros((1, F, F, F), np.uint8)
    n_occ = int(occ.sum())
    _paint(grid, (np.zeros_like(grid), np.zeros_like(grid)), np.zeros(n_occ, np.int64),
           corners[occ], size[occ], np.ones(n_occ, np.uint8), np.zeros(n_occ, np.uint8),
           np.zeros(n_occ, np.uint8))
    sat = np.zeros((F + 1, F + 1, F + 1), np.int32)
    sat[1:, 1:, 1:] = grid[0]
    np.cumsum(sat, axis=0, out=sat)
    np.cumsum(sat, axis=1, out=sat)
    np.cumsum(sat, axis=2, out=sat)

    def box_count(lo, hi):
        lo = np.clip(lo, 0, F)
        hi = np.maximum(np.clip(hi, 0, F), lo)
        x0, y0, z0 = lo[:, 0], lo[:, 1], lo[:, 2]
        x1, y1, z1 = hi[:, 0], hi[:, 1], hi[:, 2]
        return (sat[x1, y1, z1] - sat[x0, y1, z1] - sat[x1, y0, z1]
                - sat[x1, y1, z0] + sat[x0, y0, z1] + sat[x0, y1, z0]
                + sat[x1, y0, z0] - sat[x0, y0, z0])

    es = size[empty]
    lo = corners[empty].copy()
    hi = lo + es[:, None]
    ext_lo = np.zeros((len(es), 3), np.int64)
    ext_hi = np.zeros((len(es), 3), np.int64)
    for _ in range(_SKIP_EXT_MAX):
        grew = False
        for axis in range(3):
            c_lo, c_hi = lo.copy(), hi.copy()
            c_lo[:, axis] = hi[:, axis]
            c_hi[:, axis] = hi[:, axis] + es
            ok = (box_count(c_lo, c_hi) == 0) & (ext_hi[:, axis] < _SKIP_EXT_MAX)
            hi[ok, axis] += es[ok]
            ext_hi[ok, axis] += 1
            grew = grew or bool(ok.any())

            c_lo, c_hi = lo.copy(), hi.copy()
            c_hi[:, axis] = lo[:, axis]
            c_lo[:, axis] = lo[:, axis] - es
            ok = (box_count(c_lo, c_hi) == 0) & (ext_lo[:, axis] < _SKIP_EXT_MAX)
            lo[ok, axis] -= es[ok]
            ext_lo[ok, axis] += 1
            grew = grew or bool(ok.any())
        if not grew:
            break
    bits = (ext_lo[:, 0] | (ext_hi[:, 0] << 4) | (ext_lo[:, 1] << 8)
            | (ext_hi[:, 1] << 12) | (ext_lo[:, 2] << 16) | (ext_hi[:, 2] << 20))
    rows = rows.copy()
    rows[empty] = SKIP_BASE + bits
    return rows


def _atlas(n, S):
    """An (n, S, S, S) atlas of empty entries with its depth and src
    companions."""
    shape = (n, S, S, S)
    return (np.full(shape, EMPTY_ROW, np.int64),
            (np.zeros(shape, np.int64), np.zeros(shape, np.int64)))


def bake_arrays(child, data, parent_depth, offset, scaling, n_internal: int,
                extra_data=None, transformation_matrices=None,
                top_levels: Optional[int] = None, mid_levels: Optional[int] = None,
                skip_boxes: bool = True, device="cpu") -> BakedTree:
    """Bake from host (capacity, N, N, N[, 1]) arrays; the tables land on
    ``device``.

    ``top_levels`` defaults to the deepest level whose grid has at most
    2^21 cells (2^18 for trees of depth >= 9); bricks take the levels
    below, at most three, and a middle stage any further ones.
    ``skip_boxes`` packs skip boxes into the empty cells (only the fast
    march reads them); they are left out for a finest grid above
    _SKIP_MAX_FINE^3 and for pools whose rows reach SKIP_BASE."""
    child = np.asarray(child)
    N = child.shape[1]
    data_flat = np.asarray(data).reshape(-1).astype(np.int64)
    parent_depth = np.asarray(parent_depth)
    corners, depths, srcs, D = _leaf_cells(child, parent_depth, n_internal)
    if top_levels is None:
        cap_cells = 2 ** 18 if D >= 9 else 2 ** 21
        top_levels = D
        while (N ** top_levels) ** 3 > cap_cells:
            top_levels -= 1
    top_levels = min(top_levels, D)
    brick_total = D - top_levels
    if mid_levels is None:
        fine_levels = min(brick_total, 3)
        mid_levels = brick_total - fine_levels
    else:
        mid_levels = max(0, min(int(mid_levels), brick_total))
        fine_levels = brick_total - mid_levels
    brick_levels = fine_levels
    R, M1, B, F = N ** top_levels, N ** mid_levels, N ** brick_levels, N ** D

    rows = np.minimum(data_flat[srcs], EMPTY_ROW).astype(np.int64)
    rows = np.where(rows < 0, EMPTY_ROW, rows)
    occ = rows < EMPTY_ROW  # before skip boxes re-code the empty rows
    skip_base = 0
    if skip_boxes and F <= _SKIP_MAX_FINE and (not occ.any() or int(rows[occ].max()) < SKIP_BASE):
        skip_base = SKIP_BASE
        if occ.any() and (~occ).any():
            rows = _grow_skip_boxes(rows, corners, depths, N, F)
    packed = (depths.astype(np.int64) << ROW_BITS) | rows
    if occ.any():
        size_occ = (F // (N ** (depths[occ] + 1)))[:, None]
        aabb_lo = (corners[occ].min(axis=0) / F).astype(np.float32)
        aabb_hi = ((corners[occ] + size_occ).max(axis=0) / F).astype(np.float32)
    else:
        aabb_lo = np.ones(3, np.float32)  # an inverted box culls every ray
        aabb_hi = np.zeros(3, np.float32)

    top, top_aux = _atlas(1, R)
    top_cell_f = F // R
    corner_top = corners // top_cell_f
    shallow = depths < top_levels
    deep = ~shallow
    _paint(top, top_aux, np.zeros(int(shallow.sum()), np.int64), corner_top[shallow],
           (R // (N ** (depths[shallow] + 1))).astype(np.int64),
           packed[shallow], depths[shallow], srcs[shallow])
    size_f = (F // (N ** (depths[deep] + 1))).astype(np.int64)
    c_top = corner_top[deep]
    top_key = (c_top[:, 0] * R + c_top[:, 1]) * R + c_top[:, 2]
    mid = mid_aux = brick = brick_aux = None
    if mid_levels > 0 and deep.any():
        uniq, mid_of = np.unique(top_key, return_inverse=True)
        top.reshape(-1)[uniq] = -(np.arange(len(uniq), dtype=np.int64) + 1)
        mid, mid_aux = _atlas(len(uniq), M1)
        mcf = F // (R * M1)  # finest cells per mid cell
        corner_in_top = corners[deep] % top_cell_f
        midc = corner_in_top // mcf
        middle = depths[deep] < top_levels + mid_levels
        if middle.any():
            _paint(mid, mid_aux, mid_of[middle], midc[middle], size_f[middle] // mcf,
                   packed[deep][middle], depths[deep][middle], srcs[deep][middle])
        fine = ~middle
        if fine.any():
            fine_key = mid_of[fine] * (M1 ** 3) + (midc[fine][:, 0] * M1 + midc[fine][:, 1]) * M1 \
                + midc[fine][:, 2]
            uniq_f, fine_of = np.unique(fine_key, return_inverse=True)
            mid.reshape(-1)[uniq_f] = -(np.arange(len(uniq_f), dtype=np.int64) + 1)
            brick, brick_aux = _atlas(len(uniq_f), B)
            _paint(brick, brick_aux, fine_of, corner_in_top[fine] % mcf, size_f[fine],
                   packed[deep][fine], depths[deep][fine], srcs[deep][fine])
    elif brick_levels > 0 and deep.any():
        uniq, brick_of = np.unique(top_key, return_inverse=True)
        top.reshape(-1)[uniq] = -(np.arange(len(uniq), dtype=np.int64) + 1)
        brick, brick_aux = _atlas(len(uniq), B)
        _paint(brick, brick_aux, brick_of, corners[deep] % top_cell_f, size_f,
               packed[deep], depths[deep], srcs[deep])
    if brick is None:
        brick, brick_aux = _atlas(1, B)
    if mid_levels > 0 and mid is None:
        mid, mid_aux = _atlas(1, M1)

    segs = [(top, top_aux)] + ([] if mid is None else [(mid, mid_aux)]) + [(brick, brick_aux)]
    src_map = np.concatenate([aux[1].reshape(-1) for _, aux in segs])
    depth_parts = np.concatenate([aux[0].reshape(-1) for _, aux in segs]) << ROW_BITS

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a.reshape(-1), np.int32), device=device)

    def f32(a):
        return None if a is None else torch.as_tensor(np.array(a, np.float32), device=device)

    return BakedTree(
        top=i32(top), brick=i32(brick), mid=None if mid is None else i32(mid),
        src_map=i32(src_map), depth_parts=i32(depth_parts),
        offset=f32(offset), scaling=f32(scaling), extra_data=f32(extra_data),
        transformation_matrices=f32(transformation_matrices),
        aabb_lo=f32(aabb_lo), aabb_hi=f32(aabb_hi),
        N=N, top_levels=int(top_levels), brick_levels=int(brick_levels),
        mid_levels=int(mid_levels), n_tree_cells=int(child.size), skip_base=int(skip_base),
    )


def bake(spec: TreeSpec, top_levels: Optional[int] = None, mid_levels: Optional[int] = None,
         skip_boxes: bool = True) -> BakedTree:
    """Bake a TreeSpec (its tables come to the host first); the bake
    lands on the spec's device."""
    N = spec.N

    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    return bake_arrays(
        host(spec.child_flat).reshape(-1, N, N, N), host(spec.data_flat),
        host(spec.parent_depth), host(spec.offset), host(spec.scaling), spec.n_internal,
        extra_data=host(spec.extra_data),
        transformation_matrices=host(spec.transformation_matrices),
        top_levels=top_levels, mid_levels=mid_levels, skip_boxes=skip_boxes,
        device=spec.device,
    )


# ---------------------------------------------------------------------------
# K6: the baked point lookup


def _is_pow2(N: int) -> bool:
    return N & (N - 1) == 0


def _descend_chain(p, N: int, D: int):
    """The descent's per-level arithmetic on (B, 3) points, D levels:
    (finest-grid cell g (B, 3) int32, [in-leaf fraction after level d+1
    for d < D]). Non-power-of-two N takes this path so that floors and
    fractions are the tree walk's bit for bit."""
    x = p
    g = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    fracs = []
    for _ in range(D):
        xs = x * N
        u = torch.clamp(torch.floor(xs), max=N - 1).to(torch.int32)
        x = xs - u.to(p.dtype)
        g = g * N + u
        fracs.append(x)
    return g, fracs


def lookup(baked: BakedTree, pos: torch.Tensor):
    """Locate the leaves of (B, 3) tree-space points.

    :return: (data_idx (B,) int32, cube_sz (B,) float32 = N^(depth+1),
        frac (B, 3) float32 in-leaf fraction, cell_id (B,) int32 baked
        cell, usable with ``src_map``), the semantics of
        `traversal.descend`.
    """
    if pos.is_cuda:
        return lookup_cuda(baked, pos)
    return lookup_plain(baked, pos)


def _check_baked(baked: BakedTree) -> None:
    if baked.brick_axis is not None:
        raise NotImplementedError("a sharded brick atlas waits for ROADMAP.md §1 item 17")


def _grid(baked: BakedTree) -> int:
    """Cells a side of the finest grid the lookup floors to."""
    return baked.R * baked.M1 * baked.B


def lookup_plain(baked: BakedTree, pos: torch.Tensor):
    """Plain PyTorch version of the lookup kernel (K6): one finest-grid
    floor per axis, the stage indices by integer division from it."""
    _check_baked(baked)
    N, R, Bk, M1 = baked.N, baked.R, baked.B, baked.M1
    n_top = baked.top.numel()
    p = clamp_coord(pos)
    G = _grid(baked)
    D = baked.top_levels + baked.mid_levels + baked.brick_levels
    if _is_pow2(N):
        fracs = None
        g = torch.clamp((p * G).to(torch.int32), max=G - 1)
    else:
        g, fracs = _descend_chain(p, N, D)
    cell = g // (G // R)
    cell_id = (cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]
    e = baked.top[cell_id.long()]

    def brick_index(bid, sub, S):
        return ((torch.clamp(bid, min=0) * S + sub[:, 0]) * S + sub[:, 1]) * S + sub[:, 2]

    if baked.mid_levels > 0:
        in_mid = e < 0
        m_idx = brick_index(-e - 1, (g // Bk) % M1, M1)
        e = torch.where(in_mid, baked.mid[m_idx.long()], e)
        cell_id = torch.where(in_mid, n_top + m_idx, cell_id)
        in_fine = e < 0
        f_idx = brick_index(-e - 1, g % Bk, Bk)
        e = torch.where(in_fine, baked.brick[f_idx.long()], e)
        cell_id = torch.where(in_fine, n_top + baked.n_mid + f_idx, cell_id)
    elif baked.brick_levels > 0:
        in_brick = e < 0
        b_idx = brick_index(-e - 1, g % Bk, Bk)
        e = torch.where(in_brick, baked.brick[b_idx.long()], e)
        cell_id = torch.where(in_brick, n_top + b_idx, cell_id)

    depth = (e >> ROW_BITS).long()
    data_idx = e & ROW_MASK
    if fracs is not None:
        cubes = torch.tensor([float(N ** (d + 1)) for d in range(D)], dtype=p.dtype,
                             device=p.device)
        cube_sz = cubes[depth]
        frac = torch.stack(fracs)[depth, torch.arange(p.shape[0], device=p.device)]
        return data_idx, cube_sz, frac, cell_id.to(torch.int32)
    # Power-of-two N: N^(depth+1) and p * cube - floor are exact, so the
    # one-shot fraction is the descent's iterated one.
    cube_sz = torch.ones_like(depth).bitwise_left_shift((depth + 1) * (N.bit_length() - 1))
    cube_sz = cube_sz.to(p.dtype)
    scaled = p * cube_sz[:, None]
    return data_idx, cube_sz, scaled - torch.floor(scaled), cell_id.to(torch.int32)


def structure_desc(spec, box_advance: int = 0, skip_base: int = 0) -> StructureDesc:
    """The kernel descriptor of a TreeSpec or a BakedTree. The box and
    the skip codes are read by baked kernels only."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if isinstance(spec, BakedTree):
        return StructureDesc(
            N=spec.N, top=ptr(spec.top), mid=ptr(spec.mid), brick=ptr(spec.brick),
            src_map=ptr(spec.src_map), top_levels=spec.top_levels,
            mid_levels=spec.mid_levels, brick_levels=spec.brick_levels, n_mid=spec.n_mid,
            aabb_lo=ptr(spec.aabb_lo), aabb_hi=ptr(spec.aabb_hi),
            box_advance=int(box_advance), skip_base=int(skip_base),
        )
    return StructureDesc(child=ptr(spec.child_flat), data=ptr(spec.data_flat), N=spec.N,
                         n_levels=spec.n_levels)


def check_structure(spec, dev: torch.device, name: str) -> None:
    """Devices, types and layouts of the tables a kernel reads of a
    TreeSpec or a BakedTree."""
    if isinstance(spec, BakedTree):
        ints = [spec.top, spec.brick, spec.src_map] + ([] if spec.mid is None else [spec.mid])
        floats = [spec.offset, spec.scaling, spec.aabb_lo, spec.aabb_hi]
    else:
        ints, floats = [spec.child_flat, spec.data_flat], [spec.offset, spec.scaling]
    for t, dtype in [(t, torch.int32) for t in ints] + [(t, torch.float32) for t in floats]:
        if t is None or not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} needs all tensors on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous int32 tables and float32 "
                             "offset, scaling and box")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} takes tables of fewer than 2^31 entries")


def _stream(dev: torch.device):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def lookup_cuda(baked: BakedTree, pos: torch.Tensor):
    """Launch the lookup kernel (csrc/bake.cu)."""
    _check_baked(baked)
    if pos.dtype != torch.float32 or pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"points must be (Q, 3) float32, got {tuple(pos.shape)} {pos.dtype}")
    if not pos.is_cuda:
        raise ValueError("lookup_cuda needs the points on a CUDA device")
    check_structure(baked, pos.device, "lookup_cuda")
    pos = pos.contiguous()
    Q = pos.shape[0]
    dev = pos.device
    row = torch.empty(Q, dtype=torch.int32, device=dev)
    cube = torch.empty(Q, dtype=torch.float32, device=dev)
    frac = torch.empty(Q, 3, dtype=torch.float32, device=dev)
    cell = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return row, cube, frac, cell
    desc = structure_desc(baked)
    LOOKUP(ctypes.byref(desc), pos.data_ptr(), Q, row.data_ptr(), cube.data_ptr(),
           frac.data_ptr(), cell.data_ptr(), *_stream(dev))
    return row, cube, frac, cell


# ---------------------------------------------------------------------------
# K7a: refresh


def _box(baked: BakedTree, aabb_lo, aabb_hi):
    if (aabb_lo is None) != (aabb_hi is None):
        raise ValueError("pass both aabb_lo and aabb_hi, or neither")
    if aabb_lo is None:
        # With no box the cull conservatively covers the whole cube.
        aabb_lo, aabb_hi = torch.zeros(3), torch.ones(3)
    f32 = dict(dtype=torch.float32, device=baked.device)
    return (torch.as_tensor(aabb_lo, **f32).contiguous(),
            torch.as_tensor(aabb_hi, **f32).contiguous())


def refresh(baked: BakedTree, data_flat: torch.Tensor, aabb_lo=None, aabb_hi=None) -> BakedTree:
    """Re-pack every baked cell's row from a re-pointed index table
    (structure unchanged): ``depth_parts | clamp(data_flat[src_map])``,
    brick pointers kept. Skip-box codes degrade to EMPTY_ROW.

    Re-pointing can occupy cells outside the old box: pass the new box
    (`N3Tree.construct_tree` passes the union of the old box and the
    points' leaf box); without one the box covers the whole cube."""
    if data_flat.is_cuda:
        return refresh_cuda(baked, data_flat, aabb_lo, aabb_hi)
    return refresh_plain(baked, data_flat, aabb_lo, aabb_hi)


def _check_refresh(baked: BakedTree, data_flat: torch.Tensor) -> None:
    if baked.brick_axis is not None:
        raise ValueError("refresh() needs the global bake, not a sharded one")
    if data_flat.ndim != 1 or data_flat.numel() != baked.n_tree_cells:
        raise ValueError(f"data_flat must be ({baked.n_tree_cells},), got {tuple(data_flat.shape)}")
    if data_flat.device != baked.device:
        raise ValueError(f"data_flat on {data_flat.device}, bake on {baked.device}")


def refresh_plain(baked: BakedTree, data_flat: torch.Tensor, aabb_lo=None,
                  aabb_hi=None) -> BakedTree:
    """Plain PyTorch version of the refresh kernel (K7a)."""
    _check_refresh(baked, data_flat)
    rows = torch.clamp(data_flat[baked.src_map.long()], max=EMPTY_ROW)
    rows = torch.where(rows < 0, EMPTY_ROW, rows)
    packed = baked.depth_parts | rows
    n_top, n_mid = baked.top.numel(), baked.n_mid
    top = torch.where(baked.top < 0, baked.top, packed[:n_top])
    mid = None if baked.mid is None else torch.where(
        baked.mid < 0, baked.mid, packed[n_top:n_top + n_mid])
    lo, hi = _box(baked, aabb_lo, aabb_hi)
    return baked.with_(top=top, mid=mid, brick=packed[n_top + n_mid:], aabb_lo=lo, aabb_hi=hi)


def refresh_cuda(baked: BakedTree, data_flat: torch.Tensor, aabb_lo=None,
                 aabb_hi=None) -> BakedTree:
    """Launch the refresh kernel (csrc/bake.cu): one thread per baked
    cell."""
    _check_refresh(baked, data_flat)
    dev = data_flat.device
    check_structure(baked, dev, "refresh_cuda")
    for t in (data_flat, baked.depth_parts):
        if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError("refresh_cuda needs contiguous int32 CUDA tables")
    top = torch.empty_like(baked.top)
    mid = None if baked.mid is None else torch.empty_like(baked.mid)
    brick = torch.empty_like(baked.brick)
    REFRESH(data_flat.data_ptr(), baked.src_map.data_ptr(), baked.depth_parts.data_ptr(),
            baked.top.data_ptr(), None if mid is None else baked.mid.data_ptr(),
            top.numel(), baked.n_mid, brick.numel(), top.data_ptr(),
            None if mid is None else mid.data_ptr(), brick.data_ptr(), *_stream(dev))
    lo, hi = _box(baked, aabb_lo, aabb_hi)
    return baked.with_(top=top, mid=mid, brick=brick, aabb_lo=lo, aabb_hi=hi)


# ---------------------------------------------------------------------------
# K7b: skip-box regrowth


def grow_boxes_device(baked: BakedTree) -> BakedTree:
    """Regrow symmetric skip boxes on the top grid (after `refresh`).

    _SKIP_EXT_MAX rounds of a 3^3 dilation of the top cells' occupancy
    (a brick pointer or a row < SKIP_BASE; outside the cube is empty) give
    each cell the largest e such that every top cell within Chebyshev
    distance e is empty. An empty in-top leaf of s top cells a side then
    packs the extent floor((e - s + 1) / s), clipped to [0, 15], in all
    six nibbles. Brick cells keep their plain sentinels. A no-op for a
    bake without skip coding (``skip_base == 0``)."""
    if baked.top.is_cuda:
        return grow_boxes_cuda(baked)
    return grow_boxes_plain(baked)


def grow_boxes_plain(baked: BakedTree) -> BakedTree:
    """Plain PyTorch version of the regrowth kernel (K7b)."""
    if not baked.skip_base:
        return baked
    R, N = baked.R, baked.N
    e = baked.top
    occupied = (e < 0) | ((e & ROW_MASK) < SKIP_BASE)
    dil = occupied.reshape(1, 1, R, R, R).to(torch.float32)
    e_map = torch.zeros(R ** 3, dtype=torch.int64, device=e.device)
    for _ in range(_SKIP_EXT_MAX):
        dil = nnf.max_pool3d(dil, 3, stride=1, padding=1)
        e_map = e_map + (dil.reshape(-1) == 0).long()
    depth = torch.clamp(e, min=0) >> ROW_BITS
    cube = torch.pow(torch.full_like(depth, N, dtype=torch.int64), depth.long() + 1)
    s = torch.clamp(R // torch.clamp(cube, min=1), min=1)
    ext = torch.clamp(torch.div(e_map - (s - 1), s, rounding_mode="floor"), 0, _SKIP_EXT_MAX)
    code = (SKIP_BASE + ext * 0x111111).to(torch.int32)
    new = torch.where(~occupied & (ext > 0), (e & ~ROW_MASK) | code, e)
    return baked.with_(top=new)


def grow_boxes_cuda(baked: BakedTree) -> BakedTree:
    """Launch the regrowth kernels (csrc/bake.cu): the top cells'
    Chebyshev distance to the occupied ones in three separable passes,
    then the pack."""
    if not baked.skip_base:
        return baked
    dev = baked.device
    if not (baked.top.is_cuda and baked.top.dtype == torch.int32 and baked.top.is_contiguous()):
        raise ValueError("grow_boxes_cuda needs a contiguous int32 top table on a CUDA device")
    dist = torch.empty(2, baked.top.numel(), dtype=torch.uint8, device=dev)
    top = torch.empty_like(baked.top)
    GROW_BOXES(baked.top.data_ptr(), baked.R, baked.N, dist[0].data_ptr(), dist[1].data_ptr(),
               top.data_ptr(), *_stream(dev))
    return baked.with_(top=top)
