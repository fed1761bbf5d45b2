"""The plain mirror of the forward march's trilinear corner lookups (K2+K4,
`csrc/common.cuh` `corners_keep`, `TreeWalk::corner_row`), and the table
loads they make.

A trilinear sample reads the 8 cells around it on its own leaf's grid
(`render.interp_corners`: ``g = p * cube_sz - 0.5``, ``b = floor(g)``, corner
``(i, j, k)`` at ``(b + (i + 0.5)) / cube_sz`` per axis, clamped). The
kernel's interp march finds them from the sample's own lookup:

  * lever 1: on each axis exactly one of ``b`` and ``b + 1`` is the own cell
    ``floor(p * cube_sz)`` (`own_corner`), so one corner lies in the own leaf
    and takes the own lookup's row;
  * lever 2, on the tree walk: each other corner's cell differs from the
    own one by at most 1 on each axis. With N a power of two its descent
    starts at the own path's node of the first level whose digits part,
    the fraction there ``frac(x * N^m)`` computed at once (exact for such
    N); a corner in the own cell takes the own row. Any other N descends
    from the root.

`corner_lookups` gives the corners' rows (equal to `interp_corners`' bit
for bit) and each sample's table loads as the width-4 kernel makes them
(`render_fwd.cuh` `kCornerReuse`: levers 1 and 2 on the tree walk, lever 1
on a bake), with lever 1 alone and with neither (9 lookups from the root).
Only tests and the smoke's census read it; the march's plain version keeps
`interp_corners`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bake import ROW_BITS, ROW_MASK, BakedTree, _descend_chain, _grid, _is_pow2
from .traversal import clamp_coord

# The levels of the own descent's path the kernel keeps (common.cuh
# `kPathLevels`).
PATH_LEVELS = 16


class CornerLoads(NamedTuple):
    """A batch of samples' corners and the table loads of their lookups."""

    rows: torch.Tensor       # (8, B) int32 corner rows (the structure's, unmasked), corner order
    loads: torch.Tensor      # (B,) int64 loads of the width-4 kernel's lookups (own lookup included)
    lookups: torch.Tensor    # (B,) int64 lookups it makes: the own one and each corner that loads
    loads_own: torch.Tensor  # (B,) int64 loads with lever 1 alone
    loads_root: torch.Tensor  # (B,) int64 loads of 9 lookups from the root


def own_corner(pos: torch.Tensor, cube_sz: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Lever 1: the corner ``4 i + 2 j + k`` of `render.interp_corners` that
    lies in each sample's own cell ``cell`` (B, 3) at its leaf's resolution
    ``cube_sz``: per axis 1 where ``b + 1`` is the own cell, 0 where ``b`` is;
    -1 where on some axis neither is (then every corner is looked up)."""
    g = pos * cube_sz[:, None] - 0.5
    b = torch.floor(g).to(torch.int64)
    c = cell.to(torch.int64)
    up = b + 1 == c
    known = (up | (b == c)).all(-1)
    n = up[:, 0].long() * 4 + up[:, 1].long() * 2 + up[:, 2].long()
    return torch.where(known, n, -1)


def _descend(spec, x, node, start):
    """`traversal.descend`'s loop from level ``start`` (B,) at ``node`` with
    the fraction ``x`` (B, 3): (leaf cell, child loads, the leaf's level
    (n_levels where none is found), the node of each level passed (B,
    n_levels), the leaf's cell at its own resolution, the fraction)."""
    N, child, n_levels = spec.N, spec.child_flat, spec.n_levels
    B, dev = x.shape[0], x.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    leaf = torch.zeros(B, dtype=torch.int64, device=dev)
    loads = torch.zeros(B, dtype=torch.int64, device=dev)
    level = torch.full((B,), n_levels, dtype=torch.int64, device=dev)
    path = torch.zeros(B, n_levels, dtype=torch.int64, device=dev)
    cell = torch.zeros(B, 3, dtype=torch.int64, device=dev)
    node = node.clone()
    for lvl in range(n_levels):
        act = (start <= lvl) & ~done
        path[:, lvl] = torch.where(act, node, path[:, lvl])
        xs = x * N
        uvw = torch.clamp(torch.floor(xs), max=N - 1).long()
        flat = ((node * N + uvw[:, 0]) * N + uvw[:, 1]) * N + uvw[:, 2]
        skip = torch.where(act, child[torch.where(act, flat, 0)].long(), 1)
        term = act & (skip == 0)
        loads += act.long()
        leaf = torch.where(term, flat, leaf)
        level = torch.where(term, lvl, level)
        cell = torch.where(act[:, None], cell * N + uvw, cell)
        x = torch.where(act[:, None], xs - uvw.to(x.dtype), x)
        node = torch.where(act & ~term, node + skip, node)
        done = done | term
    return leaf, loads, level, path, cell, x


def _tree_corners(spec, pos, points, own_n):
    """Rows and loads of a tree walk's corners (`TreeWalk::lookup_keep`,
    `corner_row`)."""
    dev = pos.device
    B = pos.shape[0]
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    own_flat, own_loads, level, path, cell, _ = _descend(spec, clamp_coord(pos), zeros, zeros)
    own_row = spec.data_flat[own_flat]
    own_loads = own_loads + 1
    pow2 = _is_pow2(spec.N)
    L = spec.N.bit_length() - 1
    rows, loads, loads_own, loads_root = [], own_loads.clone(), own_loads.clone(), own_loads.clone()
    lookups = torch.ones_like(own_loads)
    for n, p in enumerate(points):
        X = clamp_coord(p)
        root_flat, root_loads = _descend(spec, X, zeros, zeros)[:2]
        rows.append(spec.data_flat[root_flat])
        loads_root += root_loads + 1
        is_own = own_n == n
        loads_own += torch.where(is_own, 0, root_loads + 1)
        if not pow2:
            loads += torch.where(is_own, 0, root_loads + 1)
            lookups += (~is_own).long()
            continue
        k = torch.ldexp(X, (L * (level + 1))[:, None]).long()
        diff = ((k ^ cell) != 0).any(-1)
        bits = torch.frexp((k ^ cell).double())[1].long().amax(-1)
        m = torch.clamp(level + 1 - (bits + L - 1) // L, min=0, max=PATH_LEVELS - 1)
        node = torch.gather(path, 1, torch.clamp(m, max=spec.n_levels - 1)[:, None])[:, 0]
        xs = torch.ldexp(X, (L * m)[:, None])
        x = xs - torch.floor(xs)
        flat, c_loads = _descend(spec, x, node, m)[:2]
        got = torch.where(diff, spec.data_flat[flat], own_row)
        if not bool((got[~is_own] == rows[-1][~is_own]).all()):
            raise AssertionError("a path-reusing corner descent left the root descent's leaf")
        loads += torch.where(is_own | ~diff, 0, c_loads + 1)
        lookups += (~is_own & diff).long()
    return torch.stack(rows), loads, lookups, loads_own, loads_root, own_row


def _stages(spec: BakedTree, p):
    """Finest-grid cell (B, 3) and top, mid and brick cells of clamped
    points, as `bake.lookup_plain` computes them."""
    N, R, Bk, M1 = spec.N, spec.R, spec.B, spec.M1
    G = _grid(spec)
    D = spec.top_levels + spec.mid_levels + spec.brick_levels
    if _is_pow2(N):
        g = torch.clamp((p * G).to(torch.int32), max=G - 1).long()
    else:
        g = _descend_chain(p, N, D)[0].long()
    t = g // (G // R)
    return g, (t[:, 0] * R + t[:, 1]) * R + t[:, 2], (g // Bk) % M1, g % Bk


def _baked_entry(spec: BakedTree, p):
    """A bake's lookup of clamped points p: (leaf entry, table loads, the
    finest-grid cell)."""
    Bk, M1 = spec.B, spec.M1
    g, top_cell, mid_sub, brick_sub = _stages(spec, p)

    def index(e, sub, S):
        return ((torch.clamp(-e - 1, min=0) * S + sub[:, 0]) * S + sub[:, 1]) * S + sub[:, 2]

    e = spec.top[top_cell].long()
    loads = torch.ones_like(top_cell)
    if spec.mid_levels > 0:
        in_mid = e < 0
        e = torch.where(in_mid, spec.mid[torch.where(in_mid, index(e, mid_sub, M1), 0)].long(), e)
        in_fine = e < 0
        e = torch.where(in_fine, spec.brick[torch.where(in_fine, index(e, brick_sub, Bk), 0)].long(), e)
        loads = loads + in_mid.long() + in_fine.long()
    elif spec.brick_levels > 0:
        in_brick = e < 0
        e = torch.where(in_brick, spec.brick[torch.where(in_brick, index(e, brick_sub, Bk), 0)].long(), e)
        loads = loads + in_brick.long()
    return e, loads, g


def _baked_corners(spec: BakedTree, pos, points, own_n):
    """Rows and loads of a bake's corners (`Baked::lookup_keep`, each other
    corner a `Baked::lookup`): lever 1 alone."""
    e, own_loads, _ = _baked_entry(spec, clamp_coord(pos))
    own_row = (e & ROW_MASK).int()
    rows, loads_own, loads_root = [], own_loads.clone(), own_loads.clone()
    lookups = torch.ones_like(own_loads)
    for n, p in enumerate(points):
        e_root, root_loads, _ = _baked_entry(spec, clamp_coord(p))
        rows.append((e_root & ROW_MASK).int())
        is_own = own_n == n
        loads_root += root_loads
        loads_own += torch.where(is_own, 0, root_loads)
        lookups += (~is_own).long()
    return torch.stack(rows), loads_own, lookups, loads_own, loads_root, own_row


def own_cell(spec, pos: torch.Tensor) -> torch.Tensor:
    """(B, 3) int64: each sample's own cell at its leaf's resolution, as the
    kernel's own lookup keeps it: the descent's per-level floors on the
    tree walk; on a bake the leading depth + 1 digits of the finest-grid
    floor."""
    p = clamp_coord(pos)
    if isinstance(spec, BakedTree):
        e, _, g = _baked_entry(spec, p)
        D = spec.top_levels + spec.mid_levels + spec.brick_levels
        below = spec.N ** (D - 1 - (e >> ROW_BITS))
        return g // below[:, None]
    zeros = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    return _descend(spec, p, zeros, zeros)[4]


def corner_lookups(spec, pos: torch.Tensor, cube_sz: torch.Tensor) -> CornerLoads:
    """The corners of (B, 3) tree-space samples in leaves of ``cube_sz``
    (the own lookup's) as the kernel finds them, and the table loads it
    makes (tree walk: child-table levels plus one data load a lookup; bake:
    top, mid and brick entries). Raises if a reusing lookup leaves the root
    lookup's row."""
    from .render import corner_points

    points, _ = corner_points(pos, cube_sz)
    own_n = own_corner(pos, cube_sz, own_cell(spec, pos))
    corners = _baked_corners if isinstance(spec, BakedTree) else _tree_corners
    rows, loads, lookups, loads_own, loads_root, own_row = corners(spec, pos, points, own_n)
    known = own_n >= 0
    picked = rows[torch.clamp(own_n, min=0), torch.arange(pos.shape[0], device=pos.device)]
    if not bool((picked[known] == own_row[known].to(picked.dtype)).all()):
        raise AssertionError("the own corner's row is not the own leaf's")
    return CornerLoads(rows, loads, lookups, loads_own, loads_root)
