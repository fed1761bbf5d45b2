"""The plain mirror of the first-hit march's path-started lookups (K9b,
`tools/first_hit_designs.cuh` `lookup_next`, `tools/first_hit_ab.py`'s
``path`` design), and the census of the table loads K9b's lookups make.

A march's consecutive samples lie in neighbouring leaves (a step ends just
past its leaf's exit), whose root-to-leaf paths agree down to the last
level or two. The ``path`` design starts each sample's descent on the
previous sample's path: for N a power of two, a point whose cell at the
previous leaf's resolution is the previous one lies in that leaf (its row
and cube size with no load, the fraction ``frac(p * cube_sz)``); any other
starts at the previous path's node of the first level ``m`` at which their
cells' digits part, the fraction there ``frac(p * N^m)`` computed at once
(the descent's steps are exact for such N). Any other N descends from the
root. It makes 1.8x fewer loads on the deep camera and still lost to the
root descent on the card (the loads it saves are the top levels' L1 hits;
PERF.md §6), so the shipped kernel descends from the root.

`path_lookup` is that lookup for a batch of points, each with the state its
ray's previous sample left (`PathState`); it equals `traversal.descend` bit
for bit (leaf, cube size, fraction) and raises where it does not.
`first_hit_census` marches as `render_aux.first_hit_plain` does and counts,
per sample, the loads of a root descent and of the path-started one; on a
bake, how often the next sample stays in the previous one's top cell and
mid brick (the ``top`` design's reuse); under interp, the lookups and loads
of `sample_corners` (9 from the root) against the shipped kernel's
`corners_keep` (`ops/corner_lookup.py`). Only tests, the smoke's census line
and `tools/first_hit_ab.py` read it; the march's plain version keeps
`traversal.descend` and `bake.lookup_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import corner_lookup
from .bake import BakedTree, _is_pow2
from .render import _ray_setup, sample_position
from .render_aux import _sample, first_hit_plain
from .traversal import LeafInfo, clamp_coord, descend

# The levels of the path the kernel keeps (common.cuh `kPathLevels`).
PATH_LEVELS = corner_lookup.PATH_LEVELS
# Widest cell (bits a side) the kernel's digit compare takes.
MAX_CELL_BITS = 30


class PathState(NamedTuple):
    """What a ray's previous lookup kept: its leaf's cell at its own
    resolution (B, 3), its level (n_levels: none, or no leaf found), the
    node of each level it passed (B, n_levels), its leaf cell, row and cube
    size."""

    cell: torch.Tensor
    level: torch.Tensor
    path: torch.Tensor
    flat: torch.Tensor
    row: torch.Tensor
    cube: torch.Tensor


def _descend_from(spec, x, node, start, cell):
    """The descent's loop from level ``start`` (B,) at ``node`` with the
    fraction ``x`` (B, 3) and the cell's digits above ``start`` ``cell``:
    (leaf cell, child loads, level, path (levels >= start), cell, fraction,
    cube size)."""
    N, child, n_levels = spec.N, spec.child_flat, spec.n_levels
    B, dev = x.shape[0], x.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    leaf = torch.zeros(B, dtype=torch.int64, device=dev)
    loads = torch.zeros(B, dtype=torch.int64, device=dev)
    level = torch.full((B,), n_levels, dtype=torch.int64, device=dev)
    path = torch.zeros(B, n_levels, dtype=torch.int64, device=dev)
    cube = torch.pow(torch.full((B,), float(N), dtype=x.dtype, device=dev), (start + 1).to(x.dtype))
    node, cell = node.clone(), cell.clone()
    for lvl in range(n_levels):
        act = (start <= lvl) & ~done
        path[:, lvl] = torch.where(act, node, path[:, lvl])
        xs = x * N
        uvw = torch.clamp(torch.floor(xs), max=N - 1).long()
        flat = ((node * N + uvw[:, 0]) * N + uvw[:, 1]) * N + uvw[:, 2]
        skip = torch.where(act, child[torch.where(act, flat, 0)].long(), 1)
        term = act & (skip == 0)
        cont = act & ~term
        loads += act.long()
        leaf = torch.where(term, flat, leaf)
        level = torch.where(term, lvl, level)
        cell = torch.where(act[:, None], cell * N + uvw, cell)
        x = torch.where(act[:, None], xs - uvw.to(x.dtype), x)
        node = torch.where(cont, node + skip, node)
        cube = torch.where(cont, cube * N, cube)
        done = done | term
    return leaf, loads, level, path, cell, x, cube


def path_lookup(spec, pos: torch.Tensor, state: Optional[PathState] = None):
    """The leaves of (B, 3) tree-space points as the tree walk's first hit
    finds them (`TreeWalk::lookup_next`), each descent started on the path
    of ``state`` (None: from the root): (LeafInfo, table loads (B,): child
    levels and the data load, 0 for a point in the previous leaf, the new
    PathState). Raises where a leaf, cube size or fraction differs from
    `traversal.descend`'s."""
    N, n_levels = spec.N, spec.n_levels
    X = clamp_coord(pos)
    B, dev = X.shape[0], X.device
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    start, node, cell0, x = zeros, zeros, torch.zeros(B, 3, dtype=torch.int64, device=dev), X
    same = torch.zeros(B, dtype=torch.bool, device=dev)
    old_path = torch.zeros(B, n_levels, dtype=torch.int64, device=dev)
    L = N.bit_length() - 1
    if state is not None and _is_pow2(N):
        old_path = state.path
        sh = L * (state.level + 1)
        reuse = (state.level < n_levels) & (sh <= MAX_CELL_BITS)
        k = torch.ldexp(X, torch.where(reuse, sh, 0)[:, None].to(X.dtype)).long()
        xor = k ^ state.cell
        same = reuse & (xor == 0).all(-1)
        bits = torch.frexp(xor.double())[1].long().amax(-1)
        m = torch.clamp(state.level + 1 - (bits + L - 1) // L, min=0, max=PATH_LEVELS - 1)
        part = reuse & ~same
        start = torch.where(part, m, 0)
        node = torch.where(part, torch.gather(state.path, 1, torch.clamp(start, max=n_levels - 1)[:, None])[:, 0], 0)
        xs = torch.ldexp(X, (L * start)[:, None].to(X.dtype))
        x = torch.where(part[:, None], xs - torch.floor(xs), X)
        cell0 = torch.where(part[:, None], k >> (L * (state.level + 1 - start))[:, None], 0)
    flat, loads, level, path, cell, frac, cube = _descend_from(spec, x, node, start, cell0)
    lvls = torch.arange(n_levels, device=dev)
    path = torch.where(lvls[None, :] < start[:, None], old_path, path)
    row = spec.data_flat[flat].long()
    loads = loads + 1
    if state is not None:
        flat = torch.where(same, state.flat, flat)
        row = torch.where(same, state.row, row)
        cube = torch.where(same, state.cube, cube)
        s = X * cube[:, None]
        frac = torch.where(same[:, None], s - torch.floor(s), frac)
        level = torch.where(same, state.level, level)
        cell = torch.where(same[:, None], state.cell, cell)
        path = torch.where(same[:, None], state.path, path)
        loads = torch.where(same, 0, loads)
    root = descend(spec, pos)
    if not (torch.equal(flat.int(), root.node_flat) and torch.equal(cube, root.cube_sz)
            and torch.equal(frac, root.frac)):
        raise AssertionError("a path-started descent left the root descent's leaf")
    leaf = LeafInfo(data_idx=row.int(), node_flat=flat.int(), cube_sz=cube, frac=frac)
    return leaf, loads, PathState(cell, level, path, flat, row, cube)


def _root_loads(spec, pos):
    """Table loads of a root lookup: the descent's child levels and its data
    load (tree walk), or the top, mid and brick entries (bake); and on a bake
    the point's top cell and mid cell (-1: no mid entry)."""
    p = clamp_coord(pos)
    if isinstance(spec, BakedTree):
        e, loads, g = corner_lookup._baked_entry(spec, p)
        _, top_cell, mid_sub, _ = corner_lookup._stages(spec, p)
        e_top = spec.top[top_cell].long()
        if spec.mid_levels > 0:
            M1 = spec.M1
            mid_cell = ((torch.clamp(-e_top - 1, min=0) * M1 + mid_sub[:, 0]) * M1 + mid_sub[:, 1]) * M1 + mid_sub[:, 2]
            mid_cell = torch.where(e_top < 0, mid_cell, -1)
        else:
            mid_cell = torch.full_like(top_cell, -1)
        return loads, top_cell, mid_cell
    B = p.shape[0]
    zeros = torch.zeros(B, dtype=torch.int64, device=p.device)
    loads = corner_lookup._descend(spec, p, zeros, zeros)[1] + 1
    return loads, None, None


def first_hit_census(spec, features, origins: torch.Tensor, dirs: torch.Tensor, opt) -> dict:
    """What K9b's march makes on these rays (the samples `first_hit_plain`
    takes, up to each ray's first resident hit): ``samples``; ``root_loads``,
    the table loads of their own lookups from the root; on the tree walk
    ``path_loads``, those of the path-started lookups (N a power of two; else
    the root's) and ``same_leaf``, the samples in their previous sample's
    leaf; on a bake ``same_top`` and ``same_mid``, the samples whose top cell
    (mid cell) is the previous sample's, and ``trail_loads``, the loads with
    those entries taken again. Under interp, ``lookups_9`` (9 a sample from
    the root) and ``loads_9`` against ``lookups_keep`` and ``loads_keep``, the
    lookups of the shipped kernel: the own one from the root and the
    corners as `corners_keep` finds them (`ops/corner_lookup.py`: levers 1
    and 2 on the tree walk, lever 1 on a bake). Checks itself: every
    path-started lookup equals the root's (`path_lookup`), and the march's
    hits equal `first_hit_plain`'s."""
    baked = isinstance(spec, BakedTree)
    rays = _ray_setup(spec, origins, dirs, opt)
    o, d, _, _, tmin, tmax, hit = rays
    M = features.shape[0]
    dev = origins.device
    names = ("samples", "root_loads", "path_loads", "same_leaf", "same_top", "same_mid", "trail_loads",
             "lookups_9", "loads_9", "lookups_keep", "loads_keep")
    n = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in names}
    B = origins.shape[0]
    active = hit.clone() if M > 0 else torch.zeros_like(hit)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    t = tmin
    state = None
    prev_top = torch.full((B,), -1, dtype=torch.int64, device=dev)
    prev_mid = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        pos = sample_position(o, t, d)
        root, top_cell, mid_cell = _root_loads(spec, pos)
        own = root
        if baked:
            st = top_cell == prev_top
            sm = (mid_cell >= 0) & (mid_cell == prev_mid)
            n["same_top"] += (st & active).sum()
            n["same_mid"] += (sm & active).sum()
            n["trail_loads"] += (root - st.long() - sm.long())[active].sum()
            prev_top = torch.where(active, top_cell, prev_top)
            prev_mid = torch.where(active, mid_cell, prev_mid)
        else:
            _, own, new_state = path_lookup(spec, pos, state)
            if state is not None:
                new_state = PathState(*(torch.where(active.view(-1, *([1] * (a.ndim - 1))), a, b)
                                        for a, b in zip(new_state, state)))
            state = new_state
            n["path_loads"] += own[active].sum()
            n["same_leaf"] += ((own == 0) & active).sum()
        n["samples"] += active.sum()
        n["root_loads"] += root[active].sum()
        if opt.interp:
            cl = corner_lookup.corner_lookups(spec, pos[active], s.leaf.cube_sz[active])
            n["lookups_9"] += 9 * active.sum()
            n["loads_9"] += cl.loads_root.sum()
            n["lookups_keep"] += cl.lookups.sum()
            n["loads_keep"] += cl.loads.sum()
        now = active & (s.sigma > opt.sigma_thresh) & s.resident
        found |= now
        active = active & ~now
        t = torch.where(active, t + s.dt, t)
        active = active & (t < tmax)
    if opt.sigma_thresh >= 0 and not torch.equal(found, first_hit_plain(spec, features, origins, dirs, opt)[0]):
        raise AssertionError("the census's march left first_hit_plain's hits")
    out = {k: int(v.item()) for k, v in n.items()}
    out.update(rays=B, hits=int(hit.sum()), found=int(found.sum()), baked=baked, interp=bool(opt.interp))
    return out
