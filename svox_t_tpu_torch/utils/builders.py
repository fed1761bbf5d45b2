"""Tree construction utilities: build octree structure arrays directly
from dense occupancy, without incremental refine() calls.

This is the production path for the Artemis-style dynamic pipeline:
``voxelize`` (p2v) produces a dense sigma volume; ``tree_from_occupancy``
turns its support into an N3Tree whose finest occupied leaves each get a
feature-pool row; per-frame point clouds then re-point it with
``construct_tree``. The whole build is vectorized host NumPy
(breadth-first, one pass per level) — a few seconds for millions of
nodes, no device round-trips. Same code as `svox_t_tpu/utils/builders.py`;
`tree_from_occupancy` returns this package's N3Tree on ``device``.
"""

from __future__ import annotations

import numpy as np

from .spec import DATA_SENTINEL


def tree_structure_from_occupancy(occ: np.ndarray, N: int = 2):
    """Build (child, data, parent_depth, n_nodes, n_occupied) arrays from
    a dense boolean occupancy grid.

    :param occ: (R, R, R) bool; R must be a power of N. A cell is made a
        finest-level leaf with a feature row iff occ is True; internal
        nodes are created wherever a subtree contains any occupied cell.
        Feature rows are assigned in breadth-first cell order.
    :return: (child (n, N, N, N) int32, data (n, N, N, N, 1) int32,
              parent_depth (n, 2) int32, n_nodes, n_occupied)
    """
    occ = np.asarray(occ, bool)
    R = occ.shape[0]
    assert occ.shape == (R, R, R)
    depth = int(round(np.log(R) / np.log(N)))
    assert N ** depth == R, f"grid size {R} is not a power of {N}"

    # occupancy mip pyramid: level d has resolution N^d (any-reduce)
    mips = [occ]
    cur = occ
    while cur.shape[0] > 1:
        r = cur.shape[0] // N
        cur = cur.reshape(r, N, r, N, r, N).any(axis=(1, 3, 5))
        mips.append(cur)
    mips = mips[::-1]  # mips[d] has reso N^d; mips[0] is (1,1,1)

    N3 = N ** 3
    u, v, w = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    uvw = np.stack([u.ravel(), v.ravel(), w.ravel()], -1)

    child_rows = []
    parent_rows = [np.zeros((1, 2), np.int32)]
    frontier_ids = np.array([0], np.int64)
    frontier_corners = np.zeros((1, 3), np.int64)  # in units of own level cells
    n_nodes = 1
    leaf_nodes, leaf_cells = [], []

    for level in range(depth):
        n = len(frontier_ids)
        # child cell coords at level+1 resolution
        cell_coords = (
            frontier_corners[:, None, :] * N + uvw[None]
        ).reshape(-1, 3)
        mip = mips[level + 1]
        occ_cells = mip[cell_coords[:, 0], cell_coords[:, 1], cell_coords[:, 2]]
        node_of = np.repeat(frontier_ids, N3)
        cell_of = np.tile(np.arange(N3), n)
        last = level == depth - 1
        subdivide = occ_cells & (not last)
        occupied_leaf = occ_cells & last
        if occupied_leaf.any():
            leaf_nodes.append(node_of[occupied_leaf])
            leaf_cells.append(cell_of[occupied_leaf])
        ch = np.zeros((n, N3), np.int32)
        k = int(subdivide.sum())
        if k:
            new_ids = n_nodes + np.arange(k)
            ch.reshape(-1)[subdivide] = (new_ids - node_of[subdivide]).astype(
                np.int32
            )
            pr = np.zeros((k, 2), np.int32)
            sub_cells = cell_of[subdivide]
            pr[:, 0] = (
                (node_of[subdivide] * N + uvw[sub_cells, 0]) * N
                + uvw[sub_cells, 1]
            ) * N + uvw[sub_cells, 2]
            pr[:, 1] = level + 1
            parent_rows.append(pr)
        child_rows.append(ch)
        frontier_ids = n_nodes + np.arange(k)
        frontier_corners = cell_coords[subdivide]
        n_nodes += k
        if k == 0:
            break

    child = np.zeros((n_nodes, N3), np.int32)
    pdepth = np.zeros((n_nodes, 2), np.int32)
    offs = 0
    for pr in parent_rows:
        pdepth[offs : offs + len(pr)] = pr
        offs += len(pr)
    starts = np.cumsum([0] + [len(p) for p in parent_rows[:-1]])
    for i, ch in enumerate(child_rows):
        s = starts[i]
        child[s : s + len(ch)] = ch

    data = np.full((n_nodes, N3), DATA_SENTINEL, np.int32)
    if leaf_nodes:
        nodes = np.concatenate(leaf_nodes)
        cells = np.concatenate(leaf_cells)
        data[nodes, cells] = np.arange(len(nodes), dtype=np.int32)
        n_occ = len(nodes)
    else:
        n_occ = 0

    return (
        child.reshape(n_nodes, N, N, N),
        data.reshape(n_nodes, N, N, N, 1),
        pdepth,
        n_nodes,
        n_occ,
    )


def tree_from_occupancy(
    occ: np.ndarray,
    N: int = 2,
    data_dim: int = 4,
    data_format: str = "RGBA",
    radius=0.5,
    center=(0.5, 0.5, 0.5),
    extra_data=None,
    device="cuda",
):
    """Build an N3Tree from a dense occupancy grid (see
    tree_structure_from_occupancy). Returns (tree, n_occupied); occupied
    finest leaves point at feature rows 0..n_occupied-1 in breadth-first
    order — allocate your feature pool accordingly."""
    from ..models.tree import N3Tree

    occ = np.asarray(occ)
    if occ.dtype != bool:
        occ = occ > 0
    depth = int(round(np.log(occ.shape[0]) / np.log(N)))
    child, data, pdepth, n_nodes, n_occ = tree_structure_from_occupancy(occ, N)
    t = N3Tree(
        N=N,
        data_dim=data_dim,
        depth_limit=depth,
        data_format=data_format,
        radius=list(radius) if hasattr(radius, "__len__") else radius,
        center=list(center),
        extra_data=extra_data,
        device=device,
    )
    t._child = child
    t._data = data
    t._parent_depth = pdepth
    t._n_internal = n_nodes
    t.filled = n_nodes
    t._invalidate()
    return t, n_occ
