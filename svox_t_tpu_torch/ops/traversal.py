"""Octree traversal in plain PyTorch, the counterpart of
`svox_t_tpu/ops/traversal.py`.

`descend` is the vectorized root-to-leaf walk over relative child
offsets: ``n_levels`` fixed iterations of one flat gather each, finished
points carried through with masks. The kernels carry the same walk as a
``__device__`` function (`csrc/common.cuh`), one point per thread.

Semantics, shared with the JAX package and the kernels:
  * coords clamped to [0, 1 - 1e-6];
  * the in-leaf fraction is taken after the multiply by N at the leaf's
    level;
  * cube_sz starts at N and multiplies by N per continued level, so a
    depth-d leaf has cube_sz = N^(d+1);
  * packed node id = ((node * N + u) * N + v) * N + w.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.spec import TreeSpec


class LeafInfo(NamedTuple):
    data_idx: torch.Tensor   # (B,) int32 feature-pool row (>= n_features: empty)
    node_flat: torch.Tensor  # (B,) int32 packed leaf cell id
    cube_sz: torch.Tensor    # (B,) float32 N^(depth+1) of the leaf
    frac: torch.Tensor       # (B, 3) float32 in-leaf fractional coords


def world2tree(pos: torch.Tensor, offset: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """World -> tree [0,1]^3."""
    return offset + scaling * pos


def tree2world(pos: torch.Tensor, offset: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """Tree [0,1]^3 -> world."""
    return (pos - offset) / scaling


def clamp_coord(pos: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1 - 1e-6]."""
    return torch.clamp(pos, 0.0, 1.0 - 1e-6)


def descend(spec: TreeSpec, pos: torch.Tensor, with_cell: bool = False):
    """Root-to-leaf descent for a batch of tree-space points.

    :param pos: (B, 3) float32 in [0,1]^3 (clamped here).
    :param with_cell: also return the leaf's integer cell (B, 3) int32 at
        its own resolution ``cube_sz``, the cell the descent's per-level
        floors selected.
    :return: LeafInfo over the batch (``(LeafInfo, cell)`` with
        ``with_cell``).
    """
    N = spec.N
    child = spec.child_flat
    B = pos.shape[0]
    dev = pos.device
    xyz = clamp_coord(pos)
    node = torch.zeros(B, dtype=torch.int32, device=dev)
    cube = torch.full((B,), float(N), dtype=pos.dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    leaf_flat = torch.zeros(B, dtype=torch.int32, device=dev)
    cell = torch.zeros(B, 3, dtype=torch.int32, device=dev)
    for _ in range(spec.n_levels):
        xyz_s = xyz * N
        uvw = torch.clamp(torch.floor(xyz_s), max=N - 1).to(torch.int32)
        frac = xyz_s - uvw.to(pos.dtype)
        flat = ((node * N + uvw[:, 0]) * N + uvw[:, 1]) * N + uvw[:, 2]
        skip = child[flat.long()]
        term = (skip == 0) & ~done
        cont = ~(done | term)
        leaf_flat = torch.where(term, flat, leaf_flat)
        cell = torch.where(done[:, None], cell, cell * N + uvw)
        xyz = torch.where(done[:, None], xyz, frac)
        node = torch.where(cont, node + skip, node)
        cube = torch.where(cont, cube * N, cube)
        done = done | term
    data_idx = spec.data_flat[leaf_flat.long()]
    leaf = LeafInfo(data_idx=data_idx, node_flat=leaf_flat, cube_sz=cube, frac=xyz)
    return (leaf, cell) if with_cell else leaf


def dda_unit(cen: torch.Tensor, invdir: torch.Tensor):
    """Entry/exit of a ray with the unit cube.

    :param cen: (B, 3) ray position
    :param invdir: (B, 3) reciprocal direction
    :return: (tmin >= 0, tmax <= 1e9), each (B,)
    """
    t1 = -cen * invdir
    t2 = t1 + invdir
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tmax = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return torch.clamp(tmin, min=0.0), torch.clamp(tmax, max=1e9)


def get_delta_scale(scaling: torch.Tensor, dirs: torch.Tensor):
    """Scale dirs into tree space and normalize.

    The norm is summed as ((x*x + y*y) + z*z), the order the kernels use.

    :return: (unit tree-space dirs (B, 3), delta_scale (B,))
    """
    d = dirs * scaling
    norm = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    delta_scale = 1.0 / norm
    return d * delta_scale[:, None], delta_scale


def pack_index(txyz: torch.Tensor, N: int) -> torch.Tensor:
    """(Q,4) [node,x,y,z] -> packed id."""
    return ((txyz[:, 0] * N + txyz[:, 1]) * N + txyz[:, 2]) * N + txyz[:, 3]


def unpack_index(flat: torch.Tensor, N: int) -> torch.Tensor:
    """packed id -> (Q,4) [node,x,y,z]."""
    z = flat % N
    flat = flat // N
    y = flat % N
    flat = flat // N
    x = flat % N
    node = flat // N
    return torch.stack([node, x, y, z], dim=-1)
