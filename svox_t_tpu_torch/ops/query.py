"""Point query and octree re-pointing, the counterpart of
`svox_t_tpu/ops/query.py`.

`construct_tree` is the per-frame "attach this frame's point cloud" op:
every point's id is written into its leaf's index slot. `query` is the
differentiable point query (a `torch.autograd.Function`, the counterpart
of the JAX package's custom_vjp): values of the points' leaf rows, zeros
in empty space, and a backward that adds the value gradients into the
feature rows. On CUDA tensors each op launches its kernel
(`csrc/construct_tree.cu`, `csrc/query.cu`) or raises; on CPU tensors
its plain PyTorch version runs. `points_leaf_aabb` (`POINTS_AABB`) bounds
the leaves of a point cloud, to keep the baked render structure's cull box
current. `assign`, `unique_leaf_nodes` and `calc_corners` are a later port
(K8b, ROADMAP.md §2).
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from .._build import Kernel
from ..utils.spec import TreeSpec
from .traversal import descend, world2tree

CONSTRUCT_TREE = Kernel(
    "svox_construct_tree",
    [c_void_p, c_int,                     # points, Q
     c_void_p, c_void_p, c_int, c_int, c_int,  # child, data, n_cells, N, n_levels
     c_void_p, c_void_p,                  # offset, scaling
     c_void_p, c_void_p, c_int, c_void_p],  # winner, out, device, stream
)
QUERY_FWD = Kernel(
    "svox_query_fwd",
    [c_void_p, c_int, c_int,                  # points, Q, world
     c_void_p, c_void_p, c_int, c_int,        # child, data, N, n_levels
     c_void_p, c_void_p, c_void_p, c_int, c_int,  # offset, scaling, features, M, D
     c_void_p, c_void_p, c_void_p,            # values, node_flat, data_idx
     c_int, c_void_p],                        # device, stream
)
QUERY_BWD = Kernel(
    "svox_query_bwd",
    [c_void_p, c_void_p, c_int, c_int, c_int,  # data_idx, grad_values, Q, M, D
     c_void_p, c_int, c_void_p],               # grad, device, stream
)
POINTS_AABB = Kernel(
    "svox_points_aabb",
    [c_void_p, c_int, c_int,                  # points, Q, world
     c_void_p, c_int, c_int,                  # child, N, n_levels
     c_void_p, c_void_p,                      # offset, scaling
     c_void_p, c_int, c_void_p],              # lohi (6,), device, stream
)


def _check_points(spec: TreeSpec, points: torch.Tensor) -> None:
    if points.dtype != torch.float32 or points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (Q, 3) float32, got {tuple(points.shape)} {points.dtype}")
    if points.device != spec.device:
        raise ValueError(f"points on {points.device}, tree on {spec.device}")


def construct_tree(spec: TreeSpec, points: torch.Tensor) -> torch.Tensor:
    """Point the tree's leaf index slots at this frame's point rows.

    :param points: (Q, 3) float32 world-space points; point i's leaf gets
        index i. Where several points share a leaf, the largest id wins.
    :return: new flat data table (capacity * N^3,) int32.
    """
    if points.is_cuda:
        return construct_tree_cuda(spec, points)
    return construct_tree_plain(spec, points)


def construct_tree_plain(spec: TreeSpec, points: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the construct_tree kernel."""
    _check_points(spec, points)
    leaf = descend(spec, world2tree(points, spec.offset, spec.scaling))
    tids = torch.arange(points.shape[0], dtype=torch.int32, device=points.device)
    out = spec.data_flat.clone()
    out.scatter_reduce_(0, leaf.node_flat.long(), tids, reduce="amax", include_self=False)
    return out


def construct_tree_cuda(spec: TreeSpec, points: torch.Tensor) -> torch.Tensor:
    """Launch the construct_tree kernel (csrc/construct_tree.cu)."""
    _check_points(spec, points)
    tables = (spec.child_flat, spec.data_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in tables):
        raise ValueError("construct_tree_cuda needs points and tree on one CUDA device")
    for t, dtype in zip(tables, (torch.int32, torch.int32, torch.float32, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child/data must be contiguous int32, offset/scaling float32")
    if points.shape[0] >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("construct_tree_cuda takes fewer than 2^31 points and cells")
    points = points.contiguous()
    n_cells = spec.data_flat.numel()
    winner = torch.empty(n_cells, dtype=torch.int32, device=points.device)
    out = torch.empty_like(spec.data_flat)
    dev = points.device
    CONSTRUCT_TREE(
        points.data_ptr(), points.shape[0],
        spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), n_cells,
        spec.N, spec.n_levels,
        spec.offset.data_ptr(), spec.scaling.data_ptr(),
        winner.data_ptr(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def _check_query(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor) -> None:
    _check_points(spec, points)
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    if features.device != points.device:
        raise ValueError(f"features on {features.device}, points on {points.device}")


def query(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor, world: bool = True):
    """Differentiable point query.

    :param points: (Q, 3) float32 query points (world space, or tree
        space when ``world`` is False).
    :return: (values (Q, D), node_ids (Q,) packed leaf ids,
              data_ids (Q,) feature rows — >= n_features where empty)

    Empty leaves return zero values. The gradient of ``values`` adds into
    the feature rows the points read (duplicates sum); the ids carry no
    gradient.
    """
    return _QueryFn.apply(spec, features, points, world)


class _QueryFn(torch.autograd.Function):
    """`query` with its backward (JAX: `query`'s custom_vjp). The row
    ids found at forward time carry the captured spec into the backward."""

    @staticmethod
    def forward(ctx, spec, features, points, world):
        fwd = query_forward_cuda if features.is_cuda else query_forward_plain
        values, node_flat, data_idx = fwd(spec, features, points, world)
        ctx.mark_non_differentiable(node_flat, data_idx)
        ctx.save_for_backward(data_idx)
        ctx.pool_shape = tuple(features.shape)
        return values, node_flat, data_idx

    @staticmethod
    def backward(ctx, grad_values, grad_node_flat, grad_data_idx):
        del grad_node_flat, grad_data_idx
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        (data_idx,) = ctx.saved_tensors
        M, _ = ctx.pool_shape
        bwd = query_backward_cuda if grad_values.is_cuda else query_backward_plain
        return None, bwd(data_idx, grad_values.contiguous(), M), None, None


def query_forward_plain(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                        world: bool = True):
    """Plain PyTorch version of the query forward kernel."""
    _check_query(spec, features, points)
    pos = world2tree(points, spec.offset, spec.scaling) if world else points
    leaf = descend(spec, pos)
    M, D = features.shape
    if M == 0:
        values = torch.zeros((points.shape[0], D), dtype=features.dtype, device=points.device)
        return values, leaf.node_flat, leaf.data_idx
    valid = (leaf.data_idx >= 0) & (leaf.data_idx < M)
    idx = torch.where(valid, leaf.data_idx, 0).long()
    values = torch.where(valid[:, None], features[idx], 0.0)
    return values, leaf.node_flat, leaf.data_idx


def query_backward_plain(data_idx: torch.Tensor, grad_values: torch.Tensor, M: int):
    """Plain PyTorch version of the query backward kernel: (M, D) feature
    gradient, value gradients added into rows data_idx < M."""
    D = grad_values.shape[1]
    grad = torch.zeros(M, D, dtype=grad_values.dtype, device=grad_values.device)
    valid = (data_idx >= 0) & (data_idx < M)
    grad.index_add_(0, data_idx[valid].long(), grad_values[valid])
    return grad


def query_forward_cuda(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                       world: bool = True):
    """Launch the query forward kernel (csrc/query.cu)."""
    _check_query(spec, features, points)
    tables = (spec.child_flat, spec.data_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in (features, *tables)):
        raise ValueError("query_forward_cuda needs points, features and tree on one CUDA device")
    for t, dtype in zip((*tables, features),
                        (torch.int32, torch.int32, torch.float32, torch.float32, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child/data must be contiguous int32, offset/scaling/features float32")
    Q = points.shape[0]
    M, D = features.shape
    if Q >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("query_forward_cuda takes fewer than 2^31 points and cells")
    points = points.contiguous()
    dev = points.device
    values = torch.empty(Q, D, dtype=torch.float32, device=dev)
    node_flat = torch.empty(Q, dtype=torch.int32, device=dev)
    data_idx = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return values, node_flat, data_idx
    QUERY_FWD(
        points.data_ptr(), Q, int(bool(world)),
        spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), spec.N, spec.n_levels,
        spec.offset.data_ptr(), spec.scaling.data_ptr(), features.data_ptr(), M, D,
        values.data_ptr(), node_flat.data_ptr(), data_idx.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return values, node_flat, data_idx


def query_backward_cuda(data_idx: torch.Tensor, grad_values: torch.Tensor, M: int):
    """Launch the query backward kernel (csrc/query.cu) into a zeroed
    (M, D) gradient."""
    if not (data_idx.is_cuda and grad_values.device == data_idx.device):
        raise ValueError("query_backward_cuda needs data_idx and grad_values on one CUDA device")
    if data_idx.dtype != torch.int32 or grad_values.dtype != torch.float32:
        raise ValueError("data_idx must be int32 and grad_values float32")
    if not (data_idx.is_contiguous() and grad_values.is_contiguous()):
        raise ValueError("query_backward_cuda needs contiguous tensors")
    Q, D = grad_values.shape
    if data_idx.shape != (Q,):
        raise ValueError(f"data_idx must be ({Q},), got {tuple(data_idx.shape)}")
    dev = grad_values.device
    grad = torch.zeros(M, D, dtype=torch.float32, device=dev)
    if M == 0 or Q * D == 0:
        return grad
    QUERY_BWD(
        data_idx.data_ptr(), grad_values.data_ptr(), Q, M, D, grad.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return grad


def points_leaf_aabb(spec: TreeSpec, points: torch.Tensor, world: bool = True, union=None):
    """Tree-space box of the leaf cells that hold (Q, 3) points: the
    occupied box after `construct_tree` points the tree at them.

    The box of a leaf comes from the descent's own integer cell (a
    one-shot ``floor(pos * cube_sz)`` can land one cell off for N not a
    power of two), dilated by 1e-6 to absorb the rounding of
    ``cell / cube_sz``: the cull needs the box to contain, not to be
    tight.

    :param union: optional (lo, hi) box the result also covers (the
        occupied box so far: the kernel folds the points into it).
    :return: (lo (3,), hi (3,)) float32; (+inf, -inf) for no points and
        no ``union``.
    """
    if points.is_cuda:
        return points_leaf_aabb_cuda(spec, points, world, union)
    return points_leaf_aabb_plain(spec, points, world, union)


def points_leaf_aabb_plain(spec: TreeSpec, points: torch.Tensor, world: bool = True,
                           union=None):
    """Plain PyTorch version of the points_leaf_aabb kernel."""
    _check_points(spec, points)
    if points.shape[0] == 0:
        inf = torch.full((3,), float("inf"), device=points.device)
        lo, hi = inf, -inf
    else:
        pos = world2tree(points, spec.offset, spec.scaling) if world else points
        leaf, cell = descend(spec, pos, with_cell=True)
        cs = leaf.cube_sz[:, None]
        lo = (cell.to(torch.float32) / cs - 1e-6).amin(dim=0)
        hi = ((cell + 1).to(torch.float32) / cs + 1e-6).amax(dim=0)
    if union is not None:
        lo, hi = torch.minimum(lo, union[0]), torch.maximum(hi, union[1])
    return lo, hi


def points_leaf_aabb_cuda(spec: TreeSpec, points: torch.Tensor, world: bool = True,
                          union=None):
    """Launch the points_leaf_aabb kernel (csrc/query.cu): a grid-stride
    descent, the box reduced per block, then float atomics on the (6,)
    box, which starts at ``union`` (else empty)."""
    _check_points(spec, points)
    tables = (spec.child_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in tables):
        raise ValueError("points_leaf_aabb_cuda needs points and tree on one CUDA device")
    for t, dtype in zip(tables, (torch.int32, torch.float32, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child must be contiguous int32, offset/scaling float32")
    Q = points.shape[0]
    if Q >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("points_leaf_aabb_cuda takes fewer than 2^31 points and cells")
    points = points.contiguous()
    dev = points.device
    if union is not None:
        lohi = torch.cat([torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(3)
                          for b in union])
    else:  # filled on the card: no host copy
        lohi = torch.full((6,), float("inf"), dtype=torch.float32, device=dev)
        lohi[3:] = -float("inf")
    if Q:
        POINTS_AABB(points.data_ptr(), Q, int(bool(world)), spec.child_flat.data_ptr(),
                    spec.N, spec.n_levels, spec.offset.data_ptr(), spec.scaling.data_ptr(),
                    lohi.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return lohi[:3], lohi[3:]
