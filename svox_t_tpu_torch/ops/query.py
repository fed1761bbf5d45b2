"""Point query, octree re-pointing and tree editing, the counterpart of
`svox_t_tpu/ops/query.py`.

`construct_tree` is the per-frame "attach this frame's point cloud" op:
every point's id is written into its leaf's index slot. `query` is the
differentiable point query (a `torch.autograd.Function`, the counterpart
of the JAX package's custom_vjp): values of the points' leaf rows, zeros
in empty space, and a backward that adds the value gradients into the
feature rows. On CUDA tensors each op launches its kernel
(`csrc/construct_tree.cu`, `csrc/query.cu`, `csrc/edit.cu`) or raises; on
CPU tensors its plain PyTorch version runs. The query forward copies each
warp's rows in the unit `query_unit` picks (`QUERY_FWD_UNIT_LAUNCHES`
counts its launches by unit), and the backward adds each warp's gradient
rows in the unit `query_bwd_unit` picks (`QUERY_BWD_UNIT_LAUNCHES`). `points_leaf_aabb`
(`POINTS_AABB`) bounds the leaves of a point cloud, to keep the baked
render structure's cull box current; `construct_tree_aabb`
(`CONSTRUCT_TREE_AABB`) re-points the tree and bounds the points' leaves
in one descent, as the re-points that keep a box take it. The
tree-editing ops: `assign` (`ASSIGN`) writes values into the pool rows that points address and
returns the new pool; `unique_leaf_nodes` (`UNIQUE_LEAF`) lists the
distinct leaves of packed ids in ascending order, padded with -1;
`calc_corners` (`CALC_CORNERS`) gives leaf cells' lower corners in tree
space.
"""

from __future__ import annotations

import threading
from ctypes import c_int, c_void_p

import torch

from .._build import Kernel
from ..utils.spec import TreeSpec
from .traversal import descend, unpack_index, world2tree

CONSTRUCT_TREE = Kernel(
    "svox_construct_tree",
    [c_void_p, c_int,                     # points, Q
     c_void_p, c_void_p, c_int, c_int, c_int,  # child, data, n_cells, N, n_levels
     c_void_p, c_void_p,                  # offset, scaling
     c_void_p, c_void_p, c_int, c_void_p],  # winner, out, device, stream
)
# construct_tree with the points' leaf box in the same descent
# (`construct_tree_aabb`): construct_tree's arguments, then the box
# scratch, the union's two corners (or null) and the (6,) result.
CONSTRUCT_TREE_AABB = Kernel(
    "svox_construct_tree_aabb",
    [c_void_p, c_int,                     # points, Q
     c_void_p, c_void_p, c_int, c_int, c_int,  # child, data, n_cells, N, n_levels
     c_void_p, c_void_p,                  # offset, scaling
     c_void_p, c_void_p,                  # winner, out
     c_void_p, c_void_p, c_void_p, c_void_p,  # box scratch, union lo, union hi, lohi
     c_int, c_void_p],                    # device, stream
)
_QUERY_FWD_ARGS = [c_void_p, c_int, c_int,                  # points, Q, world
                   c_void_p, c_void_p, c_int, c_int,        # child, data, N, n_levels
                   c_void_p, c_void_p, c_void_p, c_int, c_int,  # offset, scaling, features, M, D
                   c_void_p, c_void_p, c_void_p,            # values, node_flat, data_idx
                   c_int, c_int, c_void_p]                  # unit, device, stream
_QUERY_BWD_ARGS = [c_void_p, c_void_p, c_int, c_int, c_int,  # data_idx, grad_values, Q, M, D
                   c_void_p, c_int, c_int, c_void_p]         # grad, unit, device, stream
QUERY_FWD = Kernel("svox_query_fwd", _QUERY_FWD_ARGS)
QUERY_BWD = Kernel("svox_query_bwd", _QUERY_BWD_ARGS)
# K5: the bf16 pool's instances (csrc/query_bf16.cu): bf16 values, and a
# backward that reads bf16 value gradients and sums them in float32. The
# JAX query takes no quantized pool.
QUERY_FWD_BF16 = Kernel("svox_query_fwd_bf16", _QUERY_FWD_ARGS)
QUERY_BWD_BF16 = Kernel("svox_query_bwd_bf16", _QUERY_BWD_ARGS)
_QUERY_FWD = {torch.float32: QUERY_FWD, torch.bfloat16: QUERY_FWD_BF16}
# The query forward's copy units (`csrc/query_fwd.cuh`): the bytes a lane
# moves at a time, widest first, by pool type; and its launches by pool
# type and unit ("f32 16": a float32 pool copied in 16-byte units).
QUERY_UNITS = {torch.float32: (16, 8, 4), torch.bfloat16: (16, 8, 4, 2)}
_POOL_KIND = {torch.float32: "f32", torch.bfloat16: "bf16"}
QUERY_FWD_UNIT_LAUNCHES = {f"{_POOL_KIND[t]} {u}": 0 for t, units in QUERY_UNITS.items() for u in units}
_QUERY_BWD = {torch.float32: QUERY_BWD, torch.bfloat16: QUERY_BWD_BF16}
# The query backward's units (`csrc/query_bwd.cuh`): the bytes of the value
# gradients a lane adds at a time (4, 2 or 1 values, one vector atomic into
# the float32 gradient), widest first, by gradient type; and its launches
# by type and unit ("f32 16": float32 gradients added in float4 units).
QUERY_BWD_UNITS = {torch.float32: (16, 8, 4), torch.bfloat16: (8, 4, 2)}
QUERY_BWD_UNIT_LAUNCHES = {f"{_POOL_KIND[t]} {u}": 0 for t, units in QUERY_BWD_UNITS.items() for u in units}
POINTS_AABB = Kernel(
    "svox_points_aabb",
    [c_void_p, c_int, c_int,                  # points, Q, world
     c_void_p, c_int, c_int,                  # child, N, n_levels
     c_void_p, c_void_p,                      # offset, scaling
     c_void_p, c_int, c_void_p],              # lohi (6,), device, stream
)
ASSIGN = Kernel(
    "svox_assign",
    [c_void_p, c_int, c_int,                  # points, Q, world
     c_void_p, c_void_p, c_int, c_int,        # child, data, N, n_levels
     c_void_p, c_void_p,                      # offset, scaling
     c_void_p, c_int, c_int, c_void_p,        # features, M, D, values
     c_void_p, c_void_p, c_int, c_void_p],    # winner, out, device, stream
)
UNIQUE_LEAF = Kernel(
    "svox_unique_leaf",
    [c_void_p, c_int, c_int, c_int, c_int,    # ids, Q, n_cells, N, size
     c_void_p, c_void_p, c_void_p,            # flags, tile_sums, tile_offsets
     c_void_p, c_void_p, c_int, c_void_p],    # out, count, device, stream
)
CALC_CORNERS = Kernel(
    "svox_calc_corners",
    [c_void_p, c_int, c_void_p, c_int, c_int, c_int,  # indexer, Q, parent_depth, capacity, N, steps
     c_void_p, c_int, c_void_p],                       # out, device, stream
)
# Flags per tile of the unique_leaf_nodes scan (kTile in csrc/edit.cu).
_UNIQUE_TILE = 4096


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


# The construct_tree kernels' scratch, one a (device, stream): the winner,
# (>= n_cells,) int32, all -1 between calls (the kernels' merge resets the
# cells it took), grown to the largest table seen; and the box of
# `construct_tree_aabb`, (6,) float32, (+inf x 3, -inf x 3) between calls
# (its merge takes and resets it). A lock a stream: a ctypes call releases
# the GIL, and two host threads must not interleave their launches on one
# stream's scratch. A call that fails drops its stream's scratch, and the
# next call starts from a fresh one.
_WINNERS = {}
_BOXES = {}
_WINNER_LOCKS = {}


def _construct_args(spec: TreeSpec, points: torch.Tensor, what: str):
    """The checked tables of a construct_tree launch: (points made
    contiguous, n_cells)."""
    _check_points(spec, points)
    child, data = spec.child_flat, spec.data_flat
    dev = points.device
    if not points.is_cuda or any(t.device != dev for t in (data, spec.offset, spec.scaling)):
        raise ValueError(f"{what} needs points and tree on one CUDA device")
    if (child.dtype != torch.int32 or data.dtype != torch.int32 or spec.offset.dtype != torch.float32
            or spec.scaling.dtype != torch.float32 or not (child.is_contiguous() and data.is_contiguous())):
        raise ValueError("child/data must be contiguous int32, offset/scaling float32")
    n_cells = data.numel()
    if child.numel() != n_cells:
        raise ValueError(f"child ({child.numel()}) and data ({n_cells}) tables differ in size")
    if points.shape[0] >= 2 ** 31 or n_cells >= 2 ** 31:
        raise ValueError(f"{what} takes fewer than 2^31 points and cells")
    return points.contiguous(), n_cells


def _launch_construct(spec: TreeSpec, points: torch.Tensor, n_cells: int, box_args=None):
    """Launch construct_tree's C entry on the current stream with its
    scratch, or with ``box_args`` (the union's two corners and the (6,)
    result) its box form; returns the new table."""
    dev = points.device
    out = torch.empty_like(spec.data_flat)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    with _WINNER_LOCKS.get(key) or _WINNER_LOCKS.setdefault(key, threading.Lock()):
        winner = _WINNERS.get(key)
        if winner is None or winner.numel() < n_cells:
            winner = _WINNERS[key] = torch.full((n_cells,), -1, dtype=torch.int32, device=dev)
        kernel, box = CONSTRUCT_TREE, ()
        if box_args is not None:
            if key not in _BOXES:
                inf = float("inf")
                _BOXES[key] = torch.tensor([inf] * 3 + [-inf] * 3, dtype=torch.float32, device=dev)
            kernel, box = CONSTRUCT_TREE_AABB, (_BOXES[key].data_ptr(), *box_args)
        try:
            kernel(
                points.data_ptr(), points.shape[0], spec.child_flat.data_ptr(), spec.data_flat.data_ptr(),
                n_cells, spec.N, spec.n_levels, spec.offset.data_ptr(), spec.scaling.data_ptr(),
                winner.data_ptr(), out.data_ptr(), *box, dev.index, stream,
            )
        except RuntimeError:
            _WINNERS.pop(key, None)
            _BOXES.pop(key, None)
            raise
    return out


def construct_tree_cuda(spec: TreeSpec, points: torch.Tensor) -> torch.Tensor:
    """Launch the construct_tree kernel (csrc/construct_tree.cu)."""
    points, n_cells = _construct_args(spec, points, "construct_tree_cuda")
    return _launch_construct(spec, points, n_cells)


def construct_tree_aabb(spec: TreeSpec, points: torch.Tensor, union=None):
    """`construct_tree` and `points_leaf_aabb` (world-space points) in one:
    the new flat table and the tree-space box (lo, hi) of the leaves that
    hold the points, joined with ``union`` (the occupied box so far) when
    given. On CUDA one descent a point computes both.

    :return: (table (capacity * N^3,) int32, lo (3,), hi (3,) float32)
    """
    if points.is_cuda:
        return construct_tree_aabb_cuda(spec, points, union)
    return construct_tree_aabb_plain(spec, points, union)


def construct_tree_aabb_plain(spec: TreeSpec, points: torch.Tensor, union=None):
    """Plain PyTorch version of the fused kernel: `construct_tree_plain`,
    then `points_leaf_aabb_plain` with the union."""
    table = construct_tree_plain(spec, points)
    lo, hi = points_leaf_aabb_plain(spec, points, True, union)
    return table, lo, hi


def construct_tree_aabb_cuda(spec: TreeSpec, points: torch.Tensor, union=None):
    """Launch the fused kernels (csrc/construct_tree.cu
    `svox_construct_tree_aabb`): construct_tree's scatter also forms each
    point's leaf box and folds it into the stream's box scratch, which its
    merge joins with ``union`` into the result (read on the card) and
    resets."""
    points, n_cells = _construct_args(spec, points, "construct_tree_aabb_cuda")
    dev = points.device
    if union is None:
        corners = (None, None)
    else:
        corners = tuple(torch.as_tensor(b, dtype=torch.float32, device=dev).reshape(3).contiguous()
                        for b in union)
    lohi = torch.empty(6, dtype=torch.float32, device=dev)
    ptrs = tuple(None if c is None else c.data_ptr() for c in corners)
    table = _launch_construct(spec, points, n_cells, (*ptrs, lohi.data_ptr()))
    return table, lohi[:3], lohi[3:]


def _check_query(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor) -> None:
    _check_points(spec, points)
    if not isinstance(features, torch.Tensor):
        raise ValueError("the point query takes a float32 or bfloat16 pool tensor (the JAX "
                         "package's query takes no quantized pool)")
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    if features.device != points.device:
        raise ValueError(f"features on {features.device}, points on {points.device}")


def query(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor, world: bool = True):
    """Differentiable point query.

    :param points: (Q, 3) float32 query points (world space, or tree
        space when ``world`` is False).
    :return: (values (Q, D) in the pool's type (float32 or bf16),
              node_ids (Q,) packed leaf ids, data_ids (Q,) feature rows —
              >= n_features where empty)

    Empty leaves return zero values. The gradient of ``values`` adds into
    the feature rows the points read (duplicates sum, in float32), and
    comes back in the pool's type; the ids carry no gradient.
    """
    _check_query(spec, features, points)
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
        ctx.pool_dtype = features.dtype
        return values, node_flat, data_idx

    @staticmethod
    def backward(ctx, grad_values, grad_node_flat, grad_data_idx):
        del grad_node_flat, grad_data_idx
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        (data_idx,) = ctx.saved_tensors
        M, _ = ctx.pool_shape
        bwd = query_backward_cuda if grad_values.is_cuda else query_backward_plain
        grad = bwd(data_idx, grad_values.contiguous(), M)
        return None, grad.to(ctx.pool_dtype), None, None


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
    gradient, value gradients added into rows data_idx < M, summed in
    float32 (float64 for float64 gradients) whatever their type."""
    D = grad_values.shape[1]
    dtype = torch.promote_types(grad_values.dtype, torch.float32)
    grad = torch.zeros(M, D, dtype=dtype, device=grad_values.device)
    valid = (data_idx >= 0) & (data_idx < M)
    grad.index_add_(0, data_idx[valid].long(), grad_values[valid].to(dtype))
    return grad


def query_unit(D: int, dtype: torch.dtype, ptrs) -> int:
    """The copy unit of a query forward launch: the widest of
    `QUERY_UNITS[dtype]` (bytes) that divides the row (D values of
    ``dtype``) and the address of every pointer of ``ptrs`` (the pool and
    the output). A float32 SH9 row (112 bytes) takes 16, a bf16 one (56
    bytes) 8; a pool that starts off a 16-byte boundary takes a narrower
    unit."""
    row = D * dtype.itemsize
    for unit in QUERY_UNITS[dtype]:
        if row % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    raise ValueError(f"no query unit for a {dtype} pool")


def query_bwd_unit(D: int, dtype: torch.dtype, ptrs) -> int:
    """The unit of a query backward launch: the widest of
    `QUERY_BWD_UNITS[dtype]` (bytes of ``dtype`` value gradients, k values)
    that divides the row (D values) and the gradients' address ``ptrs[0]``,
    and whose k float32 values divide the float32 gradient's address
    ``ptrs[1]``. Float32 SH9 gradients take 16 (float4 atomics), bf16 ones
    8 (4 values widened to a float4)."""
    row = D * dtype.itemsize
    for unit in QUERY_BWD_UNITS[dtype]:
        k = unit // dtype.itemsize
        if row % unit == 0 and ptrs[0] % unit == 0 and ptrs[1] % (4 * k) == 0:
            return unit
    raise ValueError(f"no query backward unit for {dtype} gradients")


def _query_launch_unit(D: int, dtype: torch.dtype, ptrs, unit) -> int:
    """The unit of a launch: `query_unit`'s, or ``unit`` where the caller
    forces one; a unit the pool type has no instance for, or that does not
    divide the row and the pointers, raises."""
    rule = query_unit(D, dtype, ptrs)
    if unit is None:
        return rule
    if type(unit) is not int or unit not in QUERY_UNITS[dtype]:
        raise ValueError(f"the query unit for a {dtype} pool must be one of {QUERY_UNITS[dtype]}, "
                         f"got {unit!r}")
    row = D * dtype.itemsize
    if row % unit or any(p % unit for p in ptrs):
        raise ValueError(f"a {unit}-byte query unit needs a row ({row} bytes) and pointers on "
                         f"{unit} bytes; this launch takes at most {rule}")
    return unit


def query_forward_cuda(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                       world: bool = True, unit=None):
    """Launch the query forward kernel (csrc/query.cu; for a bf16 pool
    csrc/query_bf16.cu, whose values are bf16) at `query_unit`'s copy unit;
    ``unit`` (bytes) forces one, and a unit the launch does not allow
    raises (a comparison of the instances passes it)."""
    _check_query(spec, features, points)
    tables = (spec.child_flat, spec.data_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in (features, *tables)):
        raise ValueError("query_forward_cuda needs points, features and tree on one CUDA device")
    for t, dtype in zip(tables, (torch.int32, torch.int32, torch.float32, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child/data must be contiguous int32, offset/scaling float32")
    kernel = _QUERY_FWD.get(features.dtype)
    if kernel is None:
        raise ValueError(f"the query kernels have no instance for a {features.dtype} pool: "
                         "float32 or bfloat16")
    if not features.is_contiguous():
        raise ValueError("query_forward_cuda needs a contiguous pool")
    Q = points.shape[0]
    M, D = features.shape
    if Q >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("query_forward_cuda takes fewer than 2^31 points and cells")
    points = points.contiguous()
    dev = points.device
    values = torch.empty(Q, D, dtype=features.dtype, device=dev)
    node_flat = torch.empty(Q, dtype=torch.int32, device=dev)
    data_idx = torch.empty(Q, dtype=torch.int32, device=dev)
    unit = _query_launch_unit(D, features.dtype, (features.data_ptr(), values.data_ptr()), unit)
    if Q == 0:
        return values, node_flat, data_idx
    kernel(
        points.data_ptr(), Q, int(bool(world)),
        spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), spec.N, spec.n_levels,
        spec.offset.data_ptr(), spec.scaling.data_ptr(), features.data_ptr(), M, D,
        values.data_ptr(), node_flat.data_ptr(), data_idx.data_ptr(),
        unit, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    QUERY_FWD_UNIT_LAUNCHES[f"{_POOL_KIND[features.dtype]} {unit}"] += 1
    return values, node_flat, data_idx


def query_backward_cuda(data_idx: torch.Tensor, grad_values: torch.Tensor, M: int, unit=None):
    """Launch the query backward kernel (csrc/query_bwd.cuh, compiled by
    csrc/query.cu; for bf16 value gradients by csrc/query_bf16.cu): every
    point's value gradients added into its row of a zeroed float32 (M, D)
    gradient. The unit is the one `query_bwd_unit` picks, or ``unit``
    (bytes of the value gradients) where the caller forces a narrower one;
    a unit the launch does not allow raises."""
    if not (data_idx.is_cuda and grad_values.device == data_idx.device):
        raise ValueError("query_backward_cuda needs data_idx and grad_values on one CUDA device")
    if data_idx.dtype != torch.int32:
        raise ValueError("data_idx must be int32")
    kernel = _QUERY_BWD.get(grad_values.dtype)
    if kernel is None:
        raise ValueError(f"the query kernels have no instance for {grad_values.dtype} "
                         "gradients: float32 or bfloat16")
    if not (data_idx.is_contiguous() and grad_values.is_contiguous()):
        raise ValueError("query_backward_cuda needs contiguous tensors")
    Q, D = grad_values.shape
    if data_idx.shape != (Q,):
        raise ValueError(f"data_idx must be ({Q},), got {tuple(data_idx.shape)}")
    dev = grad_values.device
    grad = torch.zeros(M, D, dtype=torch.float32, device=dev)
    if M == 0 or Q * D == 0:
        return grad
    if Q >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError("query_backward_cuda takes fewer than 2^31 points and rows")
    ptrs = (grad_values.data_ptr(), grad.data_ptr())
    rule = query_bwd_unit(D, grad_values.dtype, ptrs)
    if unit is None:
        unit = rule
    elif type(unit) is not int or unit not in QUERY_BWD_UNITS[grad_values.dtype] or unit > rule:
        raise ValueError(f"the query backward unit for {grad_values.dtype} gradients must be one of "
                         f"{QUERY_BWD_UNITS[grad_values.dtype]} and at most {rule} here, got {unit!r}")
    kernel(data_idx.data_ptr(), grad_values.data_ptr(), Q, M, D, grad.data_ptr(), unit,
           dev.index, torch.cuda.current_stream(dev).cuda_stream)
    QUERY_BWD_UNIT_LAUNCHES[f"{_POOL_KIND[grad_values.dtype]} {unit}"] += 1
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


def _check_assign(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                  values: torch.Tensor) -> None:
    _check_query(spec, features, points)
    if tuple(values.shape) != (points.shape[0], features.shape[1]):
        raise ValueError(f"values must be ({points.shape[0]}, {features.shape[1]}), "
                         f"got {tuple(values.shape)}")
    if values.device != points.device:
        raise ValueError(f"values on {values.device}, points on {points.device}")


def assign(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor, values: torch.Tensor,
           world: bool = True) -> torch.Tensor:
    """Write ``values`` (Q, D) into the feature rows that ``points`` (Q, 3)
    address, as a new pool; ``features`` is left as it was. Points in
    empty leaves or at rows >= M write nothing. Where several points
    address one row, the largest point id wins. Not differentiable.

    :return: the new (M, D) feature pool.
    """
    if points.is_cuda:
        return assign_cuda(spec, features, points, values, world)
    return assign_plain(spec, features, points, values, world)


def assign_plain(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                 values: torch.Tensor, world: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the assign kernel."""
    _check_assign(spec, features, points, values)
    pos = world2tree(points, spec.offset, spec.scaling) if world else points
    row = descend(spec, pos).data_idx
    ok = (row >= 0) & (row < features.shape[0])
    return write_rows(features, row[ok], values[ok])


def write_rows(pool: torch.Tensor, rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``pool`` with ``pool[rows[i]] = values[i]``, as a new tensor. Where
    rows repeat, the last occurrence wins (as a NumPy fancy assignment);
    for the points of `assign`, in id order, that is the largest id."""
    out = pool.detach().clone()
    if rows.numel() == 0:
        return out
    pos = torch.arange(rows.shape[0], device=rows.device)
    last = torch.full((pool.shape[0],), -1, dtype=torch.int64, device=rows.device)
    last.scatter_reduce_(0, rows.long(), pos, reduce="amax")
    hit = torch.nonzero(last >= 0).squeeze(1)
    out[hit] = values.detach().to(out.dtype)[last[hit]]
    return out


def assign_cuda(spec: TreeSpec, features: torch.Tensor, points: torch.Tensor,
                values: torch.Tensor, world: bool = True) -> torch.Tensor:
    """Launch the assign kernel (csrc/edit.cu): the winners' rows, then
    the new pool in one pass over it."""
    _check_assign(spec, features, points, values)
    tables = (spec.child_flat, spec.data_flat, spec.offset, spec.scaling)
    if not points.is_cuda or any(t.device != points.device for t in (features, values, *tables)):
        raise ValueError("assign_cuda needs points, pool, values and tree on one CUDA device")
    for t, dtype in zip((*tables, features, values), (torch.int32, torch.int32, *[torch.float32] * 4)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("child/data must be contiguous int32, offset/scaling/features/values float32")
    Q = points.shape[0]
    M, D = features.shape
    if Q >= 2 ** 31 or M >= 2 ** 31 or spec.child_flat.numel() >= 2 ** 31:
        raise ValueError("assign_cuda takes fewer than 2^31 points, rows and cells")
    points = points.contiguous()
    dev = points.device
    out = torch.empty_like(features)
    winner = torch.empty(M, dtype=torch.int32, device=dev)
    ASSIGN(
        points.data_ptr(), Q, int(bool(world)),
        spec.child_flat.data_ptr(), spec.data_flat.data_ptr(), spec.N, spec.n_levels,
        spec.offset.data_ptr(), spec.scaling.data_ptr(),
        features.data_ptr(), M, D, values.data_ptr(),
        winner.data_ptr(), out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def _unique_args(node_ids: torch.Tensor, size, n_cells):
    if node_ids.dtype != torch.int32 or node_ids.ndim != 1:
        raise ValueError(f"node_ids must be (Q,) int32, got {tuple(node_ids.shape)} {node_ids.dtype}")
    Q = node_ids.shape[0]
    size = Q if size is None else int(size)
    if n_cells is None:
        n_cells = int(node_ids.max()) + 1 if Q else 0
    if size < 0 or n_cells < 0:
        raise ValueError(f"size {size} and n_cells {n_cells} must be >= 0")
    return size, int(n_cells)


def unique_leaf_nodes(node_ids: torch.Tensor, N: int, size: int = None, n_cells: int = None):
    """The distinct leaves among packed leaf ids (the query's node ids).

    :param node_ids: (Q,) int32 packed leaf ids.
    :param N: the tree's branching factor, to unpack them.
    :param size: rows of the output (default Q, always enough).
    :param n_cells: the packed-id range, capacity * N^3; ids outside
        [0, n_cells) are left out. By default the largest id + 1, which
        waits for the card: the tree passes its own.
    :return: (leaf_node (size, 4) int32 [node, x, y, z] in ascending
        packed-id order, -1 rows after the last, count () int32, the
        number of rows filled: min(distinct ids, size)). Nothing is copied
        to the host.
    """
    if node_ids.is_cuda:
        return unique_leaf_nodes_cuda(node_ids, N, size, n_cells)
    return unique_leaf_nodes_plain(node_ids, N, size, n_cells)


def unique_leaf_nodes_plain(node_ids: torch.Tensor, N: int, size: int = None, n_cells: int = None):
    """Plain PyTorch version of the unique_leaf_nodes kernels."""
    size, n_cells = _unique_args(node_ids, size, n_cells)
    dev = node_ids.device
    uniq = torch.unique(node_ids[(node_ids >= 0) & (node_ids < n_cells)], sorted=True)[:size]
    out = torch.full((size, 4), -1, dtype=torch.int32, device=dev)
    out[: uniq.numel()] = unpack_index(uniq, N).to(torch.int32)
    return out, torch.tensor(uniq.numel(), dtype=torch.int32, device=dev)


def unique_leaf_nodes_cuda(node_ids: torch.Tensor, N: int, size: int = None, n_cells: int = None):
    """Launch the unique_leaf_nodes kernels (csrc/edit.cu): mark, count
    per tile, scan the tile counts, compact."""
    if not node_ids.is_cuda:
        raise ValueError("unique_leaf_nodes_cuda needs node_ids on a CUDA device")
    size, n_cells = _unique_args(node_ids, size, n_cells)
    Q = node_ids.shape[0]
    if Q >= 2 ** 31 or n_cells >= 2 ** 31 - _UNIQUE_TILE or size >= 2 ** 29:
        raise ValueError("unique_leaf_nodes_cuda takes fewer than 2^31 ids and cells, 2^29 rows")
    node_ids = node_ids.contiguous()
    dev = node_ids.device
    n_tiles = -(-n_cells // _UNIQUE_TILE)
    # flags first, so that their 16-byte loads are aligned; then the tile
    # sums and offsets
    scratch = torch.empty(n_cells + 2 * n_tiles, dtype=torch.int32, device=dev)
    out = torch.empty((size, 4), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    UNIQUE_LEAF(
        node_ids.data_ptr(), Q, n_cells, N, size,
        scratch.data_ptr(), scratch[n_cells:].data_ptr(), scratch[n_cells + n_tiles:].data_ptr(),
        out.data_ptr(), count.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out, count


def _check_indexer(spec: TreeSpec, indexer: torch.Tensor) -> None:
    if indexer.ndim != 2 or indexer.shape[1] != 4:
        raise ValueError(f"indexer must be (Q, 4), got {tuple(indexer.shape)}")
    if indexer.device != spec.device:
        raise ValueError(f"indexer on {indexer.device}, tree on {spec.device}")


def calc_corners(spec: TreeSpec, indexer: torch.Tensor) -> torch.Tensor:
    """Lower corners of leaf cells in tree coordinates [0, 1]^3: each
    (node, x, y, z) row walks its parent links to the root, at most
    ``n_levels + 1`` steps, folding ``out = (out + xyz) / N`` in float32.

    :param indexer: (Q, 4) integer [node, x, y, z].
    :return: (Q, 3) float32.
    """
    if indexer.is_cuda:
        return calc_corners_cuda(spec, indexer)
    return calc_corners_plain(spec, indexer)


def calc_corners_plain(spec: TreeSpec, indexer: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the calc_corners kernel."""
    _check_indexer(spec, indexer)
    N = spec.N
    parent = spec.parent_depth[:, 0]
    curr = indexer.to(torch.int32)
    out = torch.zeros((curr.shape[0], 3), dtype=torch.float32, device=curr.device)
    done = torch.zeros(curr.shape[0], dtype=torch.bool, device=curr.device)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which for N = 3 is not the division.
    n = torch.full((1, 3), float(N), device=curr.device)
    for _ in range(spec.n_levels + 1):
        out = torch.where(done[:, None], out, (out + curr[:, 1:].to(torch.float32)) / n)
        at_root = curr[:, 0] == 0
        nxt = unpack_index(parent[curr[:, 0].clamp(0, parent.shape[0] - 1).long()], N)
        curr = torch.where((done | at_root)[:, None], curr, nxt)
        done = done | at_root
    return out


def calc_corners_cuda(spec: TreeSpec, indexer: torch.Tensor) -> torch.Tensor:
    """Launch the calc_corners kernel (csrc/edit.cu)."""
    _check_indexer(spec, indexer)
    pd = spec.parent_depth
    if not indexer.is_cuda:
        raise ValueError("calc_corners_cuda needs the indexer and tree on one CUDA device")
    if indexer.dtype != torch.int32 or pd.dtype != torch.int32 or not pd.is_contiguous():
        raise ValueError("indexer and parent_depth must be int32")
    Q = indexer.shape[0]
    if Q >= 2 ** 29 or pd.shape[0] == 0:
        raise ValueError("calc_corners_cuda takes fewer than 2^29 rows and a non-empty tree")
    indexer = indexer.contiguous()
    dev = indexer.device
    out = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    if Q:
        CALC_CORNERS(indexer.data_ptr(), Q, pd.data_ptr(), pd.shape[0], spec.N, spec.n_levels + 1,
                     out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out
