"""Linear-blend-skinning (LBS) vertex warp, the counterpart of
`svox_t_tpu/ops/warp.py`.

`warp_vertices` blends each point's per-joint 4x4 transforms by its
skinning weights and applies the blend to the point. It is a
`torch.autograd.Function` (`_WarpFn`) with gradients for the transforms,
the points and the weights; the JAX package took both directions from
XLA's autodiff of an einsum. On CUDA tensors the forward and backward
launch their kernels (`csrc/warp.cu`) or raise; on CPU tensors the plain
PyTorch versions run. The semantics are the JAX package's:

  * a weight w <= 0 is skipped (counts as 0) and gets a zero gradient;
  * joint ids are read as a JAX gather reads them: a negative id wraps
    once (j + J), then is clamped to [0, J); the transform gradient is
    that gather's transpose as XLA forms it, which drops ids outside
    [0, J) after the wrap;
  * rows 0-2 of the blend are sum_b w_b T[j_b][0:3, :] in bone order, row
    3 is [0, 0, 0, 1]; the warped point is A[:, :3] x + A[:, 3].

`get_transformation_matrix` (tgt @ inv(src) on (J, 4, 4)) is plain
PyTorch, as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from .. import _build
from .._build import Kernel
from .render import _stream

WARP_FWD = Kernel(
    "svox_warp_fwd",
    [c_void_p, c_int, c_void_p, c_void_p, c_void_p, c_int, c_int,  # T, J, x, w, ji, Q, nb
     c_void_p, c_void_p, c_int, c_void_p],                         # warped, mats, device, stream
)
WARP_BWD = Kernel(
    "svox_warp_bwd",
    [c_void_p, c_int, c_void_p, c_void_p, c_void_p, c_int, c_int,  # T, J, x, w, ji, Q, nb
     c_void_p, c_void_p,                                           # g_x, g_M
     c_void_p, c_void_p, c_void_p,                                 # dT, dx, dw
     c_int, c_void_p],                                             # device, stream
)

# The backward kernel's threads a block, points a thread sums in registers
# and joints its register cache holds (`kThreads`, `kRun`, `kSlots` in
# csrc/warp.cu).
RUN_BLOCK = 256
RUN_POINTS = 8
RUN_SLOTS = 4
WARP = 32


def kernel_max_joints() -> int:
    """Largest joint count the backward kernel's shared (J, 12) table
    holds when the transform gradient is wanted, as the library reports
    it (`kMaxJoints` in csrc/warp.cu); builds the library if need be."""
    return _build._lib().svox_warp_max_joints()


def get_transformation_matrix(src_pose: torch.Tensor, tgt_pose: torch.Tensor) -> torch.Tensor:
    """Relative bone transforms ``tgt @ inv(src)``, (J, 4, 4). A singular
    ``src`` gives non-finite entries, as in the JAX package; nothing
    raises."""
    return torch.matmul(tgt_pose, torch.linalg.inv_ex(src_pose).inverse)


def warp_vertices(transformation_matrix: torch.Tensor, coordinates: torch.Tensor,
                  skinning_weights: torch.Tensor, joint_index: torch.Tensor):
    """LBS-warp a point cloud; differentiable with respect to the
    transforms, the coordinates and the skinning weights.

    :param transformation_matrix: (J, 4, 4) float32 per-joint transforms
    :param coordinates: (Q, 3) float32 canonical points
    :param skinning_weights: (Q, n_bones) float32
    :param joint_index: (Q, n_bones) integer joint ids
    :return: (warped (Q, 3), blended matrices (Q, 4, 4))
    """
    if joint_index.dtype != torch.int32:
        joint_index = joint_index.to(torch.int32)
    return _WarpFn.apply(transformation_matrix, coordinates, skinning_weights, joint_index)


def blend_transformation_matrix(transformation_matrix: torch.Tensor,
                                skinning_weights: torch.Tensor,
                                joint_index: torch.Tensor) -> torch.Tensor:
    """Blend per-joint 4x4 transforms by skinning weights, (Q, 4, 4); rows
    0-2 blended, row 3 [0, 0, 0, 1]. One warp of the origin: the same
    kernel, its warped points dropped."""
    Q = skinning_weights.shape[0]
    origin = torch.zeros(Q, 3, dtype=skinning_weights.dtype, device=skinning_weights.device)
    return warp_vertices(transformation_matrix, origin, skinning_weights, joint_index)[1]


class _WarpFn(torch.autograd.Function):
    """`warp_vertices` with its backward kernel; either output's gradient
    may be absent, and only the gradients the inputs need are formed."""

    @staticmethod
    def forward(ctx, T, x, w, ji):
        fwd = warp_forward_cuda if x.is_cuda else warp_forward_plain
        warped, mats = fwd(T, x, w, ji)
        ctx.save_for_backward(T, x, w, ji)
        ctx.set_materialize_grads(False)
        return warped, mats

    @staticmethod
    def backward(ctx, g_x, g_M):
        want = ctx.needs_input_grad[:3]
        if not any(want) or (g_x is None and g_M is None):
            return None, None, None, None
        T, x, w, ji = ctx.saved_tensors
        g_x = None if g_x is None else g_x.contiguous()
        g_M = None if g_M is None else g_M.contiguous()
        bwd = warp_backward_cuda if x.is_cuda else warp_backward_plain
        dT, dx, dw = bwd(T, x, w, ji, g_x, g_M, *want)
        return dT, dx, dw, None


def _check(T, x, w, ji) -> None:
    if T.ndim != 3 or tuple(T.shape[1:]) != (4, 4) or T.shape[0] < 1:
        raise ValueError(f"transformation_matrix must be (J, 4, 4), got {tuple(T.shape)}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"coordinates must be (Q, 3), got {tuple(x.shape)}")
    if w.ndim != 2 or w.shape[0] != x.shape[0] or tuple(ji.shape) != tuple(w.shape):
        raise ValueError(f"skinning_weights and joint_index must be (Q, n_bones) with Q = "
                         f"{x.shape[0]}, got {tuple(w.shape)} and {tuple(ji.shape)}")
    for t in (T, x, w):
        if t.dtype != torch.float32:
            raise ValueError("transforms, coordinates and skinning weights must be float32")
    if ji.dtype != torch.int32:
        raise ValueError("joint_index must be int32")
    devices = {t.device for t in (T, x, w, ji)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _joint_rows(ji: torch.Tensor, J: int) -> torch.Tensor:
    """The rows of T that joint ids read: wrapped once, then clamped."""
    j = ji.long()
    return torch.where(j < 0, j + J, j).clamp(0, J - 1)


def _blend_plain(T, w, ji) -> torch.Tensor:
    """(Q, 3, 4): sum_b w_b T[j_b][0:3, :] over bones with w_b > 0, in
    bone order, as the kernel sums."""
    rows = T[_joint_rows(ji, T.shape[0])][:, :, :3, :]
    A = torch.zeros(w.shape[0], 3, 4, dtype=T.dtype, device=T.device)
    for b in range(w.shape[1]):
        wb = w[:, b, None, None]
        A = torch.where(wb > 0, A + wb * rows[:, b], A)
    return A


def warp_forward_plain(T, x, w, ji):
    """Plain PyTorch version of the warp forward kernel: (warped (Q, 3),
    mats (Q, 4, 4))."""
    _check(T, x, w, ji)
    A = _blend_plain(T, w, ji)
    warped = torch.stack(
        [((A[:, i, 0] * x[:, 0] + A[:, i, 1] * x[:, 1]) + A[:, i, 2] * x[:, 2]) + A[:, i, 3]
         for i in range(3)], dim=1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    mats = torch.cat([A, bottom.expand(x.shape[0], 1, 4)], dim=1)
    return warped, mats


def _outer_grad(x, g_x, g_M):
    """G = g_M[:, 0:3, :] + g_x (x, 1)^T, (Q, 3, 4); absent terms drop."""
    G = None if g_M is None else g_M[:, :3, :]
    if g_x is not None:
        xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        outer = g_x[:, :, None] * xh[:, None, :]
        G = outer if G is None else G + outer
    return G


def warp_backward_plain(T, x, w, ji, g_x, g_M, want_T=True, want_x=True, want_w=True):
    """Plain PyTorch version of the warp backward kernel: (dT (J, 4, 4),
    dx (Q, 3), dw (Q, n_bones)), each None where not wanted.

    Every entry of dT sums one term per point and bone of that joint (~10^6
    at the scale the port serves), so the terms, computed as the kernel
    computes them, are summed in float64: this version is then the exact
    sum the kernel's float32 atomics approximate."""
    _check(T, x, w, ji)
    Q, nb = w.shape
    J = T.shape[0]
    G = _outer_grad(x, g_x, g_M)
    if G is None:
        G = torch.zeros(Q, 3, 4, dtype=T.dtype, device=T.device)
    gx = g_x if g_x is not None else torch.zeros_like(x)
    dT = dx = dw = None
    if want_x:
        A = _blend_plain(T, w, ji)
        dx = torch.stack(
            [(A[:, 0, k] * gx[:, 0] + A[:, 1, k] * gx[:, 1]) + A[:, 2, k] * gx[:, 2]
             for k in range(3)], dim=1)
    ok = w > 0
    if want_w:
        rows = T[_joint_rows(ji, J)][:, :, :3, :].reshape(Q, nb, 12)
        prod = rows * G.reshape(Q, 1, 12)
        s = prod[:, :, 0]
        for e in range(1, 12):
            s = s + prod[:, :, e]
        dw = torch.where(ok, s, 0.0)
    if want_T:
        dT = torch.zeros(J, 4, 4, dtype=torch.float64, device=T.device)
        j = ji.long()
        jw = torch.where(j < 0, j + J, j)
        keep = ok & (jw >= 0) & (jw < J)
        for b in range(nb):
            kb = keep[:, b]
            terms = w[kb, b, None, None] * G[kb]
            dT[:, :3, :].index_add_(0, jw[kb, b], terms.double())
        dT = dT.to(T.dtype)
    return dT, dx, dw


def _warp_flush_adds(ids, rounds: int) -> tuple:
    """The adds that csrc/warp.cu's `warp_flush` makes of the entries
    ``ids`` (threads, k) (-1: none), threads in whole warps: (warp adds, a
    joint's sum each; lane adds). An entry k whose joint is one in all 32
    lanes is one warp add; then each of ``rounds`` rounds takes the joint of
    the first lane's first entry left, a warp add if another lane's first
    entry left names it too, else lane adds; the entries left after the
    rounds are lane adds."""
    k = ids.shape[1]
    w = ids.reshape(-1, WARP, k)
    uniform = (w == w[:, :1]).all(dim=1)
    adds = int((uniform & (w[:, 0] >= 0)).sum())
    left = (w >= 0) & ~uniform[:, None, :]
    flat = w.reshape(-1, WARP * k)
    rows = torch.arange(flat.shape[0], device=ids.device)
    lane_adds = 0
    for _ in range(rounds):
        lw = left.reshape(-1, WARP * k)
        has = lw.any(dim=1)
        if not bool(has.any()):
            break
        j = torch.where(has, flat[rows, lw.int().argmax(dim=1)], -2)
        # The first lane's first entry left names j; a joint that no other
        # lane's first entry left names goes lane by lane.
        mine = torch.where(left.any(dim=2), w.gather(2, left.int().argmax(dim=2, keepdim=True))[..., 0], -1)
        take = left & (w == j[:, None, None])
        shared = (mine == j[:, None]).sum(dim=1) >= 2
        adds += int((has & shared).sum())
        lane_adds += int((take & ~shared[:, None, None]).sum())
        left = left & ~take
    return adds, lane_adds + int(left.sum())


def warp_dT_runs_plain(T, x, w, ji, g_x, g_M, block: int = RUN_BLOCK, run: int = RUN_POINTS,
                       slots: int = RUN_SLOTS):
    """Plain mirror of the backward kernel's dT sum order: (dT (J, 4, 4),
    census). Warp v of block k takes ``run`` steps of 32 consecutive
    points (lane l's step r: point k * block * run + v * 32 * run + r * 32
    + l), and each thread sums each kept bone's term w_b G in float32 into
    a cache of ``slots`` joints (a hit adds into its slot; a miss flushes
    the least recently used slot into the block's table first); the run's
    end flushes every slot. The block tables are summed into dT. The terms
    are `warp_backward_plain`'s, summed into the tables lane by lane; the
    kernel's warps add each flush joint by joint (`_warp_flush_adds`),
    which the census counts: ``terms``, ``hits``, ``evictions`` (slots
    flushed on a miss), ``evict_warp_adds`` and ``evict_lane_adds`` (their
    adds), ``end_warp_adds`` and ``end_lane_adds`` (the run's end's), and
    ``shared_adds`` (12 an add)."""
    _check(T, x, w, ji)
    Q, nb = w.shape
    J = T.shape[0]
    dev = T.device
    G = _outer_grad(x, g_x, g_M)
    if G is None:
        G = torch.zeros(Q, 3, 4, dtype=T.dtype, device=dev)
    G = G.reshape(Q, 12)
    span = block * run
    B = -(-Q // span)
    # (threads, run): the point of each thread's step, Q and past for none.
    q = torch.arange(B * span, device=dev).reshape(B, block // WARP, run, WARP).transpose(2, 3).reshape(-1, run)
    n = q.shape[0]
    blk = torch.arange(n, device=dev) // block
    ids = torch.full((n, slots), -1, dtype=torch.int64, device=dev)
    used = torch.full((n, slots), -1, dtype=torch.int64, device=dev)
    sums = torch.zeros(n, slots, 12, dtype=torch.float32, device=dev)
    table = torch.zeros(B * J, 12, dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    j = ji.long()
    jw = torch.where(j < 0, j + J, j)
    keep = (w > 0) & (jw >= 0) & (jw < J)
    census = dict(terms=0, hits=0, evictions=0, evict_warp_adds=0, evict_lane_adds=0)
    step = 0
    for r in range(run):
        qr = q[:, r]
        live = qr < Q
        qc = qr.clamp(max=max(Q - 1, 0))
        for b in range(nb):
            step += 1
            ok = live & keep[qc, b]
            jb = jw[qc, b]
            term = w[qc, b, None] * G[qc]
            hit = (ids == jb[:, None]) & ok[:, None]
            sums = torch.where(hit[:, :, None], sums + term[:, None, :], sums)
            used = torch.where(hit, step, used)
            miss = ok & ~hit.any(dim=1)
            victim = used.argmin(dim=1)
            out = miss & (ids[rows, victim] >= 0)
            table.index_add_(0, (blk * J + ids[rows, victim])[out], sums[rows, victim][out])
            warp_adds, lane_adds = _warp_flush_adds(torch.where(out, ids[rows, victim], -1)[:, None], 2 * slots)
            census["evict_warp_adds"] += warp_adds
            census["evict_lane_adds"] += lane_adds
            at = miss[:, None] & (torch.arange(slots, device=dev) == victim[:, None])
            ids = torch.where(at, jb[:, None], ids)
            used = torch.where(at, step, used)
            sums = torch.where(at[:, :, None], term[:, None, :], sums)
            census["terms"] += int(ok.sum())
            census["hits"] += int(hit.any(dim=1).sum())
            census["evictions"] += int(out.sum())
    # The run's end: every slot left to the table.
    live = ids >= 0
    table.index_add_(0, (blk[:, None] * J + ids)[live], sums[live])
    census["end_warp_adds"], census["end_lane_adds"] = _warp_flush_adds(ids, 2 * slots)
    census["shared_adds"] = 12 * (census["evict_warp_adds"] + census["evict_lane_adds"]
                                  + census["end_warp_adds"] + census["end_lane_adds"])
    dT = torch.zeros(J, 4, 4, dtype=T.dtype, device=dev)
    dT[:, :3, :] = table.reshape(B, J, 12).sum(dim=0).reshape(J, 3, 4)
    return dT, census


def _check_cuda(T, x, w, ji, name: str) -> None:
    _check(T, x, w, ji)
    for t in (T, x, w, ji):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} needs contiguous CUDA tensors")
    if x.shape[0] >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^31 points and bones")


def warp_forward_cuda(T, x, w, ji):
    """Launch the warp forward kernel (csrc/warp.cu)."""
    _check_cuda(T, x, w, ji, "warp_forward_cuda")
    Q, nb = w.shape
    dev = x.device
    warped = torch.empty(Q, 3, dtype=torch.float32, device=dev)
    mats = torch.empty(Q, 4, 4, dtype=torch.float32, device=dev)
    if Q == 0:
        return warped, mats
    WARP_FWD(T.data_ptr(), T.shape[0], x.data_ptr(), w.data_ptr(), ji.data_ptr(), Q, nb,
             warped.data_ptr(), mats.data_ptr(), *_stream(dev))
    return warped, mats


def warp_backward_cuda(T, x, w, ji, g_x, g_M, want_T=True, want_x=True, want_w=True):
    """Launch the warp backward kernel (csrc/warp.cu): (dT, dx, dw), each
    None where not wanted. With dT wanted, J is at most
    `kernel_max_joints()`."""
    _check_cuda(T, x, w, ji, "warp_backward_cuda")
    Q, nb = w.shape
    J = T.shape[0]
    for g, shape in ((g_x, (Q, 3)), (g_M, (Q, 4, 4))):
        if g is None:
            continue
        if tuple(g.shape) != shape or g.dtype != torch.float32:
            raise ValueError(f"output gradient must be {shape} float32, got {tuple(g.shape)} {g.dtype}")
        if not (g.is_contiguous() and g.device == x.device):
            raise ValueError("output gradients must be contiguous on the points' device")
    if want_T and J > (limit := kernel_max_joints()):
        raise NotImplementedError(
            f"the warp backward kernel holds at most {limit} joints in shared memory, got {J}")
    dev = x.device
    dT = torch.zeros(J, 4, 4, dtype=torch.float32, device=dev) if want_T else None
    dx = torch.empty(Q, 3, dtype=torch.float32, device=dev) if want_x else None
    dw = torch.empty(Q, nb, dtype=torch.float32, device=dev) if want_w else None
    if Q == 0:
        return dT, dx, dw

    def ptr(t):
        return None if t is None else t.data_ptr()

    WARP_BWD(T.data_ptr(), J, x.data_ptr(), w.data_ptr(), ji.data_ptr(), Q, nb,
             ptr(g_x), ptr(g_M), ptr(dT), ptr(dx), ptr(dw), *_stream(dev))
    return dT, dx, dw
