"""Row-subset tape replay and minibatch tape training (K14): the
counterpart of `svox_t_tpu/ops/tape_subset.py`.

The canonical NeRF/Artemis training loop samples random pixels across a
fixed set of training cameras every step. The camera set is fixed, so the
rig's samples are recorded once (`record_tape`, a rig tape); a step
replays only the rays it drew.

The port's tapes are ray-major already (`RayTape`: ray i's samples are
entries ``offsets[i]`` to ``offsets[i + 1]`` of flat streams), so a subset
is a copy of runs: the new counts are ``counts[ids]`` and the new offsets
their exclusive sum, both made on the host from the source's host counts,
and K14a (`csrc/tape_subset.cu`) copies each chosen ray's run and
constants. The JAX package's packed int32 source matrix, count sort,
zero-occupancy prefix, chunks and shared round programs lay a TPU out and
have no counterpart here: ``chunk_size``, ``r_quant``, ``prog_K`` and
``bwd_prog_K`` are accepted and ignored, and a subset's rows come back in
``ids`` order.

  * `TapeRowSource`: a recorded tape with the host copies a subset needs
    (the per-ray counts).
  * `subset_tape`: a standalone `RayTape` of the rays ``ids`` (duplicates
    allowed); it works with every replay entry point.
  * `replay_render_rows`: `subset_tape` + `replay_render`, differentiable
    with respect to the pool.
  * `prep_minibatches` / `MinibatchPack`: the host half of
    `train_minibatches` (ids and new offsets per batch), to prepare the
    next batch set while the card runs this one.
  * `train_minibatches`: N sequential SGD steps over N minibatches; per
    step K14a, the replay K13c, K14b (the masked L2 loss's cotangent and
    the loss, which stays on the card), the tape backward K13d and the
    update (K14c, or the caller's ``update_fn``); step n + 1 replays the
    pool step n wrote.
  * `train_steps`: the same chain over every ray of one tape.

Every kernel dispatches on its tensors' device: on CUDA it launches (or
raises); on the CPU its plain PyTorch version runs.
"""

from __future__ import annotations

import dataclasses
import weakref
from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._build import Kernel
from ..utils.spec import RenderOptions
from .render import QuantizedFeatures, _require, _stream
from .tape import (RayTape, _check_replay, replay_backward, replay_backward_cuda,
                   replay_backward_plain, replay_forward, replay_render)

__all__ = ["TapeRowSource", "subset_tape", "replay_render_rows", "MinibatchPack",
           "prep_minibatches", "train_minibatches", "train_steps"]

SUBSET_GATHER = Kernel("svox_subset_gather", [
    c_void_p, c_void_p, c_void_p, c_int,   # src_offsets, ids, dst_offsets, B
    c_void_p, c_void_p, c_void_p, c_void_p,  # idx, dt (src, dst)
    c_void_p, c_void_p, c_void_p, c_void_p,  # t, cell (src, dst)
    c_void_p, c_void_p, c_void_p, c_void_p,  # vdirs, dscale (src, dst)
    c_void_p,                                # counts_dst
    c_void_p, c_void_p, c_void_p, c_void_p,  # origins, dirs (src, dst)
    c_int, c_void_p,
])
L2_COTANGENT = Kernel("svox_l2_cotangent", [
    c_void_p, c_int, c_int, c_void_p, c_int,  # out, B, C, targets, ld_tgt
    c_void_p, c_int, c_float,                 # ids, W, inv_bw
    c_void_p, c_void_p, c_void_p,             # grad_out, partials, loss
    c_int, c_void_p,
])
SGD_UPDATE = Kernel("svox_sgd_update", [c_void_p, c_void_p, c_longlong, c_float, c_int, c_void_p])


class TapeRowSource:
    """A recorded tape prepared for row-subset extraction.

    It keeps a reference to the tape's flat streams (nothing is copied or
    packed: the tape is ray-major already) and host copies of what a
    subset is planned from: ``counts_host`` (n_rays,) int32, each ray's
    sample count. A `MinibatchPack` is valid only for sources of the tape
    it was prepared against. ``keep_cells=True`` keeps the tree-cell stream (weight accumulation
    through a subset).
    """

    def __init__(self, tape: RayTape, *, keep_cells: bool = False):
        if tape.n_rays == 0:
            raise ValueError("empty tape")
        self.tape = tape
        self.keep_cells = bool(keep_cells and tape.cell is not None)
        self.counts_host = tape.counts.cpu().numpy().astype(np.int32)
        self.max_count = int(self.counts_host.max())

    @property
    def device(self) -> torch.device:
        return self.tape.device

    def check_ids(self, ids) -> np.ndarray:
        """``ids`` as an int64 host array, checked (JAX `prep`'s checks)."""
        ids = np.asarray(ids).reshape(-1)
        if ids.shape[0] == 0:
            raise ValueError("empty ray-id set")
        n_rays = self.tape.n_rays
        if ids.min() < 0 or ids.max() >= n_rays:
            raise ValueError(
                f"ray ids must be in [0, {n_rays}); got "
                f"[{ids.min()}, {ids.max()}]"
            )
        return ids.astype(np.int64, copy=False)


def _subset_plan(source: TapeRowSource, ids: np.ndarray):
    """(counts, offsets) of subsets ``ids`` (..., B): the chosen rays'
    int32 counts and the (..., B + 1) int32 offsets, their exclusive sums.
    Host work per batch set, so int32 sums wherever they cannot overflow."""
    counts = source.counts_host[ids]
    B = ids.shape[-1]
    offsets = np.zeros(ids.shape[:-1] + (B + 1,), np.int32)
    if B * source.max_count < 2 ** 31:
        np.cumsum(counts, axis=-1, dtype=np.int32, out=offsets[..., 1:])
        return counts, offsets
    sums = np.cumsum(counts, axis=-1, dtype=np.int64)
    if sums[..., -1].max() >= 2 ** 31:
        raise ValueError("the subset would hold 2^31 samples or more; int32 offsets address "
                         "fewer: take fewer rays per subset")
    offsets[..., 1:] = sums
    return counts, offsets


class _Streams(NamedTuple):
    idx: torch.Tensor
    dt: torch.Tensor
    tval: Optional[torch.Tensor]
    cell: Optional[torch.Tensor]
    vdirs: torch.Tensor
    dscale: torch.Tensor
    counts: torch.Tensor
    origins: Optional[torch.Tensor]
    dirs: Optional[torch.Tensor]


def _empty_streams(tape: RayTape, B: int, total: int, want_t: bool, want_cell: bool,
                   with_rays: bool) -> _Streams:
    dev = tape.device

    def ints(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    def floats(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    rays = (floats(B, 3), floats(B, 3)) if with_rays else (None, None)
    return _Streams(ints(total), floats(total), floats(total) if want_t else None,
                    ints(total) if want_cell else None, floats(B, 3), floats(B), ints(B), *rays)


def subset_gather_plain(tape: RayTape, ids, offsets, want_t: bool, want_cell: bool,
                        with_rays: bool) -> _Streams:
    """Plain PyTorch version of K14a: the streams of the subset tape of rays
    ``ids`` (B,) int32 at the new ``offsets`` (B + 1,) int32, every tensor
    on the tape's device (``tval`` and ``cell`` when wanted; ``origins`` and
    ``dirs`` with ``with_rays``, else None)."""
    ids = ids.long()
    src_start = tape.offsets[:-1].long()[ids]
    counts = tape.counts[ids]
    new_start = offsets[:-1].long()
    total = int(offsets[-1])
    ray = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device), counts.long(),
                                  output_size=total)
    pos = src_start[ray] + (torch.arange(total, device=ids.device) - new_start[ray])
    take = lambda s, want=True: s[pos] if want else None  # noqa: E731
    rays = (tape.origins[ids], tape.dirs[ids]) if with_rays else (None, None)
    return _Streams(take(tape.idx), take(tape.dt), take(tape.tval, want_t),
                    take(tape.cell, want_cell), tape.vdirs[ids], tape.dscale[ids],
                    counts.to(torch.int32), *rays)


def subset_gather_cuda(tape: RayTape, ids, offsets, want_t: bool, want_cell: bool,
                       with_rays: bool, total: Optional[int] = None) -> _Streams:
    """Launch K14a (csrc/tape_subset.cu): the streams of `subset_gather_plain`.
    ``total`` (= offsets[-1], from the host plan) saves a device read."""
    dev = tape.device
    B = ids.shape[0]
    ints = [tape.offsets, tape.idx, ids, offsets] + ([tape.cell] if want_cell else [])
    floats = [tape.dt, tape.vdirs, tape.dscale] + ([tape.tval] if want_t else []) + (
        [tape.origins, tape.dirs] if with_rays else [])
    for t in ints + floats:
        _require(t is not None and t.is_cuda and t.device == dev and t.is_contiguous(),
                 "subset_gather_cuda needs contiguous tensors on the tape's CUDA device")
    _require(all(t.dtype == torch.int32 for t in ints), "subset_gather_cuda: offsets, ids and streams "
             "must be int32")
    _require(all(t.dtype == torch.float32 for t in floats), "subset_gather_cuda: dt, t, vdirs, dscale "
             "and rays must be float32")
    _require(tuple(offsets.shape) == (B + 1,), "offsets must be (B + 1,)")
    total = int(offsets[-1]) if total is None else int(total)
    out = _empty_streams(tape, B, total, want_t, want_cell, with_rays)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if B:
        SUBSET_GATHER(tape.offsets.data_ptr(), ids.data_ptr(), offsets.data_ptr(), B,
                      tape.idx.data_ptr(), out.idx.data_ptr(), tape.dt.data_ptr(), out.dt.data_ptr(),
                      ptr(tape.tval) if want_t else None, ptr(out.tval),
                      ptr(tape.cell) if want_cell else None, ptr(out.cell),
                      tape.vdirs.data_ptr(), out.vdirs.data_ptr(), tape.dscale.data_ptr(),
                      out.dscale.data_ptr(), out.counts.data_ptr(),
                      ptr(tape.origins) if with_rays else None, ptr(out.origins),
                      ptr(tape.dirs) if with_rays else None, ptr(out.dirs), *_stream(dev))
    return out


def _gather(source: TapeRowSource, ids, offsets, total: int, want_t: bool, with_rays: bool):
    tape = source.tape
    # A data-indirect tape's cell stream is its sample stream: copied once.
    want_cell = source.keep_cells and not tape.indirect
    if tape.dt.is_cuda:
        s = subset_gather_cuda(tape, ids, offsets, want_t, want_cell, with_rays, total)
    else:
        s = subset_gather_plain(tape, ids, offsets, want_t, want_cell, with_rays)
    if source.keep_cells and tape.indirect:
        s = s._replace(cell=s.idx)
    return s


def _subset(source: TapeRowSource, s: _Streams, offsets, S: int, zeros3=None) -> RayTape:
    """The `RayTape` of gathered streams ``s`` (rays without ``origins`` /
    ``dirs`` get ``zeros3``, or new zeros)."""
    B = s.counts.shape[0]
    tape = source.tape
    if s.origins is None:
        if zeros3 is None:
            zeros3 = torch.zeros(B, 3, dtype=torch.float32, device=s.dt.device)
        s = s._replace(origins=zeros3, dirs=zeros3)
    return RayTape(
        idx=s.idx, dt=s.dt, cell=s.cell, offsets=offsets, counts=s.counts, origins=s.origins,
        dirs=s.dirs, vdirs=s.vdirs, dscale=s.dscale, n_rays=int(B), S=int(S),
        compact=tape.compact, n_features=tape.n_features, n_cells=tape.n_cells,
        geom=tape.geom, tval=s.tval, indirect=tape.indirect,
    )


def subset_tape(source, ids, *, chunk_size: int = 512,
                r_quant: int = 8, with_rays: bool = True,
                prog_K: int = 0, bwd_prog_K: int = 0) -> RayTape:
    """Standalone :class:`RayTape` over an arbitrary subset of a recorded
    tape's rays, in ``ids`` order.

    ``source`` is a :class:`TapeRowSource` (or a RayTape, converted on the
    fly — build the source once when subsetting repeatedly). ``ids`` is a
    host int array of original ray indices (duplicates allowed: sampling
    with replacement replays the row twice). The subset replays and
    backpropagates through every tape entry point, and row k of its
    replay is ray ``ids[k]``'s row of the full replay, bit for bit.
    ``with_rays`` copies the rays' origins and dirs too (the thresholded
    backward's march fallback reads them; else zeros). ``chunk_size``,
    ``r_quant``, ``prog_K`` and ``bwd_prog_K`` lay out the JAX package's
    TPU chunks: accepted and ignored."""
    del chunk_size, r_quant, prog_K, bwd_prog_K
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    ids = source.check_ids(ids)
    counts, offsets_np = _subset_plan(source, ids)
    dev = source.device
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    offsets = torch.from_numpy(offsets_np).to(dev)
    s = _gather(source, ids_t, offsets, int(offsets_np[-1]), source.tape.tval is not None, with_rays)
    return _subset(source, s, offsets, int(counts.max()))


def replay_render_rows(source, ids, features, opt: RenderOptions,
                       spec=None, *, unsort: bool = True,
                       index_table=None, chunk_size: int = 512):
    """Replay only the rays in ``ids``: :func:`subset_tape` +
    :func:`~.tape.replay_render`. Differentiable with respect to
    ``features``; the gradient equals the full replay's gradient of a loss
    restricted to these rays. Returns (len(ids), n_color + 1) in ``ids``
    order (``unsort`` is accepted for the JAX API)."""
    tape = subset_tape(source, ids, chunk_size=chunk_size)
    return replay_render(tape, features, opt, spec, unsort=unsort, index_table=index_table)


# ---------------------------------------------------------------------------
# The training chain (K14b, K14c)


def l2_cotangent_plain(out, targets, ids, W: int, inv_bw: float):
    """Plain PyTorch version of K14b: (grad_out (B, C) float32, loss ()
    float32). Columns c < W: err = out - targets[ids] (targets[i] without
    ``ids``), grad (err * inv_bw) * 2; other columns 0; loss sum(err *
    err) * inv_bw."""
    tgt = targets[:out.shape[0], :W] if ids is None else targets[ids.long(), :W]
    err = out[:, :W] - tgt
    grad = torch.zeros_like(out)
    grad[:, :W] = (err * inv_bw) * 2.0
    loss = (err * err).sum(dtype=torch.float64).to(torch.float32) * inv_bw
    return grad, loss


def l2_cotangent_cuda(out, targets, ids, W: int, inv_bw: float, loss=None):
    """Launch K14b (csrc/tape_subset.cu): (grad_out, loss) as
    `l2_cotangent_plain`; the loss is written into ``loss`` (a one-element
    float32 view on the card) when given, so a chain of steps never reads
    it back."""
    dev = out.device
    B, C = out.shape
    ts = [out, targets] + ([] if ids is None else [ids]) + ([] if loss is None else [loss])
    for t in ts:
        _require(t.is_cuda and t.device == dev, "l2_cotangent_cuda needs all tensors on one CUDA device")
    _require(out.is_contiguous() and out.dtype == torch.float32, "out must be contiguous float32")
    _require(targets.dtype == torch.float32 and targets.ndim == 2 and targets.stride(1) == 1,
             "targets must be (n, W') float32 with unit column stride")
    _require(0 <= W <= min(C, targets.shape[1]), f"loss columns {W} exceed the rows' {C} or the "
             f"targets' {targets.shape[1]}")
    _require(ids is None or (ids.dtype == torch.int32 and ids.is_contiguous() and ids.shape == (B,)),
             "ids must be contiguous (B,) int32")
    _require(ids is not None or targets.shape[0] >= B, "targets hold fewer rows than the batch")
    _require(loss is None or (loss.dtype == torch.float32 and loss.numel() == 1),
             "loss must be one float32")
    grad = torch.empty_like(out)
    partials = torch.empty((B + 255) // 256, dtype=torch.float32, device=dev)
    if loss is None:
        loss = torch.empty((), dtype=torch.float32, device=dev)
    L2_COTANGENT(out.data_ptr(), B, C, targets.data_ptr(), targets.stride(0),
                 None if ids is None else ids.data_ptr(), W, inv_bw, grad.data_ptr(),
                 partials.data_ptr(), loss.data_ptr(), *_stream(dev))
    return grad, loss.reshape(())


def sgd_plain(features, grad, lr: float):
    """Plain PyTorch version of K14c: ``features -= lr * grad`` in place on a
    float32 pool, the product and the difference each rounded, as the JAX
    package's `features - lr * grad`."""
    return features.sub_(grad * lr)


def sgd_cuda(features, grad, lr: float):
    """Launch K14c (csrc/tape_subset.cu): `sgd_plain` on the card, in place
    on a contiguous float32 pool with a float32 gradient."""
    _require(features.is_cuda and grad.is_cuda and features.device == grad.device,
             "sgd_cuda needs the pool and its gradient on one CUDA device")
    _require(features.dtype == torch.float32 and grad.dtype == torch.float32
             and grad.shape == features.shape and features.is_contiguous() and grad.is_contiguous(),
             "sgd_cuda needs a contiguous float32 pool and a float32 gradient of its shape")
    SGD_UPDATE(features.data_ptr(), grad.data_ptr(), features.numel(), lr, *_stream(features.device))
    return features


def _check_exact(opt: RenderOptions, who: str):
    if opt.sigma_thresh != 0.0 or opt.stop_thresh > 0.0:
        raise ValueError(
            f"{who} requires exact-mode options (sigma_thresh=0, "
            "stop_thresh=0): the thresholded tape backward falls back "
            "to a march over the stored rays, which the packed training "
            "source does not carry"
        )


@dataclasses.dataclass(frozen=True)
class MinibatchPack:
    """Host-side product of :func:`prep_minibatches`: everything
    `train_minibatches` needs besides device data. Build the next pack
    while the card runs the current call.

    ids (N, B) int32 ray ids per step; offsets (N, B + 1) int32 the
    subsets' offsets; S (N,) their largest counts; n_rays and a weak
    reference to the tape they were prepared against."""

    ids: np.ndarray
    offsets: np.ndarray
    S: np.ndarray
    n_rays: int
    tape: weakref.ref


def prep_minibatches(source, ids_batches, *, chunk_size: int = 512,
                     r_quant: int = 16, prog_K: int = 0,
                     bwd_prog_K: int = 0) -> MinibatchPack:
    """Host-only phase of :func:`train_minibatches`: per batch the checked
    ids and the new offsets (NumPy; no device work). ``chunk_size``,
    ``r_quant``, ``prog_K`` and ``bwd_prog_K`` lay out the JAX package's TPU
    chunks: accepted and ignored."""
    del chunk_size, r_quant, prog_K, bwd_prog_K
    ids_batches = np.asarray(ids_batches)
    if ids_batches.ndim != 2:
        raise ValueError("ids_batches must be (N, B)")
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    ids = source.check_ids(ids_batches).reshape(ids_batches.shape)
    counts, offsets = _subset_plan(source, ids)
    return MinibatchPack(ids=ids.astype(np.int32), offsets=offsets, S=counts.max(axis=1),
                         n_rays=source.tape.n_rays, tape=weakref.ref(source.tape))


def _grad32(tape: RayTape, features, opt: RenderOptions, grad_out, out, spec, index_table):
    """The pool gradient of a replay as float32 (the tape backward K13d in
    exact mode, uncast; thresholded modes `replay_backward`'s fallback)."""
    if opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0:
        run = replay_backward_cuda if tape.dt.is_cuda else replay_backward_plain
        return run(tape, features, opt, grad_out, out, spec, index_table).float()
    return replay_backward(tape, features, opt, grad_out, out, spec, index_table).float()


class _Chain:
    """What the steps of one training call share: the working pool (a
    copy; the caller's is never written), the targets, the update and the
    per-step losses on the pool's device."""

    def __init__(self, features, targets, n_steps: int, lr: float, update_fn, update_state,
                 loss_cols, dev: torch.device):
        if isinstance(features, QuantizedFeatures):
            raise TypeError("a quantized feature pool takes no gradient")
        features = torch.as_tensor(features, device=dev)
        if update_fn is None and features.dtype != torch.float32:
            # The tape gradient is float32, so `features - lr * grad` would
            # change the pool's type, which the JAX package's scan refuses.
            raise TypeError(f"the default SGD update takes a float32 pool, not {features.dtype}: "
                            "the tape gradient is float32 (the JAX package's trainer refuses "
                            "such a pool too); pass an update_fn that keeps the pool's type")
        self.f = features.detach().clone(memory_format=torch.contiguous_format)
        if not isinstance(targets, torch.Tensor):
            targets = np.array(targets, np.float32)
        self.targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        if self.targets.ndim != 2:
            raise ValueError(f"targets must be (n_rays, W), got {tuple(self.targets.shape)}")
        if self.targets.stride(1) != 1:
            self.targets = self.targets.contiguous()
        self.W = int(loss_cols) if loss_cols else int(self.targets.shape[1])
        self.lr = float(lr)
        self.update_fn, self.state = update_fn, update_state
        self.losses = torch.empty(n_steps, dtype=torch.float32, device=dev)

    def step(self, n: int, tape: RayTape, ids, opt: RenderOptions, spec, index_table) -> None:
        f = self.f
        out, _ = replay_forward(tape, f, opt, spec, False, index_table)
        inv_bw = 1.0 / float(max(tape.n_rays * self.W, 1))
        if out.is_cuda:
            grad_out, _ = l2_cotangent_cuda(out, self.targets, ids, self.W, inv_bw, self.losses[n:n + 1])
        else:
            grad_out, self.losses[n] = l2_cotangent_plain(out, self.targets, ids, self.W, inv_bw)
        g = _grad32(tape, f, opt, grad_out, out, spec, index_table)
        if self.update_fn is None:
            (sgd_cuda if f.is_cuda else sgd_plain)(f, g, self.lr)
            return
        self.f, self.state = self.update_fn(f, g, self.state)
        if self.f.dtype != f.dtype or self.f.shape != f.shape:
            raise TypeError(f"update_fn returned a {self.f.dtype} {tuple(self.f.shape)} pool for a "
                            f"{f.dtype} {tuple(f.shape)} one")

    def result(self):
        return self.f, self.losses, self.state


def train_minibatches(source, ids_batches, targets, features,
                      opt: RenderOptions, *,
                      lr: float = 1e-2,
                      update_fn: Optional[Callable] = None,
                      update_state=(),
                      spec=None, index_table=None,
                      chunk_size: int = 512, r_quant: int = 16,
                      loss_cols: Optional[int] = None,
                      prog_K: int = 0, bwd_prog_K: int = 0):
    """N sequential SGD steps over N random-ray minibatches — the canonical
    random-pixel training loop at tape rates.

    Per step n: K14a copies minibatch n's runs out of the source, the
    replay K13c renders them, K14b forms the L2 loss against ``targets``
    rows and its cotangent, the tape backward K13d the pool gradient, and
    ``update_fn`` (default K14c, SGD with ``lr``) updates a working copy
    of the pool; step n + 1 replays the updated pool. The caller's
    ``features`` are never written. The losses stay on the pool's device
    (no host read per step).

    LOSS: per step sum((out[:, :W] - targets[ids, :W])^2) / (B * W) over
    all B rays of the batch. The JAX package leaves out the rays of its
    zero-occupancy prefix chunks (they carry no gradient), so its value is
    at most this one; the feature trajectory is the same.

    :param ids_batches: (N, B) host int array of ray ids per step, or a
        :func:`prep_minibatches` pack of this source's tape (a pack of
        another tape raises, even one recorded from the same rays). ``chunk_size``, ``r_quant``, ``prog_K`` and
        ``bwd_prog_K`` lay out the JAX package's TPU chunks: accepted and
        ignored, with or without a pack.
    :param targets: (n_rays, W) per-ray targets in original ray order.
    :param update_fn: ``(features, grad, state) -> (features, state)``;
        ``grad`` float32, as the JAX package's tape gradient; the pool
        keeps its type and shape. Default plain SGD (K14c), float32
        pools only.
    :return: (features_out, losses (N,), update_state_out).
    """
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    if isinstance(ids_batches, MinibatchPack):
        pack = ids_batches
        if pack.tape() is not source.tape:
            raise ValueError(
                "MinibatchPack was prepped against a different source tape "
                f"(pack: {pack.n_rays} rays; source: {source.tape.n_rays} rays)"
            )
    else:
        pack = prep_minibatches(source, ids_batches)
    del chunk_size, r_quant, prog_K, bwd_prog_K
    _check_exact(opt, "train_minibatches")
    dev = source.device
    N, B = pack.ids.shape
    chain = _Chain(features, targets, N, lr, update_fn, update_state, loss_cols, dev)
    if chain.targets.shape[0] < source.tape.n_rays:
        raise ValueError(f"targets hold {chain.targets.shape[0]} rows for {source.tape.n_rays} rays")
    _check_replay(source.tape, chain.f, opt, spec, index_table)
    ids_all = torch.from_numpy(pack.ids).to(dev)
    offsets_all = torch.from_numpy(pack.offsets).to(dev)
    zeros3 = torch.zeros(B, 3, dtype=torch.float32, device=dev)
    for n in range(N):
        s = _gather(source, ids_all[n], offsets_all[n], int(pack.offsets[n, -1]), False, False)
        tape = _subset(source, s, offsets_all[n], int(pack.S[n]), zeros3)
        chain.step(n, tape, ids_all[n], opt, spec, index_table)
    return chain.result()


def train_steps(tape: RayTape, targets, features, opt: RenderOptions,
                n_steps: int, *, lr: float = 1e-2,
                update_fn: Optional[Callable] = None, update_state=(),
                spec=None, index_table=None,
                loss_cols: Optional[int] = None):
    """N sequential full-batch SGD steps over one recorded tape — the
    fixed-ray training chain (every step sees every recorded ray; for
    random minibatches use :func:`train_minibatches`).

    Step n: replay forward (K13c), L2 loss against ``targets`` (original
    ray order, which is the tape's) and its cotangent (K14b), tape
    backward (K13d; thresholded options take `replay_backward`'s march
    fallback), update (K14c, or ``update_fn``); step n + 1 replays the
    updated pool. The caller's ``features`` are never written.

    :param targets: (n_rays, W) per-ray target rows, original order.
    :return: (features_out, losses (n_steps,), update_state_out).
    """
    chain = _Chain(features, targets, int(n_steps), lr, update_fn, update_state, loss_cols,
                   tape.device)
    if chain.targets.shape[0] != tape.n_rays:
        raise ValueError(f"targets hold {chain.targets.shape[0]} rows for {tape.n_rays} rays")
    for n in range(int(n_steps)):
        chain.step(n, tape, None, opt, spec, index_table)
    return chain.result()

