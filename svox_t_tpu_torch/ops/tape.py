"""Recorded sample tapes (K13): the counterpart of `svox_t_tpu/ops/tape.py`.

A ray's samples (row, step) depend only on the ray, the tree's structure
and the march's geometry options, not on the feature values. A tape
records them once per (rays x structure x geometry); a replay then
composites any feature pool over them with no structure walk: the
serving path for a fixed camera and animated features, and a training
step's forward and backward.

The layout is the GPU's, not the TPU's: rays stay in input order, and ray
i's samples are one run of a flat buffer, ``offsets[i]`` to
``offsets[i + 1]`` (``offsets`` the cumulative sum of ``counts``). The
JAX package's count-sorted chunks, round programs, zero-chunk prefix and
block grouping schedule a TPU and have no counterpart here; ``inv_pos`` is
the identity, and `record_tape` accepts ``chunk_size``,
``prog_round_size`` and ``group_size`` and ignores them.

  * `record_tape`: K13a+K13b walks each ray once, as the forward march K2
    walks it, every step taken: it counts the ray's samples (occupied,
    total) and stages the recorded ones (every sample, or with ``compact``
    only the occupied ones, rows in [0, n_features)) in an arena of
    chunks; the offsets are the counts' cumulative sum; a copy kernel then
    moves the staged samples into each ray's run: its row and step,
    optionally its tree cell (weights; on the bake through ``src_map``) and
    its march parameter t (``record_t``). The recorded t-chain is the
    march's. The earlier two walks, K13a (`count_samples_cuda`) and K13b
    (`record_samples_cuda`, each run written at its offset), stay for
    direct callers and give the same tape.
  * `replay_render`, `replay_render_weighted`: K13c composites the runs
    with K2's radiometry, sample for sample (exact or thresholded, early
    stop, rotations, SG/ASG, float32, bf16 and int8 pools, weights into
    the recorded cells), so a replay equals the march bit for bit,
    compacted or not: compaction drops only samples the march skips.
    Differentiable with respect to the pool: in exact mode K13d runs the
    backward march K3's single pass over the runs; thresholded modes take
    K3 itself over the tape's rays (which needs ``spec``).
  * `replay_render_frames`: one tape over a stack of N pools, (N, B,
    n_color + 1): the forward is one launch of K13c's kernel with a frame
    axis (`replay_forward_frames`); the backward, N independent gradients
    (N, M, D), is K13e in exact mode, one launch of K13d's kernel with a
    frame axis (thresholded modes take the per-frame backward, K3 over the
    tape's rays). K13c-e each have a vector instance for the three-colour
    RGBA, SH1 and SH9 rows (`replay_fwd_width`, `replay_bwd_width`).
  * `replay_depth`: first-hit depth from a tape recorded with
    ``record_t`` (K13f): per ray the t of the first sample whose row is
    resident and whose sigma exceeds sigma_thresh, times delta_scale;
    `render_depth` bit for bit on the recorded rays.
  * Data-indirect tapes (``indirect=True``) record tree cells instead of
    rows and survive `construct_tree` re-pointing: a replay resolves each
    sample's row through the frame's index table (`pack_index_table`; a
    negative entry or one >= M is empty). Record them against the union
    occupancy of the frames they serve, in exact geometry.

Every op dispatches on the device of its tensors: on CUDA it launches its
kernel (`csrc/tape_record.cu`, `csrc/tape_replay.cuh`, `csrc/tape_depth.cu`)
or raises; on the CPU it runs its plain PyTorch version, which follows the
kernel operation for operation and the plain march's sample chain
(`ops/render.py`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from ctypes import c_float, c_int, c_void_p
from typing import NamedTuple, Optional

import torch

from .._build import Kernel
from ..utils.spec import DATA_SENTINEL, FORMAT_RGBA, RenderOptions, get_out_data_dim
from .bake import BakedTree, StructureDesc, check_structure
from .render import (POOL_SUFFIX, QuantizedFeatures, _Basis, _check_quantized, _n_tree_cells,
                     _pool_tensors, _ray_setup, _require, _sample_colors, _sample_leaf,
                     _scatter_rows, _stream, _structure_arg, _sum_cols, _tree_cells, _vector_row,
                     check_format, effective_skip_base, gather_rows, pool_dtype, pool_kind,
                     radiometry_args, render_fwd_width, volume_render_backward)

__all__ = ["RayTape", "record_tape", "replay_render", "replay_render_weighted",
           "replay_render_frames", "replay_depth", "pack_index_table", "unsort_output"]

_WALK_ARGS = [
    ctypes.POINTER(StructureDesc),               # tree or bake
    c_void_p, c_void_p, c_int,                   # origins, dirs, B
    c_void_p, c_void_p,                          # offset, scaling
    c_int, c_float, c_int,                       # n_rows, step, max_steps
]
_COUNT_ARGS = _WALK_ARGS + [c_void_p, c_void_p, c_int, c_void_p]  # n_occ, n_tot, device, stream
_RECORD_ARGS = _WALK_ARGS + [c_void_p, c_int,                   # offsets, compact
                             c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,  # idx, dt, cell, t, dscale
                             c_int, c_void_p]
# The pool and radiometry arguments of a replay kernel (`radiometry_args`).
_POOL_ARGS = [c_void_p, c_void_p, c_void_p, c_int, c_int,   # features, scale, zero, M, D
              c_void_p, c_int, c_void_p, c_int,             # tmats, format, extra, ld_extra
              c_int, c_int, c_int, c_int]                   # basis_dim, min/max_comp, n_color
_REPLAY_FWD_ARGS = ([c_void_p, c_void_p, c_void_p, c_void_p,  # offsets, idx, dt, cell
                     c_void_p, c_void_p, c_int,               # dscale, vdirs, B
                     c_void_p, c_int] + _POOL_ARGS            # table, n_table
                    + [c_float, c_float, c_float,             # bg, sigma/stop thresh
                       c_void_p, c_void_p,                    # out, waccum
                       c_int, c_int, c_void_p])               # width, device, stream
_REPLAY_FWD_FRAMES_ARGS = ([c_void_p, c_void_p, c_void_p,     # offsets, idx, dt
                            c_void_p, c_void_p, c_int,        # dscale, vdirs, B
                            c_void_p, c_int] + _POOL_ARGS     # table, n_table
                           + [c_float, c_float, c_float,      # bg, sigma/stop thresh
                              c_void_p, c_int,                # out, n_frames
                              c_int, c_int, c_void_p])        # width, device, stream
_REPLAY_BWD_ARGS = ([c_void_p, c_void_p, c_void_p,            # offsets, idx, dt
                     c_void_p, c_void_p, c_int,               # dscale, vdirs, B
                     c_void_p, c_int] + _POOL_ARGS            # table, n_table
                    + [c_void_p, c_void_p, c_void_p,          # grad_out, out_res, grad
                       c_int, c_int, c_void_p])               # width, device, stream
_REPLAY_BWD_FRAMES_ARGS = _REPLAY_BWD_ARGS[:-3] + [c_int, c_int, c_int, c_void_p]  # n_frames, width, ...
_DEPTH_ARGS = [c_void_p, c_void_p, c_void_p, c_void_p, c_int,   # offsets, idx, tval, dscale, B
               c_void_p, c_int,                                 # table, n_table
               c_void_p, c_int, c_int, c_int, c_float,          # features, bf16, M, D, sigma_thresh
               c_void_p, c_int, c_void_p]                       # depth, device, stream

TAPE_COUNT = Kernel("svox_tape_count", _COUNT_ARGS)
TAPE_COUNT_BAKED = Kernel("svox_tape_count_baked", _COUNT_ARGS)
TAPE_RECORD = Kernel("svox_tape_record", _RECORD_ARGS)
TAPE_RECORD_BAKED = Kernel("svox_tape_record_baked", _RECORD_ARGS)
_STAGE_ARGS = _WALK_ARGS + [c_int, c_void_p, c_void_p, c_void_p,  # compact, n_occ, n_tot, dscale
                            c_void_p, c_int, c_void_p,             # n_chunks, capacity, owner
                            c_void_p, c_void_p, c_void_p, c_void_p,  # arena idx, dt, flat, t
                            c_int, c_void_p]
_COPY_ARGS = [ctypes.POINTER(StructureDesc), c_int, c_void_p,     # structure, n_chunks, owner
              c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,   # arena idx, dt, flat, t; offsets
              c_void_p, c_void_p, c_void_p, c_void_p,             # idx, dt, cell, t
              c_int, c_void_p]
TAPE_STAGE = Kernel("svox_tape_stage", _STAGE_ARGS)
TAPE_STAGE_BAKED = Kernel("svox_tape_stage_baked", _STAGE_ARGS)
TAPE_COPY = Kernel("svox_tape_copy", _COPY_ARGS)
TAPE_COPY_BAKED = Kernel("svox_tape_copy_baked", _COPY_ARGS)
# K13a+K13b's arena: chunks of ARENA_CHUNK entries (csrc/tape_record.cuh
# kChunk), ARENA_RAY_ENTRIES[compact] entries a ray before the walk (a
# ray's samples past its share take the entries of rays that record fewer;
# the census, `ops/tape_census.py`, counts what the callers' shapes use). A
# launch that needs more is rerun once with the capacity it reported:
# ARENA_RERUNS["reruns"] counts those reruns.
ARENA_CHUNK = 32
ARENA_RAY_ENTRIES = {True: 16, False: 48}
ARENA_RERUNS = {"reruns": 0}
# K13c has float32, bf16 and int8 instances, and so has its frame axis;
# K13d float32 and bf16 (a quantized pool takes no gradient).
_REPLAY_FWD = {k: Kernel(f"svox_tape_replay_fwd{POOL_SUFFIX[k]}", _REPLAY_FWD_ARGS)
               for k in ("f32", "bf16", "i8")}
_REPLAY_FWD_FRAMES = {k: Kernel(f"svox_tape_replay_fwd_frames{POOL_SUFFIX[k]}", _REPLAY_FWD_FRAMES_ARGS)
                      for k in ("f32", "bf16", "i8")}
_REPLAY_BWD = {k: Kernel(f"svox_tape_replay_bwd{POOL_SUFFIX[k]}", _REPLAY_BWD_ARGS)
               for k in ("f32", "bf16")}
# K13e, the backward's frame axis: float32 and bf16 as K13d.
_REPLAY_BWD_FRAMES = {k: Kernel(f"svox_tape_replay_bwd_frames{POOL_SUFFIX[k]}",
                                _REPLAY_BWD_FRAMES_ARGS) for k in ("f32", "bf16")}
TAPE_REPLAY_FWD, TAPE_REPLAY_FWD_BF16, TAPE_REPLAY_FWD_I8 = _REPLAY_FWD.values()
TAPE_REPLAY_FWD_FRAMES, TAPE_REPLAY_FWD_FRAMES_BF16, TAPE_REPLAY_FWD_FRAMES_I8 = _REPLAY_FWD_FRAMES.values()
TAPE_REPLAY_BWD, TAPE_REPLAY_BWD_BF16 = _REPLAY_BWD.values()
TAPE_REPLAY_BWD_FRAMES, TAPE_REPLAY_BWD_FRAMES_BF16 = _REPLAY_BWD_FRAMES.values()
# K13f reads a float32 or a bf16 pool's sigma column (one symbol, both
# instances).
TAPE_DEPTH = Kernel("svox_tape_depth", _DEPTH_ARGS)
# K13d and K13e launch one of two instances of their kernel, by the
# vector width in which a sample's row moves (`replay_bwd_width`): launches
# of both entry points (either pool type) by width, beside their counts.
BWD_WIDTH_LAUNCHES = {1: 0, 4: 0}
# The same for K13c and its frame axis (`replay_fwd_width`; every pool type).
FWD_WIDTH_LAUNCHES = {1: 0, 4: 0}


class _NoSpec:
    """Stand-in when no spec is supplied at replay: no per-voxel
    transformation matrices, no SG/ASG extra data."""

    transformation_matrices = None
    extra_data = None


_NOSPEC = _NoSpec()


def _geom_key(spec, opt: RenderOptions) -> tuple:
    """The options that determine sample POSITIONS (the recorded
    t-chain). Tapes are valid only under the exact geometry they were
    recorded with; everything else (thresholds, background, basis
    window) is replay-time radiometry."""
    return (
        float(opt.step_size), int(opt.max_steps), int(opt.box_advance),
        int(effective_skip_base(spec, opt)), int(opt.interp),
    )


def _check_geom(tape, spec, opt: RenderOptions):
    if not tape.geom:
        return
    if spec is not None:
        key = _geom_key(spec, opt)
    else:
        # No spec at replay: the skip-base slot cannot be recomputed;
        # check the opt-derived geometry only.
        key = (float(opt.step_size), int(opt.max_steps),
               int(opt.box_advance), tape.geom[3], int(opt.interp))
    if key != tape.geom:
        raise ValueError(
            f"tape was recorded under geometry {tape.geom} but replay "
            f"options give {key} — sample positions would not match; "
            "re-record the tape"
        )


@dataclasses.dataclass(frozen=True, eq=False)
class RayTape:
    """A recorded march (JAX `RayTape`, in the GPU's layout): ray i's
    samples are entries ``offsets[i]`` to ``offsets[i + 1]`` of the flat
    streams, rays in input order.

    Flat streams, one entry per sample:
      idx:  int32 feature row (tree cell on a data-indirect tape); rows
            outside [0, n_features) are empty space, as in the march.
      dt:   float32 step length (the recorded t-chain; never recomputed).
      cell: int32 tree cell (src_map-resolved on a bake), for weight
            accumulation, or None.
      tval: float32 march parameter t at the sample (``record_t``), or None.
    Per ray: offsets (B + 1,) int32, counts (B,) int32, origins, dirs,
    vdirs (B, 3) float32 (the basis and the thresholded backward), dscale
    (B,) float32 delta_scale.

    Meta: n_rays, S (the largest count), compact, n_features (the pool's
    row count at record time), n_cells (the weight table's size), geom
    (`_geom_key`), indirect.
    """

    idx: torch.Tensor
    dt: torch.Tensor
    cell: Optional[torch.Tensor]
    offsets: torch.Tensor
    counts: torch.Tensor
    origins: torch.Tensor
    dirs: torch.Tensor
    vdirs: torch.Tensor
    dscale: torch.Tensor
    n_rays: int
    S: int
    compact: bool
    n_features: int
    n_cells: int
    geom: tuple = ()
    tval: Optional[torch.Tensor] = None
    indirect: bool = False

    @property
    def n_samples(self) -> int:
        """Samples recorded (the sum of counts)."""
        return int(self.idx.shape[0])

    @property
    def inv_pos(self) -> torch.Tensor:
        """Row of ray i in the replay's output: i (rays stay in input order)."""
        return torch.arange(self.n_rays, dtype=torch.int32, device=self.dt.device)

    @property
    def device(self) -> torch.device:
        return self.dt.device


# ---------------------------------------------------------------------------
# Recording (K13a, K13b)


def _walk_plain(spec, opt: RenderOptions, rays):
    """Every step of the plain march's sample chain (`_march_plain`), for
    every ray: yields (active, leaf, t, dt) per step, a hit ray's first
    sample at tmin, out at t >= tmax or max_steps samples."""
    tmin, tmax, hit = rays[4:]
    t, active = tmin, hit.clone()
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        leaf, dt = _sample_leaf(spec, opt, rays, t)
        yield active, leaf, t, dt
        t = torch.where(active, t + dt, t)
        active = active & (t < tmax)


def _occupied(rows, n_rows: int):
    return (rows >= 0) & (rows < n_rows)


def count_samples_plain(spec, n_rows: int, origins, dirs, opt: RenderOptions):
    """Plain PyTorch version of K13a: per ray (occupied, total) int32
    sample counts of the march's walk."""
    rays = _ray_setup(spec, origins, dirs, opt)
    n_occ = torch.zeros(origins.shape[0], dtype=torch.int32, device=origins.device)
    n_tot = torch.zeros_like(n_occ)
    for active, leaf, _, _ in _walk_plain(spec, opt, rays):
        n_tot += active.to(torch.int32)
        n_occ += (active & _occupied(leaf.data_idx, n_rows)).to(torch.int32)
    return n_occ, n_tot


def record_samples_plain(spec, n_rows: int, origins, dirs, opt: RenderOptions, offsets,
                         compact: bool, want_idx=True, want_cell=True, want_t=False):
    """Plain PyTorch version of K13b: (idx, dt, cell, tval, dscale), the
    flat streams of every ray's run at ``offsets`` (None for a stream not
    wanted) and the per-ray delta_scale."""
    rays = _ray_setup(spec, origins, dirs, opt)
    total = int(offsets[-1])
    dev = origins.device
    ints = lambda want: torch.zeros(total, dtype=torch.int32, device=dev) if want else None  # noqa: E731
    idx, cell = ints(want_idx), ints(want_cell)
    dt_out = torch.zeros(total, dtype=torch.float32, device=dev)
    tval = torch.zeros(total, dtype=torch.float32, device=dev) if want_t else None
    k = offsets[:-1].long()
    end = offsets[1:].long()
    for active, leaf, t, dt in _walk_plain(spec, opt, rays):
        w = active & (k < end)
        if compact:
            w = w & _occupied(leaf.data_idx, n_rows)
        pos = k[w]
        if idx is not None:
            idx[pos] = leaf.data_idx[w].to(torch.int32)
        dt_out[pos] = dt[w]
        if cell is not None:
            cell[pos] = _tree_cells(spec, leaf.node_flat[w]).to(torch.int32)
        if tval is not None:
            tval[pos] = t[w]
        k = k + w.long()
    return idx, dt_out, cell, tval, rays[3]


def _walk_args(spec, origins, dirs, opt: RenderOptions, n_rows: int, name: str):
    """Check the count and record kernels' inputs and return their shared
    leading arguments (`_WALK_ARGS`)."""
    dev = origins.device
    for t in (origins, dirs):
        _require(t.is_cuda and t.device == dev and t.is_contiguous() and t.dtype == torch.float32,
                 f"{name} needs contiguous float32 rays on one CUDA device")
    check_structure(spec, dev, name)
    _require(origins.shape[0] < 2 ** 31, "too many rays")
    return (_structure_arg(spec, opt), origins.data_ptr(), dirs.data_ptr(), origins.shape[0],
            spec.offset.data_ptr(), spec.scaling.data_ptr(), int(n_rows), opt.step_size,
            opt.max_steps)


def count_samples_cuda(spec, n_rows: int, origins, dirs, opt: RenderOptions):
    """Launch K13a (csrc/tape_record.cu, or tape_record_baked.cu on a
    BakedTree): per ray (occupied, total) int32 counts. `record_tape` counts
    in its one walk (`stage_samples_cuda`); this walk serves direct
    callers."""
    args = _walk_args(spec, origins, dirs, opt, n_rows, "count_samples_cuda")
    n_occ = torch.empty(origins.shape[0], dtype=torch.int32, device=origins.device)
    n_tot = torch.empty_like(n_occ)
    if origins.shape[0]:
        kernel = TAPE_COUNT_BAKED if isinstance(spec, BakedTree) else TAPE_COUNT
        kernel(*args, n_occ.data_ptr(), n_tot.data_ptr(), *_stream(origins.device))
    return n_occ, n_tot


def record_samples_cuda(spec, n_rows: int, origins, dirs, opt: RenderOptions, offsets,
                        compact: bool, want_idx=True, want_cell=True, want_t=False):
    """Launch K13b (csrc/tape_record.cu, or tape_record_baked.cu on a
    BakedTree): the flat streams and dscale, as `record_samples_plain`,
    each ray's run written in its walk at ``offsets`` (K13a's counts'
    cumsum): with `count_samples_cuda`, the earlier two-walk recording,
    which gives `record_tape`'s tape bit for bit."""
    args = _walk_args(spec, origins, dirs, opt, n_rows, "record_samples_cuda")
    dev = origins.device
    B = origins.shape[0]
    _require(offsets.is_cuda and offsets.device == dev and offsets.dtype == torch.int32
             and offsets.is_contiguous() and tuple(offsets.shape) == (B + 1,),
             "offsets must be contiguous (B + 1,) int32 on the rays' device")
    total = int(offsets[-1])
    ints = lambda want: torch.empty(total, dtype=torch.int32, device=dev) if want else None  # noqa: E731
    idx, cell = ints(want_idx), ints(want_cell)
    dt = torch.empty(total, dtype=torch.float32, device=dev)
    tval = torch.empty(total, dtype=torch.float32, device=dev) if want_t else None
    dscale = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        kernel = TAPE_RECORD_BAKED if isinstance(spec, BakedTree) else TAPE_RECORD
        kernel(*args, offsets.data_ptr(), int(bool(compact)), _ptr(idx), dt.data_ptr(), _ptr(cell),
               _ptr(tval), dscale.data_ptr(), *_stream(dev))
    return idx, dt, cell, tval, dscale


class Staged(NamedTuple):
    """What K13a+K13b's walk leaves: per ray the counts and delta_scale;
    ``n_chunks`` (one int32 on the rays' device), the chunks the walk
    needed; ``capacity`` the chunks the arena holds, ``owner`` (capacity,
    2) int32 each chunk's (ray, ordinal), and the arena's streams,
    capacity * ARENA_CHUNK entries (None where not recorded; ``flat``
    holds leaf cells, resolved by the copy)."""

    n_occ: torch.Tensor
    n_tot: torch.Tensor
    dscale: torch.Tensor
    n_chunks: torch.Tensor
    capacity: int
    owner: torch.Tensor
    idx: Optional[torch.Tensor]
    dt: torch.Tensor
    flat: Optional[torch.Tensor]
    tval: Optional[torch.Tensor]


def arena_capacity(n_rays: int, compact: bool) -> int:
    """Chunks of the arena a walk of ``n_rays`` rays is launched with."""
    return max(1, -(-n_rays * ARENA_RAY_ENTRIES[bool(compact)] // ARENA_CHUNK))


def _arena(n_rays: int, capacity: int, want_idx: bool, want_cell: bool, want_t: bool, dev,
           alloc=torch.zeros) -> Staged:
    """A walk's outputs for `Staged`, each made by ``alloc``; the chunk
    counter zeroed."""
    _require(capacity * ARENA_CHUNK < 2 ** 31, "the arena would hold 2^31 entries: record fewer rays per tape")
    n = capacity * ARENA_CHUNK

    def stream(want, dtype):
        return alloc(n, dtype=dtype, device=dev) if want else None

    return Staged(alloc(n_rays, dtype=torch.int32, device=dev), alloc(n_rays, dtype=torch.int32, device=dev),
                  alloc(n_rays, dtype=torch.float32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
                  capacity, alloc((capacity, 2), dtype=torch.int32, device=dev), stream(want_idx, torch.int32),
                  stream(True, torch.float32), stream(want_cell, torch.int32), stream(want_t, torch.float32))


def stage_samples_plain(spec, n_rows: int, origins, dirs, opt: RenderOptions, compact: bool,
                        want_idx=True, want_cell=True, want_t=False, capacity=None) -> Staged:
    """Plain PyTorch version of K13a+K13b's walk (`stage_kernel`): the
    counts, delta_scale and the staged samples. Ray i's sample k (every
    sample, or with ``compact`` the occupied ones) is entry k % ARENA_CHUNK
    of its chunk k // ARENA_CHUNK; at each step the rays that start a chunk
    take the next chunk numbers in ray order (on the card, in the order of
    the warps' atomics). Chunks past ``capacity`` (default
    `arena_capacity`) are counted in ``n_chunks`` and not written."""
    B, dev = origins.shape[0], origins.device
    capacity = arena_capacity(B, compact) if capacity is None else capacity
    out = _arena(B, capacity, want_idx, want_cell, want_t, dev)
    rays = _ray_setup(spec, origins, dirs, opt)
    C = ARENA_CHUNK
    k = torch.zeros(B, dtype=torch.long, device=dev)
    chunk = torch.zeros(B, dtype=torch.long, device=dev)
    taken = 0
    for active, leaf, t, dt in _walk_plain(spec, opt, rays):
        occ = active & _occupied(leaf.data_idx, n_rows)
        out.n_tot.add_(active.to(torch.int32))
        out.n_occ.add_(occ.to(torch.int32))
        w = occ if compact else active
        new = torch.nonzero(w & (k % C == 0)).reshape(-1)
        chunk[new] = taken + torch.arange(new.shape[0], device=dev)
        taken += int(new.shape[0])
        own = new[chunk[new] < capacity]
        out.owner[chunk[own]] = torch.stack((own, k[own] // C), 1).to(torch.int32)
        w = w & (chunk < capacity)
        q = chunk[w] * C + k[w] % C
        if out.idx is not None:
            out.idx[q] = leaf.data_idx[w].to(torch.int32)
        out.dt[q] = dt[w]
        if out.flat is not None:
            out.flat[q] = leaf.node_flat[w].to(torch.int32)
        if out.tval is not None:
            out.tval[q] = t[w]
        k = k + (occ if compact else active).long()
    out.dscale.copy_(rays[3])
    out.n_chunks.fill_(taken)
    return out


def copy_samples_plain(spec, opt: RenderOptions, staged: Staged, n_chunks: int, offsets, total: int):
    """Plain PyTorch version of K13a+K13b's copy (`copy_kernel`): (idx, dt,
    cell, tval), the staged samples moved into the runs at ``offsets``
    (None for a stream not recorded); the cells resolved here."""
    del opt
    dev = staged.dt.device
    C = ARENA_CHUNK
    q = torch.arange(n_chunks * C, device=dev)
    ray, ordinal = staged.owner[q // C].long().unbind(1)
    j = ordinal * C + q % C
    start = offsets[ray].long()
    keep = j < offsets[ray + 1].long() - start
    q, d = q[keep], (start + j)[keep]

    def moved(src, dtype):
        if src is None:
            return None
        out = torch.zeros(total, dtype=dtype, device=dev)
        out[d] = src[q]
        return out

    cell = None
    if staged.flat is not None:
        cell = torch.zeros(total, dtype=torch.int32, device=dev)
        cell[d] = _tree_cells(spec, staged.flat[q].long()).to(torch.int32)
    return moved(staged.idx, torch.int32), moved(staged.dt, torch.float32), cell, moved(staged.tval, torch.float32)


def stage_samples_cuda(spec, n_rows: int, origins, dirs, opt: RenderOptions, compact: bool,
                       want_idx=True, want_cell=True, want_t=False, capacity=None) -> Staged:
    """Launch K13a+K13b's walk (csrc/tape_record.cu, or tape_record_baked.cu
    on a BakedTree): as `stage_samples_plain`."""
    args = _walk_args(spec, origins, dirs, opt, n_rows, "stage_samples_cuda")
    _require(want_idx or want_cell, "a tape records the row or the cell stream")
    B, dev = origins.shape[0], origins.device
    capacity = arena_capacity(B, compact) if capacity is None else capacity
    st = _arena(B, capacity, want_idx, want_cell, want_t, dev, torch.empty)
    if B:
        kernel = TAPE_STAGE_BAKED if isinstance(spec, BakedTree) else TAPE_STAGE
        kernel(*args, int(bool(compact)), st.n_occ.data_ptr(), st.n_tot.data_ptr(), st.dscale.data_ptr(),
               st.n_chunks.data_ptr(), capacity, st.owner.data_ptr(), _ptr(st.idx), st.dt.data_ptr(),
               _ptr(st.flat), _ptr(st.tval), *_stream(dev))
    return st


def copy_samples_cuda(spec, opt: RenderOptions, staged: Staged, n_chunks: int, offsets, total: int):
    """Launch K13a+K13b's copy (csrc/tape_record.cu, or tape_record_baked.cu
    on a BakedTree): as `copy_samples_plain`."""
    dev = staged.dt.device
    check_structure(spec, dev, "copy_samples_cuda")
    _require(offsets.is_cuda and offsets.device == dev and offsets.dtype == torch.int32
             and offsets.is_contiguous(), "offsets must be contiguous int32 on the arena's device")
    _require(0 <= n_chunks <= staged.capacity, "more chunks than the arena holds")
    ints = lambda src: None if src is None else torch.empty(total, dtype=torch.int32, device=dev)  # noqa: E731
    floats = lambda src: None if src is None else torch.empty(total, dtype=torch.float32, device=dev)  # noqa: E731
    idx, dt, cell, tval = ints(staged.idx), floats(staged.dt), ints(staged.flat), floats(staged.tval)
    if n_chunks:
        kernel = TAPE_COPY_BAKED if isinstance(spec, BakedTree) else TAPE_COPY
        kernel(_structure_arg(spec, opt), n_chunks, staged.owner.data_ptr(), _ptr(staged.idx),
               staged.dt.data_ptr(), _ptr(staged.flat), _ptr(staged.tval), offsets.data_ptr(), _ptr(idx),
               dt.data_ptr(), _ptr(cell), _ptr(tval), *_stream(dev))
    return idx, dt, cell, tval


def _ptr(t):
    return None if t is None else t.data_ptr()


def record_streams(spec, n_rows: int, origins, dirs, opt: RenderOptions, compact: bool,
                   want_idx=True, want_cell=True, want_t=False, capacity=None):
    """A recording's streams, as `record_tape` takes them: K13a+K13b's walk
    (with the arena's ``capacity``, default `arena_capacity`), the offsets
    (an int32 cumsum of the counts), one host copy of the samples, the
    longest run and the chunks the walk needed (a walk that needed more
    than its arena reruns once with that capacity: ARENA_RERUNS), then the
    copy. On the CPU the plain versions. Returns (counts, offsets (B + 1,)
    int32, S, idx, dt, cell, tval, dscale)."""
    on_card = origins.is_cuda
    stage = stage_samples_cuda if on_card else stage_samples_plain
    copy = copy_samples_cuda if on_card else copy_samples_plain
    B = origins.shape[0]
    capacity = arena_capacity(B, compact) if capacity is None else capacity
    st = stage(spec, n_rows, origins, dirs, opt, compact, want_idx, want_cell, want_t, capacity)
    counts = st.n_occ if compact else st.n_tot
    offsets = torch.zeros(B + 1, dtype=torch.int32, device=origins.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    total, S, n_chunks = (torch.stack((counts.sum(dtype=torch.int64), counts.max().long(), st.n_chunks[0].long()))
                          .tolist() if B else (0, 0, 0))
    if total >= 2 ** 31:
        raise ValueError(f"the tape would hold {total} samples; int32 offsets address fewer "
                         "than 2^31: record fewer rays per tape")
    if n_chunks > capacity:
        ARENA_RERUNS["reruns"] += 1
        st = stage(spec, n_rows, origins, dirs, opt, compact, want_idx, want_cell, want_t, n_chunks)
    idx, dt, cell, tval = copy(spec, opt, st, n_chunks, offsets, total)
    return counts, offsets, S, idx, dt, cell, tval, st.dscale


def record_tape(spec, n_features: int, origins, dirs, vdirs,
                opt: RenderOptions, *, compact: bool = True,
                record_cells: bool = True,
                chunk_size: int = 0,
                prog_round_size: int = 0,
                group_size: int = 1,
                indirect: bool = False,
                record_t: bool = False) -> RayTape:
    """Record a :class:`RayTape` for these rays against this structure
    (a TreeSpec or a BakedTree), on the structure's device.

    The tape is valid while the tree STRUCTURE and the march-geometry
    options (step_size, max_steps, box_advance, skip boxes, cull box)
    are unchanged; feature VALUES are free to change between replays.
    `n_features` is the feature-pool row bound (the occupied/empty
    split). ``chunk_size``, ``prog_round_size`` and ``group_size``
    schedule the JAX package's TPU layout; they are accepted and ignored.

    ``indirect=True`` records a data-indirect (cell-indexed) tape that
    survives `construct_tree` re-pointing: `spec` must carry the UNION
    occupancy over every frame the tape will serve, and replays take the
    frame's index table (`pack_index_table`). ``record_t=True`` also
    records each sample's march parameter t (`RayTape.tval`).
    """
    del chunk_size, prog_round_size, group_size
    if opt.interp:
        raise ValueError("tapes do not support opt.interp (corner cells "
                         "would need a structure walk at replay)")
    if indirect:
        record_cells = True
        if opt.box_advance or effective_skip_base(spec, opt):
            raise ValueError(
                "indirect tapes require exact geometry (box_advance=0, "
                "skip_boxes off): occupancy-driven position shifts do "
                "not survive re-pointing"
            )
    dev = spec.device
    origins, dirs, vdirs = (torch.as_tensor(r, dtype=torch.float32, device=dev).contiguous()
                            for r in (origins, dirs, vdirs))
    B = origins.shape[0]
    counts, offsets, S, idx, dt, cell, tval, dscale = record_streams(
        spec, int(n_features), origins, dirs, opt, compact, want_idx=not indirect,
        want_cell=record_cells, want_t=record_t)
    if indirect:
        # The cell stream IS the sample stream.
        idx = cell
    return RayTape(
        idx=idx, dt=dt, cell=cell if record_cells else None, offsets=offsets,
        counts=counts.to(torch.int32), origins=origins, dirs=dirs, vdirs=vdirs,
        dscale=dscale.contiguous(), n_rays=int(B), S=int(S),
        compact=bool(compact), n_features=int(n_features), n_cells=_n_tree_cells(spec),
        geom=_geom_key(spec, opt), tval=tval, indirect=bool(indirect),
    )


# ---------------------------------------------------------------------------
# Data-indirect tapes


def pack_index_table(data_flat, width: int = 32):
    """Pack a flat int32 index table into the (rows, width) layout
    data-indirect replays resolve cells through (JAX `pack_index_table`;
    padded with the empty sentinel). The kernels read it flat."""
    data_flat = torch.as_tensor(data_flat).to(torch.int32).reshape(-1)
    pad = (-data_flat.shape[0]) % width
    if pad:
        data_flat = torch.cat([data_flat, torch.full((pad,), int(DATA_SENTINEL), dtype=torch.int32,
                                                     device=data_flat.device)])
    return data_flat.reshape(-1, width)


def _check_indirect(tape: RayTape, index_table):
    if tape.indirect and index_table is None:
        raise ValueError(
            "data-indirect tape: pass index_table "
            "(pack_index_table(data_flat) of the frame to render)"
        )
    if index_table is not None and not tape.indirect:
        raise ValueError(
            "index_table passed but the tape was not recorded with "
            "indirect=True"
        )
    if tape.indirect:
        # Structure guard: a STRUCTURE change resizes the cell space and
        # silently mis-routes every resolve.
        n = int(index_table.shape[0]) * int(index_table.shape[1])
        w = int(index_table.shape[1])
        if not (tape.n_cells <= n < tape.n_cells + w):
            raise ValueError(
                f"index table covers {n} cells (padded, width {w}) but "
                f"the tape was recorded against {tape.n_cells} — the "
                "tree STRUCTURE changed; re-record the tape"
            )


def _resolve_cells(table, cells):
    """Rows of recorded tree cells through a flat index table (JAX
    `_resolve_cells`): -1 (empty) for a cell outside the table; a negative
    entry or one >= M reads as empty where it is used."""
    ok = (cells >= 0) & (cells < table.shape[0])
    if table.shape[0] == 0:
        return torch.full_like(cells, -1)
    return torch.where(ok, table[torch.where(ok, cells, 0).long()], -1)


# ---------------------------------------------------------------------------
# Replay (K13c, K13d)


def _check_replay(tape: RayTape, features, opt: RenderOptions, spec, index_table) -> None:
    if opt.interp:
        raise ValueError("tapes do not support opt.interp")
    if opt.pool_axis is not None or opt.ray_axis is not None:
        raise NotImplementedError("sharded rendering waits for ROADMAP.md §1 item 17")
    _check_indirect(tape, index_table)
    _check_geom(tape, spec, opt)
    if isinstance(features, QuantizedFeatures):
        _check_quantized(features)
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    if features.shape[0] != tape.n_features:
        raise ValueError(
            f"feature pool has {features.shape[0]} rows but the tape was "
            f"recorded against {tape.n_features} — the structure changed; "
            "re-record the tape"
        )
    devices = {t.device for t in _pool_tensors(features)} | {tape.device}
    if index_table is not None:
        devices.add(index_table.device)
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _flat_table(index_table):
    return None if index_table is None else index_table.reshape(-1)


def _slots(tape: RayTape, table):
    """Per sample slot k = 0 .. S - 1 of every ray: (k, live, pos, row),
    ``live`` where ray i has a k-th sample, ``pos`` its flat position (0
    where it has none), ``row`` its (resolved) row."""
    start, counts = tape.offsets[:-1].long(), tape.counts.long()
    for k in range(tape.S):
        live = k < counts
        pos = torch.where(live, start + k, 0)
        row = tape.idx[pos]
        if table is not None:
            row = _resolve_cells(table, row)
        yield live, pos, row


def replay_forward_plain(tape: RayTape, features, opt: RenderOptions, spec=None,
                         want_weights: bool = False, index_table=None):
    """Plain PyTorch version of K13c: (out (B, n_color + 1), waccum or
    None). Composites each ray's samples as `_march_plain` composites its
    steps, all rays at once per sample slot, so a replay of a tape of
    the march's samples equals the plain march bit for bit."""
    spec_v = spec if spec is not None else _NOSPEC
    B = tape.n_rays
    M, D = features.shape
    dev = tape.device
    dtype = torch.promote_types(pool_dtype(features), tape.dt.dtype)
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    basis = _Basis(spec_v, opt, tape.vdirs)
    can_stop = opt.stop_thresh > 0.0
    waccum = None
    if want_weights:
        if tape.cell is None:
            raise ValueError("tape recorded with record_cells=False")
        waccum = torch.zeros(tape.n_cells, dtype=torch.float32, device=dev)
    L = torch.ones(B, dtype=dtype, device=dev)
    out_c = torch.zeros(B, n_color, dtype=dtype, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    # With an empty pool no sample can contribute (the march skips too).
    slots = _slots(tape, _flat_table(index_table)) if M else ()
    for live, pos, row in slots:
        valid = live & ~stopped & (row >= 0) & (row < M)
        rows = torch.where(valid, row, 0).long()
        sigma = torch.where(valid, gather_rows(features, rows, -1), 0.0)
        contrib = valid & (sigma > opt.sigma_thresh)
        att = torch.exp(-tape.dt[pos] * tape.dscale * sigma)
        weight = L * (1.0 - att)
        col = _sample_colors(features, rows, None, basis.at(rows), opt, n_color)
        out_c = torch.where(contrib[:, None], out_c + weight[:, None] * col, out_c)
        if want_weights:
            waccum.index_add_(0, tape.cell[pos][contrib].long(), weight[contrib].to(waccum.dtype))
        L = torch.where(contrib, L * att, L)
        if can_stop:
            stop = contrib & (L <= opt.stop_thresh)
            out_c = torch.where(stop[:, None], out_c * (1.0 / (1.0 - L))[:, None], out_c)
            stopped = stopped | stop
    out_c = torch.where(stopped[:, None], out_c, out_c + (L * opt.background_brightness)[:, None])
    return torch.cat([out_c, (1.0 - L)[:, None]], dim=-1), waccum


def replay_backward_plain(tape: RayTape, features, opt: RenderOptions, grad_out, out_res,
                          spec=None, index_table=None):
    """Plain PyTorch version of K13d (exact options): the pool gradient
    (M, D) in `pool_dtype`, the plain backward march's single pass
    (`_march_bwd_plain`) over the tape's samples: acc from the saved
    output, a sample contributes where its row is < M and sigma > 0."""
    spec_v = spec if spec is not None else _NOSPEC
    B = tape.n_rays
    M, D = features.shape
    grad = torch.zeros(M, D, dtype=pool_dtype(features), device=tape.device)
    if M == 0 or B == 0:
        return grad
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    n_cc = n_color * opt.basis_dim if opt.format != FORMAT_RGBA else n_color
    basis = _Basis(spec_v, opt, tape.vdirs)
    g, g_alpha = grad_out[:, :n_color], grad_out[:, n_color]
    acc = _sum_cols(out_res[:, :n_color] * g)
    L_ray = 1.0 - out_res[:, n_color]
    L = torch.ones(B, dtype=grad.dtype, device=grad.device)
    for live, pos, row in _slots(tape, _flat_table(index_table)):
        valid = live & (row >= 0) & (row < M)
        rows = torch.where(valid, row, 0).long()
        sig = torch.where(valid, gather_rows(features, rows, -1), 0.0)
        contrib = valid & (sig > 0.0)
        dt = tape.dt[pos]
        att = torch.exp(-dt * tape.dscale * sig)
        weight = L * (1.0 - att)
        b = basis.at(rows)
        s = _sample_colors(features, rows, None, b, opt, n_color)
        total_color = _sum_cols(s * g)
        L_after = L * att
        rows_full = torch.zeros(B, D, dtype=grad.dtype, device=grad.device)
        a = (weight[:, None] * (s * (1.0 - s))) * g
        rows_full[:, :n_cc] = a if b is None else (a[:, :, None] * b[:, None, :]).reshape(B, n_cc)
        acc_after = acc - weight * total_color
        dts = dt * tape.dscale
        rows_full[:, D - 1] = dts * (total_color * L_after - acc_after) + dts * (g_alpha * L_ray)
        _scatter_rows(grad, rows, None, contrib, rows_full)
        acc = torch.where(contrib, acc_after, acc)
        L = torch.where(contrib, L_after, L)
    return grad


def _tape_args(tape: RayTape, features, index_table, name: str):
    """Check a replay kernel's tape, pool and table on one CUDA device and
    return the tape's leading arguments after dt (dscale, vdirs, B) and
    the table's (table, n_table)."""
    dev = tape.device
    ints = [tape.offsets, tape.idx] + ([] if tape.cell is None else [tape.cell])
    floats = [tape.dt, tape.dscale, tape.vdirs]
    table = _flat_table(index_table)
    if table is not None:
        ints.append(table)
    for t in (*_pool_tensors(features), *ints, *floats):
        _require(t.is_cuda and t.device == dev, f"{name} needs all tensors on one CUDA device")
        _require(t.is_contiguous(), f"{name} needs contiguous tensors")
    _require(all(t.dtype == torch.int32 for t in ints), f"{name}: tape streams and table must be int32")
    _require(all(t.dtype == torch.float32 for t in floats), f"{name}: dt, dscale and vdirs must be float32")
    _require(tuple(tape.offsets.shape) == (tape.n_rays + 1,), "offsets must be (B + 1,)")
    return ((tape.dscale.data_ptr(), tape.vdirs.data_ptr(), tape.n_rays),
            (None, 0) if table is None else (table.data_ptr(), table.shape[0]))


# K13c's rows take K2's vector widths (the same rows, the same alignment).
replay_fwd_width = render_fwd_width


def replay_bwd_width(fmt: int, basis_dim: int, D: int, pool_ptr: int, pool_elem: int,
                     grad_ptr: int) -> int:
    """The vector width of a K13d / K13e launch: 4 for the three-colour
    rows with no spare column (RGBA at D = 4, SH1 at D = 4, SH9 at D = 28)
    when the pool (``pool_ptr``, ``pool_elem`` bytes a value) and the
    float32 gradient (``grad_ptr``) are aligned to 4 values, else 1."""
    aligned = grad_ptr % 16 == 0 and pool_ptr % (4 * pool_elem) == 0
    return 4 if _vector_row(fmt, basis_dim, D) and aligned else 1


def _launch_fwd(kernel: Kernel, head: tuple, features, opt: RenderOptions, tail: tuple,
                width: Optional[int]) -> None:
    """Launch K13c or its frame axis (``kernel``): its arguments before the
    width, the width (`replay_fwd_width` unless given), then ``tail``."""
    if width is None:
        q, scales = features, ()
        if isinstance(features, QuantizedFeatures):
            q, scales = features.q, (features.scale.data_ptr(), features.zero.data_ptr())
        width = replay_fwd_width(opt.format, opt.basis_dim, features.shape[-1], q.data_ptr(),
                                 q.element_size(), scales)
    kernel(*head, width, *tail)
    FWD_WIDTH_LAUNCHES[width] += 1


def _launch_bwd(kernel: Kernel, head: tuple, features, grad, opt: RenderOptions, tail: tuple,
                width: Optional[int]) -> None:
    """Launch K13d or K13e (``kernel``): its arguments before the width,
    the width (`replay_bwd_width` unless given), then ``tail``."""
    if width is None:
        width = replay_bwd_width(opt.format, opt.basis_dim, features.shape[-1], features.data_ptr(),
                                 features.element_size(), grad.data_ptr())
    kernel(*head, width, *tail)
    BWD_WIDTH_LAUNCHES[width] += 1


def _replay_kernel(instances: dict, features) -> Kernel:
    kind = pool_kind(features)
    if kind not in instances:
        raise ValueError(f"{instances['f32'].symbol} has no kernel instance for a {kind} "
                         f"feature pool (instances: {', '.join(instances)})")
    return instances[kind]


def replay_forward_cuda(tape: RayTape, features, opt: RenderOptions, spec=None,
                        want_weights: bool = False, index_table=None, width: Optional[int] = None):
    """Launch K13c (csrc/tape_replay_fwd.cu; the bf16 and int8 pools'
    instances of csrc/tape_replay.cuh): (out, waccum or None). ``width``:
    the vector instance (1 or 4) instead of `replay_fwd_width`'s; the
    kernel refuses one the row or the pool's alignment does not allow (a
    comparison of the instances passes it)."""
    spec_v = spec if spec is not None else _NOSPEC
    n_color = check_format(spec_v, features, opt)
    kernel = _replay_kernel(_REPLAY_FWD, features)
    ray_args, table_args = _tape_args(tape, features, index_table, "replay_forward_cuda")
    rad = radiometry_args(spec_v, features, opt, n_color)
    dev = tape.device
    if want_weights and tape.cell is None:
        raise ValueError("tape recorded with record_cells=False")
    out = torch.empty(tape.n_rays, n_color + 1, dtype=torch.float32, device=dev)
    waccum = torch.zeros(tape.n_cells, dtype=torch.float32, device=dev) if want_weights else None
    if tape.n_rays:
        _launch_fwd(kernel, (tape.offsets.data_ptr(), tape.idx.data_ptr(), tape.dt.data_ptr(),
                             tape.cell.data_ptr() if want_weights else None, *ray_args, *table_args, *rad,
                             opt.background_brightness, opt.sigma_thresh, opt.stop_thresh, out.data_ptr(),
                             None if waccum is None else waccum.data_ptr()),
                    features, opt, _stream(dev), width)
    return out, waccum


def replay_backward_cuda(tape: RayTape, features, opt: RenderOptions, grad_out, out_res,
                         spec=None, index_table=None, width: Optional[int] = None):
    """Launch K13d (csrc/tape_replay_bwd.cu; the bf16 pool's instance of
    csrc/tape_replay.cuh) into a zeroed float32 (M, D) gradient, exact
    options. An empty pool or tape returns zeros without a launch.
    ``width``: the vector instance (1 or 4) instead of
    `replay_bwd_width`'s; the kernel refuses one the row or the pointers
    do not allow (a comparison of the instances passes it)."""
    spec_v = spec if spec is not None else _NOSPEC
    n_color = check_format(spec_v, features, opt)
    kernel = _replay_kernel(_REPLAY_BWD, features)
    ray_args, table_args = _tape_args(tape, features, index_table, "replay_backward_cuda")
    rad = radiometry_args(spec_v, features, opt, n_color)
    for t in (grad_out, out_res):
        _require(t.is_cuda and t.device == tape.device and t.is_contiguous()
                 and t.dtype == torch.float32 and tuple(t.shape) == (tape.n_rays, n_color + 1),
                 f"grad_out and out_res must be contiguous ({tape.n_rays}, {n_color + 1}) float32")
    M, D = features.shape
    grad = torch.zeros(M, D, dtype=torch.float32, device=tape.device)
    if M and tape.n_rays:
        _launch_bwd(kernel, (tape.offsets.data_ptr(), tape.idx.data_ptr(), tape.dt.data_ptr(), *ray_args,
                             *table_args, *rad, grad_out.data_ptr(), out_res.data_ptr(), grad.data_ptr()),
                    features, grad, opt, _stream(tape.device), width)
    return grad


def replay_forward(tape: RayTape, features, opt: RenderOptions, spec=None,
                   want_weights: bool = False, index_table=None):
    """The replay forward, (out (B, n_color + 1), waccum or None), on the
    tape's device: K13c on CUDA, its plain version on the CPU."""
    _check_replay(tape, features, opt, spec, index_table)
    run = replay_forward_cuda if tape.dt.is_cuda else replay_forward_plain
    return run(tape, features, opt, spec, want_weights, index_table)


def replay_backward(tape: RayTape, features, opt: RenderOptions, grad_out, out_res,
                    spec=None, index_table=None):
    """Gradient of a replay with respect to the pool, (M, D) in the pool's
    type (summed in float32 and cast once). Exact mode (sigma_thresh == 0,
    stop_thresh <= 0): K13d over the tape (its plain version on the CPU).
    Thresholded modes fall back to the backward march K3 over the tape's
    rays, which needs ``spec`` and a direct tape."""
    if isinstance(features, QuantizedFeatures):
        raise TypeError("a quantized feature pool takes no gradient")
    _check_replay(tape, features, opt, spec, index_table)
    if not (opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0):
        if tape.indirect:
            raise ValueError(
                "thresholded gradients are not supported on data-indirect "
                "tapes (the march-backward fallback needs a fixed spec); "
                "use exact mode (sigma_thresh=0, stop_thresh=0)"
            )
        if spec is None:
            raise ValueError(
                "thresholded tape gradients need `spec` (march-backward "
                "fallback)"
            )
        return volume_render_backward(spec, features, tape.origins, tape.dirs, tape.vdirs,
                                      grad_out, opt, out_res=out_res)
    run = replay_backward_cuda if tape.dt.is_cuda else replay_backward_plain
    return run(tape, features, opt, grad_out, out_res, spec, index_table).to(features.dtype)


def _save(ctx, tape, features, index_table, opt, spec, out) -> None:
    ctx.tape, ctx.index_table, ctx.opt, ctx.spec = tape, index_table, opt, spec
    if not isinstance(features, QuantizedFeatures):
        ctx.save_for_backward(features, out)


def _grad_features(ctx, grad_out):
    if not ctx.needs_input_grad[1]:
        return None
    features, out = ctx.saved_tensors
    return replay_backward(ctx.tape, features, ctx.opt, grad_out.contiguous(), out, ctx.spec,
                           ctx.index_table)


class _ReplayFn(torch.autograd.Function):
    """`replay_render` (JAX: `_replay_call`'s custom_vjp): the gradient
    goes to the pool only."""

    @staticmethod
    def forward(ctx, tape, features, index_table, opt, spec):
        out, _ = replay_forward(tape, features, opt, spec, False, index_table)
        _save(ctx, tape, features, index_table, opt, spec, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return None, _grad_features(ctx, grad_out), None, None, None


class _ReplayWeightsFn(torch.autograd.Function):
    """`replay_render_weighted` (JAX: `_replay_call_w`): the weights carry
    no gradient."""

    @staticmethod
    def forward(ctx, tape, features, index_table, opt, spec):
        out, waccum = replay_forward(tape, features, opt, spec, True, index_table)
        ctx.mark_non_differentiable(waccum)
        _save(ctx, tape, features, index_table, opt, spec, out)
        return out, waccum

    @staticmethod
    def backward(ctx, grad_out, grad_waccum):
        del grad_waccum
        return None, _grad_features(ctx, grad_out), None, None, None


def unsort_output(tape: RayTape, out_sorted):
    """Replay output rows in the original ray order: the port's tapes keep
    rays in input order, so this is the identity (JAX `unsort_output`)."""
    del tape
    return out_sorted


def replay_render(tape: RayTape, features, opt: RenderOptions, spec=None,
                  *, unsort: bool = True, index_table=None):
    """Render by replaying a recorded tape — differentiable with respect
    to ``features`` (exact mode: K13d; thresholded modes: the backward
    march over the tape's rays). ``spec`` supplies per-voxel
    transformation matrices and SG/ASG extra data, and the skip-box base
    of the geometry check. ``index_table`` (data-indirect tapes only):
    the frame's `pack_index_table`. ``unsort`` is accepted for the JAX
    API: rows are in input order either way.

    Returns (B, n_color + 1)."""
    del unsort
    return _ReplayFn.apply(tape, features, index_table, opt, spec)


def replay_render_weighted(tape: RayTape, features, opt: RenderOptions,
                           spec=None, *, unsort: bool = True,
                           index_table=None):
    """Replay + weight accumulation (as `volume_render_with_weight_accum`:
    differentiable with respect to ``features`` through the colors; the
    weights, (n_cells,) float32 summed per tree cell, carry no gradient).
    Returns (out, waccum)."""
    del unsort
    return _ReplayWeightsFn.apply(tape, features, index_table, opt, spec)


# ---------------------------------------------------------------------------
# A stack of frames (K13e)


def frame_pools(features_frames) -> list:
    """The N pools of an (N, M, D) stack: a tensor's frames, or for an
    int8 stack (`QuantizedFeatures` with q (N, M, D) and scale and zero
    (N, D), as the JAX package scans one) each frame's quantized pool."""
    if features_frames.ndim != 3:
        raise ValueError(f"features_frames must be (N, M, D), got {tuple(features_frames.shape)}")
    if isinstance(features_frames, QuantizedFeatures):
        q, scale, zero = features_frames
        return [QuantizedFeatures(q[n], scale[n], zero[n]) for n in range(q.shape[0])]
    return list(features_frames.unbind(0))


def replay_forward_frames_plain(tape: RayTape, features_frames, opt: RenderOptions, spec=None,
                                index_table=None):
    """Plain PyTorch version of K13c's frame axis: (N, B, n_color + 1), frame
    n the plain K13c (`replay_forward_plain`) of pool n."""
    outs = [replay_forward_plain(tape, f, opt, spec, False, index_table)[0]
            for f in frame_pools(features_frames)]
    if outs:
        return torch.stack(outs)
    n_color = get_out_data_dim(opt.format, opt.basis_dim, features_frames.shape[2]) - 1
    return torch.empty(0, tape.n_rays, n_color + 1, dtype=pool_dtype(features_frames), device=tape.device)


def replay_forward_frames_cuda(tape: RayTape, features_frames, opt: RenderOptions, spec=None,
                               index_table=None, width: Optional[int] = None):
    """Launch K13c's frame axis (csrc/tape_replay_fwd.cu's
    `svox_tape_replay_fwd_frames`; the bf16 and int8 stacks' instances of
    csrc/tape_replay.cuh) once for all N frames of a contiguous (N, M, D)
    stack (an int8 stack: q (N, M, D), scale and zero (N, D)): (N, B,
    n_color + 1) float32, frame n `replay_forward_cuda` on pool n bit for
    bit. An empty tape or stack launches nothing. ``width`` as
    `replay_forward_cuda`'s."""
    spec_v = spec if spec is not None else _NOSPEC
    N, M, D = features_frames.shape
    if not N:
        n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
        return torch.empty(0, tape.n_rays, n_color + 1, dtype=torch.float32, device=tape.device)
    frame0 = frame_pools(features_frames)[0]
    n_color = check_format(spec_v, frame0, opt)
    kernel = _replay_kernel(_REPLAY_FWD_FRAMES, features_frames)
    ray_args, table_args = _tape_args(tape, features_frames, index_table, "replay_forward_frames_cuda")
    rad = radiometry_args(spec_v, frame0, opt, n_color)
    _require(N <= 65535, "K13c's frame axis takes at most 65535 frames")
    out = torch.empty(N, tape.n_rays, n_color + 1, dtype=torch.float32, device=tape.device)
    if tape.n_rays:
        _launch_fwd(kernel, (tape.offsets.data_ptr(), tape.idx.data_ptr(), tape.dt.data_ptr(), *ray_args,
                             *table_args, *rad, opt.background_brightness, opt.sigma_thresh,
                             opt.stop_thresh, out.data_ptr(), N),
                    features_frames, opt, _stream(tape.device), width)
    return out


def replay_forward_frames(tape: RayTape, features_frames, opt: RenderOptions, spec=None,
                          index_table=None):
    """N replays of one tape over a stack of N pools, (N, B, n_color + 1):
    K13c's frame axis on CUDA (one launch), its plain version on the CPU."""
    for f in frame_pools(features_frames):
        _check_replay(tape, f, opt, spec, index_table)
    run = replay_forward_frames_cuda if tape.dt.is_cuda else replay_forward_frames_plain
    return run(tape, features_frames, opt, spec, index_table)


def replay_backward_frames_plain(tape: RayTape, features_frames, opt: RenderOptions, grad_outs, outs,
                                 spec=None, index_table=None):
    """Plain PyTorch version of K13e (exact options): the N frames'
    gradients (N, M, D) in `pool_dtype`, each the plain K13d of its frame."""
    if not features_frames.shape[0]:
        return torch.zeros(features_frames.shape, dtype=pool_dtype(features_frames),
                           device=features_frames.device)
    return torch.stack([replay_backward_plain(tape, f, opt, g, o, spec, index_table)
                        for f, g, o in zip(features_frames.unbind(0), grad_outs.unbind(0),
                                           outs.unbind(0))])


def replay_backward_frames_cuda(tape: RayTape, features_frames, opt: RenderOptions, grad_outs, outs,
                                spec=None, index_table=None, width: Optional[int] = None):
    """Launch K13e (csrc/tape_replay_bwd.cu's frame axis; the bf16 stack's
    instance of csrc/tape_replay.cuh) once for all N frames of a contiguous
    (N, M, D) stack, into a zeroed float32 (N, M, D) gradient, exact
    options. An empty pool, tape or stack returns zeros without a launch.
    ``width`` as `replay_backward_cuda`'s."""
    spec_v = spec if spec is not None else _NOSPEC
    N, M, D = features_frames.shape
    frame0 = features_frames[0] if N else features_frames.new_empty(M, D)
    n_color = check_format(spec_v, frame0, opt)
    kernel = _replay_kernel(_REPLAY_BWD_FRAMES, features_frames)
    ray_args, table_args = _tape_args(tape, features_frames, index_table, "replay_backward_frames_cuda")
    rad = radiometry_args(spec_v, frame0, opt, n_color)
    for t in (grad_outs, outs):
        _require(t.is_cuda and t.device == tape.device and t.is_contiguous()
                 and t.dtype == torch.float32 and tuple(t.shape) == (N, tape.n_rays, n_color + 1),
                 f"grad_outs and outs must be contiguous ({N}, {tape.n_rays}, {n_color + 1}) float32")
    _require(N <= 65535, "K13e takes at most 65535 frames")
    grad = torch.zeros(N, M, D, dtype=torch.float32, device=tape.device)
    if N and M and tape.n_rays:
        _launch_bwd(kernel, (tape.offsets.data_ptr(), tape.idx.data_ptr(), tape.dt.data_ptr(), *ray_args,
                             *table_args, *rad, grad_outs.data_ptr(), outs.data_ptr(), grad.data_ptr(), N),
                    features_frames, grad, opt, _stream(tape.device), width)
    return grad


def replay_backward_frames(tape: RayTape, features_frames, opt: RenderOptions, grad_outs, outs,
                           spec=None, index_table=None):
    """Gradients of N independent replays of one tape, (N, M, D) in the
    stack's type (summed in float32 and cast once). Exact mode: K13e over
    the tape for all frames at once (its plain version on the CPU).
    Thresholded modes take each frame's `replay_backward`, the backward
    march K3 over the tape's rays, as the JAX package's per-frame fallback
    does."""
    if isinstance(features_frames, QuantizedFeatures):
        raise TypeError("a quantized feature pool takes no gradient")
    pools = frame_pools(features_frames)
    for f in pools:
        _check_replay(tape, f, opt, spec, index_table)
    if pools and not (opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0):
        return torch.stack([replay_backward(tape, f, opt, g, o, spec, index_table)
                            for f, g, o in zip(pools, grad_outs.unbind(0), outs.unbind(0))])
    run = replay_backward_frames_cuda if tape.dt.is_cuda else replay_backward_frames_plain
    return run(tape, features_frames, opt, grad_outs, outs, spec, index_table).to(features_frames.dtype)


class _ReplayFramesFn(torch.autograd.Function):
    """`replay_render_frames` (JAX: `_replay_call_frames`' custom_vjp): the
    forward is one launch of K13c's frame axis for the stack, the backward
    one K13e."""

    @staticmethod
    def forward(ctx, tape, features_frames, index_table, opt, spec):
        outs = replay_forward_frames(tape, features_frames, opt, spec, index_table)
        _save(ctx, tape, features_frames, index_table, opt, spec, outs)
        return outs

    @staticmethod
    def backward(ctx, grad_outs):
        grad = None
        if ctx.needs_input_grad[1]:
            features_frames, outs = ctx.saved_tensors
            grad = replay_backward_frames(ctx.tape, features_frames, ctx.opt, grad_outs.contiguous(),
                                          outs, ctx.spec, ctx.index_table)
        return None, grad, None, None, None


def replay_render_frames(tape: RayTape, features_frames, opt: RenderOptions, spec=None,
                         *, unsort: bool = True, index_table=None):
    """Replay one tape over a stack of N pools ``features_frames`` (N, M,
    D): frame n is ``replay_render(tape, features_frames[n], ...)`` bit for
    bit. Differentiable with respect to the stack: the N gradients are
    independent (frames share the tape's samples, not values) and come
    from one K13e launch in exact mode. ``spec`` and ``index_table`` are
    shared by the frames; ``unsort`` as in `replay_render`.

    Returns (N, B, n_color + 1)."""
    del unsort
    if features_frames.ndim != 3:
        raise ValueError(f"features_frames must be (N, M, D), got {tuple(features_frames.shape)}")
    return _ReplayFramesFn.apply(tape, features_frames, index_table, opt, spec)


# ---------------------------------------------------------------------------
# Depth replay (K13f)


def replay_depth_plain(tape: RayTape, features, sigma_thresh: float, index_table=None):
    """Plain PyTorch version of K13f: (B, 1) float32, per ray tval * dscale
    of its first sample whose (resolved) row lies in [0, M) and whose sigma,
    as float32, exceeds ``sigma_thresh``; 0 for a ray with none."""
    B, n = tape.n_rays, tape.n_samples
    M = features.shape[0]
    dev = tape.device
    if M == 0 or n == 0:
        return torch.zeros(B, 1, dtype=torch.float32, device=dev)
    rows = tape.idx if index_table is None else _resolve_cells(_flat_table(index_table), tape.idx)
    ok = (rows >= 0) & (rows < M)
    sigma = features[torch.where(ok, rows, 0).long(), -1].to(torch.float32)
    pos = torch.arange(n, device=dev)
    hit = torch.where(ok & (sigma > sigma_thresh), pos, n)
    ray = torch.repeat_interleave(torch.arange(B, device=dev), tape.counts.long())
    first = torch.full((B,), n, dtype=torch.long, device=dev).scatter_reduce(0, ray, hit, "amin")
    found = first < n
    t = tape.tval[torch.where(found, first, 0)]
    return torch.where(found, t * tape.dscale, 0.0)[:, None]


def replay_depth_cuda(tape: RayTape, features, sigma_thresh: float, index_table=None):
    """Launch K13f (csrc/tape_depth.cu) on a float32 or bf16 pool: (B, 1)."""
    dev = tape.device
    kind = pool_kind(features)
    if kind not in ("f32", "bf16"):
        raise ValueError(f"svox_tape_depth has no kernel instance for a {kind} feature pool "
                         "(instances: f32, bf16)")
    table = _flat_table(index_table)
    ints = [tape.offsets, tape.idx] + ([] if table is None else [table])
    floats = [tape.tval, tape.dscale]
    for t in (features, *ints, *floats):
        _require(t.is_cuda and t.device == dev and t.is_contiguous(),
                 "replay_depth_cuda needs contiguous tensors on one CUDA device")
    _require(all(t.dtype == torch.int32 for t in ints), "replay_depth_cuda: tape streams and table must be int32")
    _require(all(t.dtype == torch.float32 for t in floats), "replay_depth_cuda: tval and dscale must be float32")
    _require(tuple(tape.offsets.shape) == (tape.n_rays + 1,), "offsets must be (B + 1,)")
    M, D = features.shape
    depth = torch.empty(tape.n_rays, 1, dtype=torch.float32, device=dev)
    if tape.n_rays:
        TAPE_DEPTH(tape.offsets.data_ptr(), tape.idx.data_ptr(), tape.tval.data_ptr(),
                   tape.dscale.data_ptr(), tape.n_rays,
                   None if table is None else table.data_ptr(), 0 if table is None else table.shape[0],
                   features.data_ptr(), int(kind == "bf16"), M, D, sigma_thresh, depth.data_ptr(),
                   *_stream(dev))
    return depth


def replay_depth(tape: RayTape, features, opt: RenderOptions, spec=None,
                 *, unsort: bool = True, index_table=None):
    """First-hit depth by tape replay (JAX `replay_depth`): per ray the
    march parameter t of the first sample whose sigma exceeds
    ``opt.sigma_thresh`` in a resident leaf, times delta_scale, 0 where
    none: `render_depth` on the recorded rays, bit for bit. Needs a tape
    recorded with ``record_t=True``; a data-indirect tape resolves
    residency through ``index_table``, so depth follows each frame's
    occupancy. Not differentiable; nearest mode only. K13f on CUDA, its
    plain version on the CPU. ``unsort`` is accepted for the JAX API.

    Returns (B, 1) float32."""
    del unsort
    if tape.tval is None:
        raise ValueError("tape has no per-sample t — record with record_t=True for depth replay")
    if opt.interp:
        raise ValueError("tapes do not support opt.interp")
    if isinstance(features, QuantizedFeatures):
        raise NotImplementedError("replay_depth: pass the float pool (quantized pools are an "
                                  "inference color path)")
    if opt.pool_axis is not None:
        raise NotImplementedError("replay_depth: sharded pools not supported")
    _check_indirect(tape, index_table)
    _check_geom(tape, spec, opt)
    if features.ndim != 2:
        raise ValueError(f"features must be (M, D), got {tuple(features.shape)}")
    if features.shape[0] != tape.n_features:
        raise ValueError(
            f"feature pool has {features.shape[0]} rows but the tape was "
            f"recorded against {tape.n_features} — the structure changed; "
            "re-record the tape"
        )
    devices = {features.device, tape.device} | ({index_table.device} if index_table is not None else set())
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    run = replay_depth_cuda if tape.dt.is_cuda else replay_depth_plain
    with torch.no_grad():
        return run(tape, features, float(opt.sigma_thresh), index_table)
