"""The tape recorder's one-walk design (K13a+K13b) on the CPU.

`record_tape` walks each ray once (`stage_samples_plain`, the plain mirror
of `csrc/tape_record.cuh` `stage_kernel`: per-ray chunks of ARENA_CHUNK
entries, numbered in the order the rays ask for them, a chunk past the
arena's capacity counted and not written) and copies the staged samples
into the tape's runs (`copy_samples_plain`, `copy_kernel`'s mirror); a walk
that ran out of chunks reruns once with the capacity it reported. Its
streams must equal the earlier two walks' plain versions
(`count_samples_plain`, `record_samples_plain`) bit for bit on
`tests/test_torch_tape.py`'s small scenes: both structures, exact and
fast, compacted and not, indirect with t, an arena of one chunk, rays cut
by the step cap, rays that all miss, and a ray count that is not a
multiple of 32. `record_tape` against the JAX package stays in
`tests/test_torch_tape.py` (`test_record_parity`). The census
(`ops/tape_census.py`) must add up: the count walk's steps are the total
counts' sum, and the resumed and stopped walk never takes more steps than
the stopped one, nor that one more than the earlier record walk.
"""

import dataclasses
import re

import pytest
import torch

from svox_t_tpu_torch import _build
from svox_t_tpu_torch.ops import tape as ttape
from svox_t_tpu_torch.ops.tape_census import walk_census

from test_torch_tape import _options, _shared, _specs, _trays

BACKENDS = ("baked", "tree")


def _case(backend, fast=False, n_rays=None, **opt_kw):
    jt, pt, feats, rays, _ = _shared("SH9")
    spec = _specs(jt, pt, backend)[1]
    opt = dataclasses.replace(_options(jt, fast), **opt_kw)
    r = _trays(rays)
    o, d = r.origins, r.dirs
    if n_rays is not None:
        o, d = o[:n_rays].contiguous(), d[:n_rays].contiguous()
    return spec, feats.shape[0], o, d, opt


def _assert_pair_tape(spec, M, o, d, opt, compact, want_idx=True, want_cell=True, want_t=True, capacity=None):
    """record_streams equal to the count and record walks' plain versions;
    returns the reruns it took."""
    before = ttape.ARENA_RERUNS["reruns"]
    counts, offsets, S, idx, dt, cell, tval, dscale = ttape.record_streams(
        spec, M, o, d, opt, compact, want_idx, want_cell, want_t, capacity=capacity)
    n_occ, n_tot = ttape.count_samples_plain(spec, M, o, d, opt)
    want_counts = n_occ if compact else n_tot
    assert torch.equal(counts, want_counts)
    assert offsets.dtype == torch.int32 and torch.equal(offsets[1:], torch.cumsum(want_counts, 0).to(torch.int32))
    assert S == (int(want_counts.max()) if want_counts.numel() else 0)
    want = ttape.record_samples_plain(spec, M, o, d, opt, offsets, compact, want_idx, want_cell, want_t)
    for name, got, w in zip(("idx", "dt", "cell", "tval", "dscale"), (idx, dt, cell, tval, dscale), want):
        assert (got is None) == (w is None), name
        assert got is None or torch.equal(got, w), name
    return ttape.ARENA_RERUNS["reruns"] - before


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_tape_equals_the_pair(backend, fast, compact):
    """The arena sized by `arena_capacity` (these small scenes' rays are
    long: it may run short, and then reruns once), and an arena that
    holds every chunk."""
    case = _case(backend, fast)
    assert _assert_pair_tape(*case, compact) in (0, 1)
    assert _assert_pair_tape(*case, compact, capacity=case[2].shape[0] * 64) == 0


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_tape_one_chunk_arena_reruns(backend, compact):
    """An arena of one chunk: the walk counts the chunks it lacked, and the
    rerun with that capacity gives the same tape."""
    case = _case(backend)
    assert _assert_pair_tape(*case, compact, capacity=1) == 1
    st = ttape.stage_samples_plain(*case, compact, capacity=1)
    n = st.n_occ if compact else st.n_tot
    assert int(st.n_chunks[0]) == int(((n + ttape.ARENA_CHUNK - 1) // ttape.ARENA_CHUNK).sum()) > 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_indirect_tape_with_t(backend):
    """A data-indirect tape's streams (cells and t, no rows), exact."""
    spec, M, o, d, opt = _case(backend)
    assert _assert_pair_tape(spec, M, o, d, opt, True, want_idx=False, want_cell=True, want_t=True) in (0, 1)
    tp = ttape.record_tape(spec, M, o, d, d, opt, indirect=True, record_t=True)
    assert tp.idx is tp.cell and tp.tval is not None and tp.n_samples > 0


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_tape_at_the_step_cap(backend, compact):
    """max_steps cuts the rays: the staged walk stops where the pair does."""
    spec, M, o, d, opt = _case(backend, max_steps=5)
    assert _assert_pair_tape(spec, M, o, d, opt, compact) in (0, 1)
    assert int(ttape.count_samples_plain(spec, M, o, d, opt)[1].max()) == 5


@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_tape_all_rays_miss(backend):
    spec, M, o, d, opt = _case(backend)
    away = (o - 0.5) / (o - 0.5).norm(dim=1, keepdim=True)
    o = (0.5 + 3.0 * away).contiguous()
    counts, offsets, S, idx, dt, cell, tval, dscale = ttape.record_streams(spec, M, o, away.contiguous(), opt, True)
    assert int(offsets[-1]) == 0 and S == 0 and dt.numel() == 0 and idx.numel() == 0
    assert _assert_pair_tape(spec, M, o, away.contiguous(), opt, False) == 0


@pytest.mark.parametrize("n_rays", [1, 33, 77])
@pytest.mark.parametrize("backend", BACKENDS)
def test_staged_tape_ray_counts(backend, n_rays):
    """B not a multiple of 32, and one ray, with the arena's default
    capacity and with one chunk."""
    case = _case(backend, n_rays=n_rays)
    assert _assert_pair_tape(*case, True, capacity=n_rays * 64) == 0
    assert _assert_pair_tape(*case, False, capacity=1) in (0, 1)


def test_chunk_size_is_the_kernels():
    text = (_build.CSRC / "tape_record.cuh").read_text()
    assert re.search(r"constexpr int kChunk = (\d+);", text).group(1) == str(ttape.ARENA_CHUNK)


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_census_adds_up(backend, compact):
    spec, M, o, d, opt = _case(backend)
    c = walk_census(spec, M, o, d, opt, compact)
    n_occ, n_tot = ttape.count_samples_plain(spec, M, o, d, opt)
    assert c["count_steps"] == c["record_steps"] == int(n_tot.sum())
    assert c["occupied"] == int(n_occ.sum()) and c["samples"] == int((n_occ if compact else n_tot).sum())
    assert c["resume_stop_steps"] <= c["stop_steps"] <= c["record_steps"]
    assert c["prefix"] + c["interior"] + c["suffix"] + c["occupied"] + c["empty_ray_steps"] == c["count_steps"]
    if compact:
        assert c["stop_steps"] == c["record_steps"] - c["suffix"] - c["empty_ray_steps"]
        assert c["resume_stop_steps"] == c["occupied"] + c["interior"]
    st = ttape.stage_samples_plain(spec, M, o, d, opt, compact)
    assert c["arena_ii"]["chunks"] == int(st.n_chunks[0])
    for layout in ("i", "ii"):
        a = c[f"arena_{layout}"]
        assert a["entries"] == a["padding"] + c["samples"] and a["padding"] >= 0
