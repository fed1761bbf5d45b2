"""svox_t_tpu_torch's recorded sample tapes (K13) against the JAX package (CPU).

`record_tape`, `replay_render`, `replay_render_weighted`, their gradients,
data-indirect tapes, the guards and the renderer's tape entry points, on
depth-5 shell trees (`helpers.build_tree`) with seeded rays, on both
backends, exact and fast, compacted and not.

The two packages lay tapes out differently (JAX: count-sorted chunks of
rays; the port: one flat run per ray in input order), so the JAX tape's
streams are mapped to rays through its ``inv_pos`` and ``counts``
(`utils/convert.py` `tape_from_jax`). Ray setup can differ by an ulp of
1/|d| between the JAX package's jitted march and the port (see
tests/test_torch_bake.py), which can move a fast-mode ray's samples, so
counts and the idx/cell streams compare exactly on the rays whose setup
agrees bit for bit, dt and t within 1e-6. Replays compare with JAX at
1e-5 (the JAX replay forms L per round, the port per sample; in fast mode
on the rays whose setup agrees, leaving out rays whose alpha lies within
1e-6 of 1 - stop_thresh), gradients at ``1e-5 * max(1, max|g|)``. Within
the port, the plain replay equals the plain march bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops import tape as jtape
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import tape as ttape
from svox_t_tpu_torch.utils.convert import tape_from_jax
from svox_t_tpu_torch.utils.spec import FORMAT_ASG, FORMAT_RGBA, FORMAT_SG, FORMAT_SH

from helpers import build_tree, make_rays

ATOL = 1e-5
FORMATS = {"RGBA": 4, "SH4": 13, "SH9": 28}
COMBOS = [(fmt, backend, fast, compact) for fmt in FORMATS for backend in ("baked", "tree")
          for fast in (False, True) for compact in (False, True)]


def _ids(c):
    fmt, backend, fast, compact = c
    return f"{fmt}-{backend}-{'fast' if fast else 'exact'}-{'compact' if compact else 'full'}"


def _shell(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


def _t(x):
    return torch.from_numpy(np.array(x))


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _same_setup(jt, rays):
    """Mask of the rays whose ray setup agrees bit for bit between the
    JAX package's jitted march and the port."""
    spec = jt._spec()
    jo = jax.jit(lambda o, d: jrender._ray_setup(spec, o, d))(rays.origins, rays.dirs)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    to = trender._ray_setup(pt._spec(), _t(rays.origins), _t(rays.dirs))
    same = np.ones(len(np.asarray(rays.origins)), bool)
    for a, b in zip(jo[:4], to[:4]):
        same &= (np.asarray(a) == b.numpy()).reshape(len(same), -1).all(axis=1)
    return same


def _scene(fmt="SH9", seed=7, n_rays=192, **kw):
    """(JAX tree, port tree, pool (numpy), rays) of a depth-5 shell."""
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, N=2, data_dim=FORMATS.get(fmt, 13), depth_limit=5,
                              n_random_refines=2, data_format=fmt, occupy=_shell, **kw)
    rays = make_rays(rng, n_rays)
    return jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu"), np.array(feats), rays


@functools.lru_cache(maxsize=None)
def _shared(fmt):
    """A format's scene, shared by the record and replay tests (never
    edited), with its same-setup mask."""
    jt, pt, feats, rays = _scene(fmt)
    return jt, pt, feats, rays, _same_setup(jt, rays)


def _specs(jt, pt, backend, **kw):
    if backend == "baked":
        return jt._baked_spec(**kw), pt._baked_spec(**kw and {
            "transformation_matrices": _t(kw["transformation_matrices"])})
    tm = kw.get("transformation_matrices")
    return jt._spec(tm), pt._spec(None if tm is None else _t(tm))


def _options(jt, fast):
    return dataclasses.replace(st.VolumeRenderer(jt)._get_options(fast), chunk_size=64)


def _jax_arrays(tp):
    """A JAX RayTape's fields as NumPy arrays and meta (`tape_from_jax`)."""
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(tp) for v in [getattr(tp, f.name)]}


@functools.lru_cache(maxsize=None)
def _tapes(fmt, backend, fast, compact):
    """(JAX tape, its JAX replay (out, waccum), port tape) of a combo."""
    jt, pt, feats, rays, _ = _shared(fmt)
    jspec, tspec = _specs(jt, pt, backend)
    opt = _options(jt, fast)
    M = feats.shape[0]
    jtp = jtape.record_tape(jspec, M, rays.origins, rays.dirs, rays.viewdirs, opt,
                            compact=compact, record_t=True)
    jout = jtape.replay_render_weighted(jtp, jnp.asarray(feats), opt, jspec)
    r = _trays(rays)
    ttp = ttape.record_tape(tspec, M, r.origins, r.dirs, r.viewdirs, opt, compact=compact,
                            record_t=True)
    return jtp, tuple(np.asarray(x) for x in jout), ttp


def _ray_of_sample(tape):
    return np.repeat(np.arange(tape.n_rays), tape.counts.numpy())


def _compare(got, want, keep=None, stop_thresh=0.0):
    """atol 1e-5 on the rays of ``keep``; with early stop, rays whose alpha
    lies within 1e-6 of 1 - stop_thresh are left out (the per-round and
    per-sample L can put the stop sample one apart there). Returns the
    rays compared."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(len(got), bool) if keep is None else keep.copy()
    if stop_thresh > 0:
        near = lambda a: np.abs(a[:, -1] - (1.0 - stop_thresh)) < 1e-6  # noqa: E731
        keep &= ~(near(got) | near(want))
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL)
    return keep


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


# ---------------------------------------------------------------------------
# Recording and replay against the JAX package


@pytest.mark.parametrize("combo", COMBOS, ids=_ids)
def test_record_parity(combo):
    """Counts, idx and cell streams equal to the JAX tape's on the rays
    whose setup agrees; dt and t within 1e-6; meta as JAX's."""
    jtp, _, ttp = _tapes(*combo)
    same = _shared(combo[0])[4]
    assert same.mean() > 0.5
    jt = tape_from_jax(_jax_arrays(jtp), device="cpu")
    np.testing.assert_array_equal(ttp.counts.numpy()[same], jt.counts.numpy()[same])
    mp, mj = same[_ray_of_sample(ttp)], same[_ray_of_sample(jt)]
    for name in ("idx", "cell"):
        np.testing.assert_array_equal(getattr(ttp, name).numpy()[mp], getattr(jt, name).numpy()[mj])
    for name in ("dt", "tval"):
        np.testing.assert_allclose(getattr(ttp, name).numpy()[mp], getattr(jt, name).numpy()[mj],
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(ttp.dscale.numpy(), jt.dscale.numpy(), rtol=1e-6)
    assert (ttp.n_rays, ttp.compact, ttp.n_features) == (jtp.n_rays, jtp.compact, jtp.n_features)
    assert ttp.geom == jtp.geom and ttp.n_samples > 0
    assert ttp.S == int(ttp.counts.max())
    torch.testing.assert_close(ttp.inv_pos, torch.arange(ttp.n_rays, dtype=torch.int32))


@pytest.mark.parametrize("combo", COMBOS, ids=_ids)
def test_replay_parity(combo):
    """`replay_render` and `replay_render_weighted` against the JAX
    package's at 1e-5."""
    fmt, backend, fast, compact = combo
    jtp, (jout, jw), ttp = _tapes(*combo)
    jt, pt, feats, rays, same = _shared(fmt)
    _, tspec = _specs(jt, pt, backend)
    opt = _options(jt, fast)
    out = ttape.replay_render(ttp, _t(feats), opt, tspec)
    outw, w = ttape.replay_render_weighted(ttp, _t(feats), opt, tspec)
    assert torch.equal(out, outw)
    keep = _compare(out, jout, same if fast else None, opt.stop_thresh)
    if fast:
        # Weights sum over rays: compare tapes of the compared rays alone.
        jspec = _specs(jt, pt, backend)[0]
        sub = st.Rays(*(jnp.asarray(np.asarray(x)[keep]) for x in rays))
        jtp2 = jtape.record_tape(jspec, feats.shape[0], sub.origins, sub.dirs, sub.viewdirs, opt,
                                 compact=compact)
        jw = np.asarray(jtape.replay_render_weighted(jtp2, jnp.asarray(feats), opt, jspec)[1])
        r = _trays(sub)
        ttp2 = ttape.record_tape(tspec, feats.shape[0], r.origins, r.dirs, r.viewdirs, opt,
                                 compact=compact)
        w = ttape.replay_render_weighted(ttp2, _t(feats), opt, tspec)[1]
    n = min(w.shape[0], jw.shape[0])
    np.testing.assert_allclose(w.numpy()[:n], jw[:n], atol=ATOL)
    assert not w[n:].any() and not jw[n:].any()
    if not fast:
        assert float(w.sum()) > 0


@pytest.mark.parametrize("combo", COMBOS, ids=_ids)
def test_plain_replay_equals_plain_march(combo):
    """The plain replay (K13c's plain version) equals the plain march bit
    for bit, compacted or not, weights within 1e-5 (summed in another
    order)."""
    fmt, backend, fast, compact = combo
    _, _, ttp = _tapes(*combo)
    jt, pt, feats, rays, _ = _shared(fmt)
    _, tspec = _specs(jt, pt, backend)
    opt = _options(jt, fast)
    r = _trays(rays)
    ref, wref = trender.volume_render_with_weight_accum_plain(tspec, _t(feats), r.origins, r.dirs,
                                                              r.viewdirs, opt)
    out, w = ttape.replay_forward_plain(ttp, _t(feats), opt, tspec, True)
    assert torch.equal(out, ref)
    torch.testing.assert_close(w, wref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("combo", [("SH9", "baked", False, True), ("SH9", "baked", True, True),
                                   ("RGBA", "tree", False, False)], ids=_ids)
def test_tape_from_jax_replays_every_ray(combo):
    """A JAX-recorded tape carried over (`tape_from_jax`) replays through
    the port equal to JAX's replay on every ray at 1e-5: no ray setup of
    the port's in the way."""
    fmt, backend, fast, compact = combo
    jtp, (jout, _), _ = _tapes(*combo)
    jt, pt, feats, rays, _ = _shared(fmt)
    _, tspec = _specs(jt, pt, backend)
    opt = _options(jt, fast)
    tp = tape_from_jax(_jax_arrays(jtp), device="cpu")
    assert tp.n_samples == int(np.asarray(jtp.counts).sum())
    _compare(ttape.replay_render(tp, _t(feats), opt, tspec), jout, stop_thresh=opt.stop_thresh)


def _sg_scene():
    rng = np.random.RandomState(4)
    extra = rng.rand(4, 4).astype(np.float32)
    extra[:, 1:4] /= np.linalg.norm(extra[:, 1:4], axis=1, keepdims=True)
    jt, pt, feats, rays = _scene("SG4", seed=4, n_rays=128, extra_data=extra)
    return jt, pt, feats, rays


def _rotations(M, seed=3):
    rng = np.random.RandomState(seed)
    tm = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    ang = rng.rand(M).astype(np.float32) * 0.5
    tm[:, 0, 0], tm[:, 0, 1] = np.cos(ang), -np.sin(ang)
    tm[:, 1, 0], tm[:, 1, 1] = np.sin(ang), np.cos(ang)
    return tm


@pytest.mark.parametrize("case", ["sg_extra", "sh9_rotations", "bf16", "int8", "empty_pool",
                                  "miss_rays"])
def test_replay_cases_match_jax(case):
    """SG with extra_data, SH9 with transformation matrices, bf16 and int8
    pools, an empty pool and rays that miss, against the JAX replay (the
    baked backend, exact, compacted)."""
    if case == "sg_extra":
        jt, pt, feats, rays = _sg_scene()
    else:
        jt, pt, feats, rays, _ = _shared("SH9")
    kw = {"transformation_matrices": _rotations(feats.shape[0])} if case == "sh9_rotations" else {}
    jspec, tspec = _specs(jt, pt, "baked", **kw)
    opt = _options(jt, False)
    jpool, tpool = jnp.asarray(feats), _t(feats)
    if case == "bf16":
        jpool, tpool = jpool.astype(jnp.bfloat16), tpool.to(torch.bfloat16)
    elif case == "int8":
        jpool = st.quantize_features(jpool)
        tpool = stt.quantized_from_numpy(*(np.asarray(a) for a in jpool), device="cpu")
    elif case == "empty_pool":
        jpool, tpool = jnp.zeros((0, feats.shape[1])), torch.zeros(0, feats.shape[1])
    if case == "miss_rays":
        o = np.full((40, 3), 5.0, np.float32)
        d = np.tile(np.asarray([1.0, 0, 0], np.float32), (40, 1))
        rays = st.Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d))
    M = tpool.shape[0]
    jtp = jtape.record_tape(jspec, M, rays.origins, rays.dirs, rays.viewdirs, opt)
    want = np.asarray(jtape.replay_render(jtp, jpool, opt, jspec))
    r = _trays(rays)
    ttp = ttape.record_tape(tspec, M, r.origins, r.dirs, r.viewdirs, opt)
    got = ttape.replay_render(ttp, tpool, opt, tspec)
    _compare(got, want)
    if case in ("bf16", "int8"):
        wide = tpool.float() if case == "bf16" else tpool.dequantize()
        assert torch.equal(got, ttape.replay_render(ttp, wide, opt, tspec))
    if case in ("empty_pool", "miss_rays"):
        np.testing.assert_array_equal(got[:, -1].numpy(), 0.0)
        np.testing.assert_array_equal(got[:, :-1].numpy(), 1.0)


@pytest.mark.parametrize("fmt", ["RGBA", "SH4", "SH9", "SH9-rot"])
@pytest.mark.parametrize("mode", ["exact-compact", "exact-full", "fast-compact"])
def test_replay_gradients(mode, fmt):
    """The replay's pool gradient against JAX's replay VJP and the port's
    march VJP, in each format (D = 4, 13 and 28, the tape backward's
    vector widths 4, 1 and 4 on the card) and with per-voxel rotations;
    fast mode takes the backward-march fallback."""
    fast, compact = mode.startswith("fast"), mode.endswith("compact")
    base = fmt.split("-")[0]
    jtp, _, ttp = _tapes(base, "baked", fast, compact)
    jt, pt, feats, rays, same = _shared(base)
    kw = {"transformation_matrices": _rotations(feats.shape[0])} if fmt.endswith("-rot") else {}
    jspec, tspec = _specs(jt, pt, "baked", **kw)
    opt = _options(jt, fast)
    r = _trays(rays)
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jtape.replay_render(jtp, f, opt, jspec) ** 2))(
        jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (ttape.replay_render(ttp, f, opt, tspec) ** 2).sum().backward()
    f2 = _t(feats).requires_grad_()
    (trender.volume_render(tspec, f2, r.origins, r.dirs, r.viewdirs, opt) ** 2).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), f2.grad.numpy(), atol=_gtol(f2.grad))
    if not fast:  # fast mode: the packages' rays may start an ulp apart (module docstring)
        np.testing.assert_allclose(f.grad.numpy(), g_j, atol=_gtol(g_j))
    assert float(f.grad.abs().max()) > 0


@pytest.mark.parametrize("fmt,bd,D,pool_off,elem,grad_off,want", [
    ("SH", 9, 28, 0, 4, 0, 4), ("SH", 9, 28, 0, 2, 0, 4), ("SH", 1, 4, 0, 4, 0, 4), ("RGBA", 0, 4, 0, 4, 0, 4),
    ("RGBA", 0, 4, 0, 2, 0, 4), ("SH", 4, 13, 0, 4, 0, 1), ("SH", 9, 32, 0, 4, 0, 1), ("SH", 16, 49, 0, 4, 0, 1),
    ("SG", 9, 28, 0, 4, 0, 1), ("SG", 7, 22, 0, 4, 0, 1), ("ASG", 9, 28, 0, 4, 0, 1), ("RGBA", 0, 8, 0, 4, 0, 1),
    ("SH", 9, 28, 4, 4, 0, 1), ("SH", 9, 28, 8, 4, 0, 1), ("SH", 9, 28, 0, 4, 8, 1), ("SH", 9, 28, 4, 2, 0, 1),
    ("SH", 9, 28, 8, 2, 0, 4)])
def test_replay_bwd_width(fmt, bd, D, pool_off, elem, grad_off, want):
    """K13d / K13e's vector width from the format, basis and row width and
    the pool's and the gradient's alignment (fake pointers): 4 for the
    three-colour RGBA, SH1 and SH9 rows with no spare column on 4-value
    boundaries, else 1."""
    base = 1 << 20
    code = {"RGBA": FORMAT_RGBA, "SH": FORMAT_SH, "SG": FORMAT_SG, "ASG": FORMAT_ASG}[fmt]
    assert ttape.replay_bwd_width(code, bd, D, base + pool_off, elem, base + grad_off) == want


@pytest.mark.parametrize("fmt,bd,D,pool_off,elem,scale_off,want", [
    ("SH", 9, 28, 0, 4, None, 4), ("SH", 9, 28, 0, 2, None, 4), ("SH", 9, 28, 0, 1, 0, 4),
    ("SH", 1, 4, 0, 4, None, 4), ("RGBA", 0, 4, 0, 4, None, 4), ("RGBA", 0, 4, 0, 1, 0, 4),
    ("SH", 4, 13, 0, 4, None, 1), ("SH", 9, 32, 0, 4, None, 1), ("SH", 16, 49, 0, 4, None, 1),
    ("SG", 9, 28, 0, 4, None, 1), ("SG", 7, 22, 0, 1, 0, 1), ("ASG", 9, 28, 0, 4, None, 1),
    ("RGBA", 0, 8, 0, 4, None, 1), ("SH", 9, 28, 4, 4, None, 1), ("SH", 9, 28, 8, 4, None, 1),
    ("SH", 9, 28, 16, 4, None, 4), ("SH", 9, 28, 4, 2, None, 1), ("SH", 9, 28, 8, 2, None, 4),
    ("SH", 9, 28, 2, 1, 0, 1), ("SH", 9, 28, 4, 1, 0, 4), ("SH", 9, 28, 0, 1, 4, 1),
    ("SH", 9, 28, 0, 1, 8, 1), ("SH", 9, 28, 0, 1, 32, 4)])
def test_replay_fwd_width(fmt, bd, D, pool_off, elem, scale_off, want):
    """K13c's vector width from the format, basis and row width and the
    pool's alignment (fake pointers; an int8 pool, one byte a value, also
    its scale and zero): 4 for the three-colour RGBA, SH1 and SH9 rows with
    no spare column whose pool lies on a 4-value boundary (and an int8
    pool's scale and zero on 16 bytes), else 1. Unlike the backward's, no
    gradient pointer takes part."""
    base = 1 << 20
    code = {"RGBA": FORMAT_RGBA, "SH": FORMAT_SH, "SG": FORMAT_SG, "ASG": FORMAT_ASG}[fmt]
    scales = () if scale_off is None else (base + scale_off, base + 4096 + scale_off)
    assert ttape.replay_fwd_width(code, bd, D, base + pool_off, elem, scales) == want


def test_replay_bf16_gradient_and_quantized():
    """A bf16 pool's gradient comes back bf16, its float32 sum within a bf16
    ulp of the float32 pool's; an int8 pool takes none."""
    _, _, ttp = _tapes("SH9", "baked", False, True)
    jt, pt, feats, _, _ = _shared("SH9")
    _, tspec = _specs(jt, pt, "baked")
    opt = _options(jt, False)
    fb = _t(feats).to(torch.bfloat16).requires_grad_()
    (ttape.replay_render(ttp, fb, opt, tspec) ** 2).sum().backward()
    assert fb.grad.dtype == torch.bfloat16
    fw = fb.detach().float().requires_grad_()
    (ttape.replay_render(ttp, fw, opt, tspec) ** 2).sum().backward()
    torch.testing.assert_close(fb.grad, fw.grad.to(torch.bfloat16), atol=0, rtol=0)
    q = stt.quantize_features(_t(feats))
    assert not ttape.replay_render(ttp, q, opt, tspec).requires_grad
    with pytest.raises(TypeError, match="no gradient"):
        ttape.replay_backward(ttp, q, opt, torch.zeros(ttp.n_rays, 4), torch.zeros(ttp.n_rays, 4),
                              tspec)


@pytest.mark.parametrize("compact", [False, True])
def test_indirect_tape_after_repoint(compact):
    """A data-indirect tape recorded on the tree walk, replayed after
    `construct_tree` re-points the tree (the occupied leaves' centres in a
    seeded order: the same occupancy, other rows), equals the port's march
    on the re-pointed tree bit for bit and JAX's indirect replay at 1e-5."""
    jt, pt, feats, rays = _scene("SH9", seed=11, n_rays=160)
    opt = _options(jt, False)
    M = feats.shape[0]
    r = _trays(rays)
    jtp = jtape.record_tape(jt._spec(), M, rays.origins, rays.dirs, rays.viewdirs, opt,
                            compact=compact, indirect=True)
    ttp = ttape.record_tape(pt._spec(), M, r.origins, r.dirs, r.viewdirs, opt, compact=compact,
                            indirect=True)
    assert ttp.indirect and torch.equal(ttp.idx, ttp.cell)
    centers = jt[:].corners_local + 0.5 * jt[:].lengths_local[:, None]
    centers = np.asarray(jax.device_get(jt.tree2world(jnp.asarray(centers))))
    centers = centers[_shell(centers)]
    points = centers[np.random.RandomState(5).permutation(len(centers))]
    jt.construct_tree(points)
    pt.construct_tree(_t(points))
    f2 = np.random.RandomState(6).randn(M, 28).astype(np.float32)
    f2[:, -1] = np.abs(f2[:, -1]) * 10.0
    table = ttape.pack_index_table(pt._spec().data_flat)
    got = ttape.replay_render(ttp, _t(f2), opt, pt._spec(), index_table=table)
    ref = trender.volume_render(pt._spec(), _t(f2), r.origins, r.dirs, r.viewdirs, opt)
    assert torch.equal(got, ref)
    want = jtape.replay_render(jtp, jnp.asarray(f2), opt, jt._spec(),
                               index_table=jtape.pack_index_table(jt._spec().data_flat))
    _compare(got, want)
    # The gradient of the indirect replay: the march's.
    fa, fb = _t(f2).requires_grad_(), _t(f2).requires_grad_()
    (ttape.replay_render(ttp, fa, opt, pt._spec(), index_table=table) ** 2).sum().backward()
    (trender.volume_render(pt._spec(), fb, r.origins, r.dirs, r.viewdirs, opt) ** 2).sum().backward()
    np.testing.assert_allclose(fa.grad.numpy(), fb.grad.numpy(), atol=_gtol(fb.grad))


# ---------------------------------------------------------------------------
# Guards


def test_stale_tape_guards():
    """Wrong pool rows (structure changed) and wrong geometry raise, as in
    the JAX package (tests/test_tape.py `test_stale_tape_guards`)."""
    _, _, ttp = _tapes("SH9", "baked", False, True)
    jt, pt, feats, _, _ = _shared("SH9")
    _, tspec = _specs(jt, pt, "baked")
    opt = _options(jt, False)
    with pytest.raises(ValueError, match="re-record"):
        ttape.replay_render(ttp, torch.zeros(feats.shape[0] + 3, 28), opt, tspec)
    with pytest.raises(ValueError, match="geometry"):
        ttape.replay_render(ttp, _t(feats), dataclasses.replace(opt, step_size=2e-3), tspec)
    with pytest.raises(ValueError, match="geometry"):
        ttape.replay_render(ttp, _t(feats), dataclasses.replace(opt, max_steps=7))
    _, _, ttp_fast = _tapes("SH9", "baked", True, True)
    with pytest.raises(ValueError, match="geometry"):
        ttape.replay_render(ttp_fast, _t(feats), opt, tspec)


def test_indirect_and_interp_refusals():
    """Interpolation, indirect tapes outside exact geometry, index tables on
    the wrong tape or of another structure, thresholded gradients of an
    indirect tape or without a spec, and weights without cells raise."""
    jt, pt, feats, rays, _ = _shared("SH9")
    _, tspec = _specs(jt, pt, "baked")
    r = _trays(rays)
    opt = _options(jt, False)
    M = feats.shape[0]
    rec = lambda o, **kw: ttape.record_tape(tspec, M, r.origins, r.dirs, r.viewdirs, o, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="interp"):
        rec(dataclasses.replace(opt, interp=1))
    with pytest.raises(ValueError, match="exact geometry"):
        rec(_options(jt, True), indirect=True)
    direct, indirect = rec(opt), ttape.record_tape(pt._spec(), M, r.origins, r.dirs, r.viewdirs, opt,
                                                    indirect=True)
    f = _t(feats)
    with pytest.raises(ValueError, match="interp"):
        ttape.replay_render(direct, f, dataclasses.replace(opt, interp=1), tspec)
    table = ttape.pack_index_table(pt._spec().data_flat)
    with pytest.raises(ValueError, match="indirect=True"):
        ttape.replay_render(direct, f, opt, tspec, index_table=table)
    with pytest.raises(ValueError, match="pass index_table"):
        ttape.replay_render(indirect, f, opt, pt._spec())
    with pytest.raises(ValueError, match="STRUCTURE"):
        ttape.replay_render(indirect, f, opt, pt._spec(), index_table=table[:-2])
    thr = dataclasses.replace(opt, sigma_thresh=1e-2)
    out = ttape.replay_render(indirect, f, thr, pt._spec(), index_table=table)
    with pytest.raises(ValueError, match="data-indirect"):
        ttape.replay_backward(indirect, f, thr, torch.ones_like(out), out, pt._spec(), table)
    with pytest.raises(ValueError, match="need `spec`"):
        ttape.replay_backward(direct, f, thr, torch.ones_like(out), out)
    no_cells = rec(opt, record_cells=False)
    assert no_cells.cell is None
    with pytest.raises(ValueError, match="record_cells=False"):
        ttape.replay_render_weighted(no_cells, f, opt, tspec)


def test_pack_index_table_matches_jax():
    jt, pt, _, _, _ = _shared("SH9")
    for width in (32, 7):
        want = np.asarray(jtape.pack_index_table(jt._spec().data_flat, width))
        got = ttape.pack_index_table(pt._spec().data_flat, width)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        n = pt._spec().data_flat.numel()
        np.testing.assert_array_equal(got.reshape(-1).numpy()[:n], want.reshape(-1)[:n])
        assert (got.reshape(-1)[n:] == int(stt.DATA_SENTINEL)).all()


# ---------------------------------------------------------------------------
# The renderer's tape entry points


def test_renderer_tape_api():
    """`record_rays` / `render_tape` equal `forward`, `record_persp` /
    `render_persp_tape` equal `render_persp` bit for bit (and JAX's
    `render_persp_tape` at 1e-5); the camera tape is cached, a record_t
    tape serves plain requests, a `refine` makes the cache stale; inside
    `accumulate_weights()` the replay adds forward's weights."""
    jt, pt, feats, rays = _scene("SH9", seed=9, n_rays=128)
    r = stt.VolumeRenderer(pt)
    f = _t(feats)
    tr = _trays(rays)
    for compact in (False, True):
        tp = r.record_rays(tr, features=f, compact=compact)
        assert torch.equal(r.render_tape(tp, f), r(f, tr))
    with pt.accumulate_weights() as acc_t:
        r.render_tape(r.record_rays(tr, n_features=f.shape[0]), f)
    with pt.accumulate_weights() as acc_f:
        r(f, tr)
    torch.testing.assert_close(acc_t.value, acc_f.value, atol=ATOL, rtol=0)
    assert float(acc_t.value.sum()) > 0

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    img_ref = r.render_persp(f, c2w, 24, 20, 24.0)
    img = r.render_persp_tape(f, c2w, 24, 20, 24.0)
    assert img.shape == img_ref.shape and torch.equal(img, img_ref)
    want = np.asarray(st.VolumeRenderer(jt).render_persp_tape(jnp.asarray(feats), c2w, 24, 20, 24.0))
    np.testing.assert_allclose(img.numpy(), want, atol=ATOL)
    n_cached = len(r._tape_cache)
    r.render_persp_tape(f, c2w, 24, 20, 24.0)
    assert len(r._tape_cache) == n_cached
    tp_t = r.record_persp(c2w, 24, 20, 24.0, features=f, compact=False, record_t=True)
    assert tp_t.tval is not None and len(r._tape_cache) == n_cached + 1
    assert r.record_persp(c2w, 24, 20, 24.0, features=f, compact=False) is tp_t
    g = f.clone().requires_grad_()
    (r.render_persp_tape(g, c2w, 24, 20, 24.0) ** 2).sum().backward()
    g2 = f.clone().requires_grad_()
    (r.render_persp(g2, c2w, 24, 20, 24.0) ** 2).sum().backward()
    torch.testing.assert_close(g.grad, g2.grad, atol=_gtol(g2.grad), rtol=0)

    # A structure change makes the cached tape stale (the key holds the
    # tree's layout and occupancy versions).
    pt.refine(sel=tuple(pt._all_leaves()[:1].T))
    centers = (pt[:].corners_local + 0.5 * pt[:].lengths_local[:, None])
    centers = pt.tree2world(torch.as_tensor(centers)).numpy()
    centers = centers[_shell(centers)]
    pt.construct_tree(_t(centers))
    f2 = _t(np.random.RandomState(0).randn(centers.shape[0], 28).astype(np.float32))
    img2 = r.render_persp_tape(f2, c2w, 24, 20, 24.0)
    assert torch.equal(img2, r.render_persp(f2, c2w, 24, 20, 24.0))
