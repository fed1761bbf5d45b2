"""svox_t_tpu_torch's row-subset tape replay and minibatch training (K14)
against the JAX package (CPU).

The counterparts of the 14 tests of `tests/test_tape_subset.py`, on the
same depth-5 shell trees (`helpers.build_tree`) and seeded rays, with the
tape recorded in both packages from the same rays and the same ray ids
given to both. A JAX subset's rows are count-sorted chunks that unsort to
``ids`` order; the port's subset is in ``ids`` order. Tolerances: subset
replays within 1e-5 of JAX's and equal bit for bit to the port's full
replay restricted to the ids (and to the port's plain march on those
rays); gradients within ``1e-5 * max(1, max|g_jax|)``; `train_minibatches`
and `train_steps` features within JAX's own rtol 2e-4 / atol 2e-6
(`test_tape_subset.py:238-239`), `train_steps` losses within 1e-6. The
minibatch loss differs from JAX's on purpose (no zero-occupancy prefix
chunks in the port, ROADMAP.md §3): `test_minibatch_loss_is_full_l2`
pins it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import tape as jtape
from svox_t_tpu.ops import tape_subset as jsub
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import tape as ttape
from svox_t_tpu_torch.ops import tape_subset as tsub

from helpers import build_tree, make_rays

ATOL = 1e-5


def _shell_occupy(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _scene(seed=11):
    """(JAX tree, port tree, pool (numpy), rng state after the build) of a
    depth-5 SH9 shell; never edited."""
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, N=2, data_dim=28, depth_limit=5, n_random_refines=2,
                              data_format="SH9", occupy=_shell_occupy)
    return jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu"), np.array(feats), rng.get_state()


def _rng(seed=11):
    rng = np.random.RandomState()
    rng.set_state(_scene(seed)[3])
    return rng


@functools.lru_cache(maxsize=None)
def _recorded(n_rays, compact=True, chunk=64, indirect=False, seed=11):
    """(JAX tape, port tape, opt, JAX spec, port spec, rays, the rng after
    the rays) of ``n_rays`` seeded rays, recorded in both packages on the
    bake."""
    jt, pt, feats, _ = _scene(seed)
    rng = _rng(seed)
    rays = make_rays(rng, n_rays)
    opt = dataclasses.replace(st.VolumeRenderer(jt)._get_options(False), chunk_size=chunk,
                              **({"box_advance": 0} if indirect else {}))
    jspec, tspec = jt._baked_spec(), pt._baked_spec()
    M = feats.shape[0]
    jtp = jtape.record_tape(jspec, M, rays.origins, rays.dirs, rays.viewdirs, opt, compact=compact,
                            indirect=indirect)
    r = [_t(x) for x in rays]
    ttp = ttape.record_tape(tspec, M, *r, opt, compact=compact, indirect=indirect)
    return jtp, ttp, opt, jspec, tspec, rays, rng.get_state()


def _after(state):
    rng = np.random.RandomState()
    rng.set_state(state)
    return rng


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _full(ttp, feats, opt, tspec):
    return ttape.replay_render(ttp, _t(feats), opt, tspec)


def test_subset_matches_full_replay_uncompacted():
    """compact=False: the subset's replay is the full replay's rows, bit for
    bit, and within 1e-5 of JAX's subset replay."""
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(300, compact=False)
    feats = _scene()[2]
    ids = _after(rs).choice(300, size=96, replace=False)
    sub = tsub.subset_tape(ttp, ids, chunk_size=32)
    out = ttape.replay_render(sub, _t(feats), opt, tspec)
    assert torch.equal(out, _full(ttp, feats, opt, tspec)[ids])
    jout = np.asarray(jtape.replay_render(jsub.subset_tape(jtp, ids, chunk_size=32), jnp.asarray(feats),
                                          opt, jspec))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    assert sub.n_rays == 96 and not sub.compact
    np.testing.assert_array_equal(sub.counts.numpy(), ttp.counts.numpy()[ids])


def test_subset_matches_full_replay_compact():
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(300)
    feats = _scene()[2]
    ids = _after(rs).choice(300, size=128, replace=False)
    out = tsub.replay_render_rows(ttp, ids, _t(feats), opt, tspec, chunk_size=32)
    assert torch.equal(out, _full(ttp, feats, opt, tspec)[ids])
    jout = np.asarray(jsub.replay_render_rows(jtp, ids, jnp.asarray(feats), opt, jspec, chunk_size=32))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)


def test_subset_matches_march():
    """The subset replay against a fresh march of exactly those rays: the
    port's plain march bit for bit, the JAX march within 1e-5."""
    jtp, ttp, opt, jspec, tspec, rays, rs = _recorded(257)
    feats = _scene()[2]
    ids = _after(rs).choice(257, size=64, replace=False)
    o, d, v = (_t(x)[ids] for x in rays)
    ref = trender.volume_render(tspec, _t(feats), o, d, v, opt)
    out = tsub.replay_render_rows(ttp, ids, _t(feats), opt, tspec, chunk_size=32)
    assert torch.equal(out, ref)
    from svox_t_tpu.ops.render import volume_render
    jref = np.asarray(volume_render(jspec, jnp.asarray(feats), rays.origins[ids], rays.dirs[ids],
                                    rays.viewdirs[ids], opt))
    np.testing.assert_allclose(out.numpy(), jref, atol=ATOL, rtol=0)


def test_subset_duplicates_and_tiny():
    jtp, ttp, opt, jspec, tspec, _, _ = _recorded(120)
    feats = _scene()[2]
    full = _full(ttp, feats, opt, tspec)
    ids = np.array([5, 5, 77, 3, 119, 5])
    out = tsub.replay_render_rows(ttp, ids, _t(feats), opt, tspec, chunk_size=32)
    assert torch.equal(out, full[ids])
    jout = np.asarray(jsub.replay_render_rows(jtp, ids, jnp.asarray(feats), opt, jspec, chunk_size=32))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    # One ray: no batch shape to change in the port, so still bit for bit.
    out1 = tsub.replay_render_rows(ttp, np.array([42]), _t(feats), opt, tspec)
    assert torch.equal(out1, full[[42]])


def test_subset_grad_matches_masked_full():
    """d/dfeatures of sum(subset out) == that of the full replay with the
    loss masked to the subset rows, and JAX's subset gradient."""
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(200)
    feats = _scene()[2]
    ids = _after(rs).choice(200, size=80, replace=False)
    mask = torch.zeros(200)
    mask[ids] = 1.0
    f = _t(feats).requires_grad_()
    g_full, = torch.autograd.grad((ttape.replay_render(ttp, f, opt, tspec) * mask[:, None]).sum(), f)
    g_sub, = torch.autograd.grad(tsub.replay_render_rows(ttp, ids, f, opt, tspec, chunk_size=32).sum(), f)
    torch.testing.assert_close(g_sub, g_full, atol=_gtol(g_full), rtol=0)
    g_jax = np.asarray(jax.grad(lambda ff: jnp.sum(jsub.replay_render_rows(
        jtp, ids, ff, opt, jspec, chunk_size=32)))(jnp.asarray(feats)))
    np.testing.assert_allclose(g_sub.numpy(), g_jax, atol=_gtol(g_jax), rtol=0)


def test_subset_grad_matches_march_grad():
    jtp, ttp, opt, jspec, tspec, rays, rs = _recorded(200)
    feats = _scene()[2]
    ids = _after(rs).choice(200, size=64, replace=False)
    o, d, v = (_t(x)[ids] for x in rays)
    f = _t(feats).requires_grad_()
    g_ref, = torch.autograd.grad(trender.volume_render(tspec, f, o, d, v, opt).sum(), f)
    g_sub, = torch.autograd.grad(tsub.replay_render_rows(ttp, ids, f, opt, tspec, chunk_size=32).sum(), f)
    torch.testing.assert_close(g_sub, g_ref, atol=_gtol(g_ref), rtol=0)
    from svox_t_tpu.ops.render import volume_render
    g_jax = np.asarray(jax.grad(lambda ff: jnp.sum(volume_render(
        jspec, ff, rays.origins[ids], rays.dirs[ids], rays.viewdirs[ids], opt)))(jnp.asarray(feats)))
    np.testing.assert_allclose(g_sub.numpy(), g_jax, atol=_gtol(g_jax), rtol=0)


def test_subset_source_reuse():
    """One TapeRowSource serves many subsets, each equal to the full
    replay's rows; a layout argument changes nothing."""
    _, ttp, opt, _, tspec, _, rs = _recorded(150)
    feats = _scene()[2]
    src = tsub.TapeRowSource(ttp)
    full = _full(ttp, feats, opt, tspec)
    rng = _after(rs)
    for chunk in (32, 7, 512):
        ids = rng.choice(150, size=50, replace=False)
        out = tsub.replay_render_rows(src, ids, _t(feats), opt, tspec, chunk_size=chunk)
        assert torch.equal(out, full[ids])
    assert src.tape is ttp and src.counts_host.dtype == np.int32
    np.testing.assert_array_equal(src.counts_host, ttp.counts.numpy())


def test_subset_indirect_parent():
    """A data-indirect parent: the subset carries the cell stream and
    resolves through the same index table (and keeps it as its cell
    stream with keep_cells)."""
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(150, indirect=True)
    jt, pt, feats, _ = _scene()
    table = ttape.pack_index_table(pt._spec().data_flat)
    full = ttape.replay_render(ttp, _t(feats), opt, tspec, index_table=table)
    ids = _after(rs).choice(150, size=60, replace=False)
    out = tsub.replay_render_rows(ttp, ids, _t(feats), opt, tspec, index_table=table, chunk_size=32)
    assert torch.equal(out, full[ids])
    jtable = jtape.pack_index_table(jt._spec().data_flat)
    jout = np.asarray(jsub.replay_render_rows(jtp, ids, jnp.asarray(feats), opt, jspec,
                                              index_table=jtable, chunk_size=32))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    sub = tsub.subset_tape(tsub.TapeRowSource(ttp, keep_cells=True), ids)
    assert sub.indirect and sub.cell is sub.idx


def _minibatch_case():
    """(JAX tape, port tape, opt, specs, targets (numpy), f0, ids (N, B),
    lr) of `test_train_minibatches_matches_eager_chain`'s setup."""
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(240)
    feats = _scene()[2]
    tgt = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec))[:, :-1]
    f0 = feats * 0.8 + 0.05
    rng = _after(rs)
    ids_b = np.stack([rng.choice(240, size=48, replace=False) for _ in range(4)])
    return jtp, ttp, opt, jspec, tspec, tgt, f0, ids_b, 0.5


@functools.lru_cache(maxsize=None)
def _minibatch_runs():
    """The port's and JAX's train_minibatches on `_minibatch_case`."""
    jtp, ttp, opt, jspec, tspec, tgt, f0, ids_b, lr = _minibatch_case()
    src = tsub.TapeRowSource(ttp)
    got = tsub.train_minibatches(src, ids_b, tgt, _t(f0), opt, lr=lr, spec=tspec, chunk_size=32)
    want = jsub.train_minibatches(jsub.TapeRowSource(jtp), ids_b, tgt, jnp.asarray(f0), opt, lr=lr,
                                  spec=jspec, chunk_size=32)
    return src, got, tuple(np.asarray(x) for x in want[:2])


def test_train_minibatches_matches_eager_chain():
    """The sequential trainer follows JAX's feature trajectory (JAX's own
    tolerance) and the port's eager chain of public calls (subset replay,
    autograd of the full per-batch loss, f - lr * g)."""
    jtp, ttp, opt, jspec, tspec, tgt, f0, ids_b, lr = _minibatch_case()
    src, (f_out, losses, state), (jf, jl) = _minibatch_runs()
    assert state == () and losses.shape == (4,) and bool(torch.isfinite(losses).all())
    np.testing.assert_allclose(f_out.numpy(), jf, rtol=2e-4, atol=2e-6)
    n_color = tgt.shape[1]
    f = _t(f0)
    for ids in ids_b:
        ff = f.clone().requires_grad_()
        out = tsub.replay_render_rows(src, ids, ff, opt, tspec, chunk_size=32)
        err = out[:, :n_color] - _t(tgt)[ids]
        g, = torch.autograd.grad((err * err).sum() / (len(ids) * n_color), ff)
        f = f - lr * g
    torch.testing.assert_close(f_out, f, atol=1e-5 * max(1.0, float(f.abs().max())), rtol=0)
    assert not torch.equal(f_out, _t(f0))


def test_minibatch_loss_is_full_l2():
    """Differs from JAX on purpose (ROADMAP.md §3): the port's per-step loss
    is the masked L2 over all B rays / (B * W). JAX's leaves out the rays of
    its zero-occupancy prefix chunks, which carry no gradient, so its value
    lies in the bound its own test states, [full - zero-ray terms, full],
    and the feature trajectories agree. Targets off the background by 0.05
    and batches half of zero-occupancy rays make the terms JAX leaves out
    non-zero."""
    jtp, ttp, opt, jspec, tspec, tgt, f0, _, lr = _minibatch_case()
    src = tsub.TapeRowSource(ttp)
    occ = src.counts_host > 0
    rng = np.random.RandomState(21)
    ids_b = np.stack([np.concatenate([rng.choice(np.flatnonzero(~occ), 24),
                                      rng.choice(np.flatnonzero(occ), 24)]) for _ in range(2)])
    tgt = tgt + 0.05
    f_out, losses, _ = tsub.train_minibatches(src, ids_b, tgt, _t(f0), opt, lr=lr, spec=tspec,
                                              chunk_size=16)
    jf, jl, _ = jsub.train_minibatches(jsub.TapeRowSource(jtp), ids_b, tgt, jnp.asarray(f0), opt,
                                       lr=lr, spec=jspec, chunk_size=16)
    jl = np.asarray(jl)
    np.testing.assert_allclose(f_out.numpy(), np.asarray(jf), rtol=2e-4, atol=2e-6)
    n_color, B = tgt.shape[1], ids_b.shape[1]
    out0 = tsub.replay_render_rows(src, ids_b[0], _t(f0), opt, tspec).numpy()
    err0 = out0[:, :n_color] - tgt[ids_b[0]]
    full0 = float((err0 * err0).sum() / (B * n_color))
    zero0 = float((err0[~occ[ids_b[0]]] ** 2).sum() / (B * n_color))
    assert abs(float(losses[0]) - full0) <= 1e-6 * max(1.0, full0)
    assert full0 - zero0 - 1e-6 <= float(jl[0]) <= full0 + 1e-6
    assert bool((jl <= losses.numpy() - 5e-4).all())


def test_train_minibatches_custom_update():
    """Momentum state threads through the steps, as in JAX."""
    jtp, ttp, opt, jspec, tspec, _, rs = _recorded(120)
    feats = _scene()[2]
    tgt = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec))[:, :3]
    f0 = feats * 0.9
    rng = _after(rs)
    ids_b = np.stack([rng.choice(120, size=32) for _ in range(3)])

    def momentum(f, g, state):
        v = 0.9 * state - 0.5 * g
        return f + v, v

    f_out, losses, v_out = tsub.train_minibatches(
        tsub.TapeRowSource(ttp), ids_b, tgt, _t(f0), opt, update_fn=momentum,
        update_state=torch.zeros(f0.shape), spec=tspec, chunk_size=32)
    jf, _, jv = jsub.train_minibatches(
        jsub.TapeRowSource(jtp), ids_b, tgt, jnp.asarray(f0), opt, update_fn=momentum,
        update_state=jnp.zeros_like(jnp.asarray(f0)), spec=jspec, chunk_size=32)
    assert bool(torch.isfinite(losses).all()) and bool(torch.isfinite(f_out).all())
    np.testing.assert_allclose(f_out.numpy(), np.asarray(jf), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(v_out.numpy(), np.asarray(jv), rtol=2e-4, atol=2e-6)


def test_subset_bad_ids_raise():
    jtp, ttp, opt, _, _, _, _ = _recorded(64)
    for bad in (np.array([64]), np.array([-1]), np.array([], np.int64)):
        with pytest.raises(ValueError) as got:
            tsub.subset_tape(ttp, bad)
        with pytest.raises(ValueError) as want:
            jsub.subset_tape(jtp, bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must be in"):
        tsub.prep_minibatches(tsub.TapeRowSource(ttp), np.array([[0, 64]]))


def test_train_steps_matches_eager_chain():
    """The full-tape SGD chain against JAX's train_steps (features at JAX's
    tolerance, losses within 1e-6) and the port's eager chain."""
    jtp, ttp, opt, jspec, tspec, _, _ = _recorded(200)
    feats = _scene()[2]
    tgt = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec))[:, :-1]
    f0 = feats * 0.85
    N, lr = 4, 0.4
    f_out, losses, _ = tsub.train_steps(ttp, tgt, _t(f0), opt, N, lr=lr, spec=tspec)
    jf, jl, _ = jsub.train_steps(jtp, tgt, jnp.asarray(f0), opt, N, lr=lr, spec=jspec)
    np.testing.assert_allclose(f_out.numpy(), np.asarray(jf), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    assert losses[-1] < losses[0]
    f, n_color = _t(f0), tgt.shape[1]
    for n in range(N):
        ff = f.clone().requires_grad_()
        err = ttape.replay_render(ttp, ff, opt, tspec)[:, :n_color] - _t(tgt)
        loss = (err * err).sum() / (200 * n_color)
        g, = torch.autograd.grad(loss, ff)
        assert abs(float(loss.detach()) - float(losses[n])) <= 1e-6
        f = f - lr * g
    torch.testing.assert_close(f_out, f, atol=1e-5 * max(1.0, float(f.abs().max())), rtol=0)


def test_subset_weight_accum():
    """Weight accumulation through a subset (keep_cells=True) equals the
    march's over the identical rays and JAX's subset's."""
    jtp, ttp, opt, jspec, tspec, rays, rs = _recorded(150)
    feats = _scene()[2]
    ids = _after(rs).choice(150, size=48, replace=False)
    sub = tsub.subset_tape(tsub.TapeRowSource(ttp, keep_cells=True), ids, chunk_size=32)
    _, wa = ttape.replay_render_weighted(sub, _t(feats), opt, tspec)
    o, d, v = (_t(x)[ids] for x in rays)
    _, wa_ref = trender.volume_render_with_weight_accum(tspec, _t(feats), o, d, v, opt)
    torch.testing.assert_close(wa, wa_ref, atol=_gtol(wa_ref), rtol=0)
    jsrc = jsub.TapeRowSource(jtp, keep_cells=True)
    _, jwa = jtape.replay_render_weighted(jsub.subset_tape(jsrc, ids, chunk_size=32), jnp.asarray(feats),
                                          opt, jspec)
    np.testing.assert_allclose(wa.numpy(), np.asarray(jwa), atol=_gtol(jwa), rtol=0)
    assert float(wa.sum()) > 0
    assert tsub.subset_tape(tsub.TapeRowSource(ttp), ids).cell is None


def test_prep_minibatches_pack_equals_direct():
    """A prep_minibatches pack gives the same chain as raw ids, whatever
    layout arguments either carries; a pack of another tape raises, even
    one recorded from the same rays."""
    jtp, ttp, opt, _, tspec, _, rs = _recorded(160)
    feats = _scene()[2]
    src = tsub.TapeRowSource(ttp)
    tgt = _full(ttp, feats, opt, tspec)[:, :3]
    rng = _after(rs)
    ids_b = np.stack([rng.choice(160, size=32) for _ in range(3)])
    f0 = _t(feats * 0.9)
    f_a, l_a, _ = tsub.train_minibatches(src, ids_b, tgt, f0, opt, lr=0.2, spec=tspec, chunk_size=32)
    pack = tsub.prep_minibatches(src, ids_b, chunk_size=32)
    f_b, l_b, _ = tsub.train_minibatches(src, pack, tgt, f0, opt, lr=0.2, spec=tspec, chunk_size=7,
                                         r_quant=3)
    assert torch.equal(f_a, f_b) and torch.equal(l_a, l_b)
    assert torch.equal(f0, _t(feats * 0.9))  # the caller's pool is not written
    np.testing.assert_array_equal(pack.ids, ids_b.astype(np.int32))
    assert pack.offsets.shape == (3, 33) and pack.n_rays == 160 and pack.tape() is ttp
    # Another source of the same tape, or the tape itself, takes the pack.
    for same in (tsub.TapeRowSource(ttp), ttp):
        f_c, l_c, _ = tsub.train_minibatches(same, pack, tgt, f0, opt, lr=0.2, spec=tspec)
        assert torch.equal(f_c, f_a) and torch.equal(l_c, l_a)
    # A tape recorded again from the same rays has the same shape, counts
    # and meta (JAX's check would take it) and is refused, as is one of
    # another ray count.
    again = ttape.record_tape(tspec, feats.shape[0], ttp.origins, ttp.dirs, ttp.vdirs, opt)
    assert torch.equal(again.counts, ttp.counts)
    for other in (again, _recorded(150)[1]):
        with pytest.raises(ValueError, match="different source"):
            tsub.train_minibatches(tsub.TapeRowSource(other), pack, tgt, f0, opt, lr=0.2, spec=tspec)


def test_training_refusals():
    """An int8 pool takes no gradient (TypeError, as `replay_backward`);
    thresholded options are refused with JAX's message."""
    jtp, ttp, opt, _, tspec, _, _ = _recorded(120)
    feats = _scene()[2]
    tgt = np.zeros((120, 3), np.float32)
    q = stt.quantize_features(_t(feats))
    ids = np.zeros((1, 8), np.int64)
    with pytest.raises(TypeError, match="quantized"):
        tsub.train_minibatches(ttp, ids, tgt, q, opt, spec=tspec)
    with pytest.raises(TypeError, match="quantized"):
        tsub.train_steps(ttp, tgt, q, opt, 1, spec=tspec)
    fast = dataclasses.replace(opt, sigma_thresh=1e-2)
    with pytest.raises(ValueError) as got:
        tsub.train_minibatches(ttp, ids, tgt, _t(feats), fast, spec=tspec)
    with pytest.raises(ValueError) as want:
        jsub.train_minibatches(jtp, ids, tgt, jnp.asarray(feats), fast)
    assert str(got.value) == str(want.value)


def test_sgd_plain_rounds_as_jax():
    """K14c's plain version equals JAX's float32 `features - lr * grad` bit
    for bit, in place."""
    rng = np.random.RandomState(5)
    f = rng.randn(4096).astype(np.float32)
    g = (rng.randn(4096) * 0.37).astype(np.float32)
    for lr in (0.05, 0.4, 1e-2):
        want = np.asarray(jnp.asarray(f) - lr * jnp.asarray(g))
        pool = _t(f)
        got = tsub.sgd_plain(pool, _t(g), lr)
        assert got is pool
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_minibatches_refuses_short_targets():
    """Targets with fewer rows than the source's rays are refused before any
    step (a batch's ids index them); more rows are taken."""
    _, ttp, opt, _, tspec, _, _ = _recorded(120)
    feats = _scene()[2]
    hit = np.flatnonzero(ttp.counts.numpy())
    ids = hit[None, [0, -1, 3, 3]]
    with pytest.raises(ValueError, match="targets hold 119 rows for 120 rays"):
        tsub.train_minibatches(ttp, ids, np.zeros((119, 3), np.float32), _t(feats), opt, spec=tspec)
    tgt = _full(ttp, feats, opt, tspec)[:, :3]
    f_a, l_a, _ = tsub.train_minibatches(ttp, ids, tgt, _t(feats * 0.9), opt, lr=0.2, spec=tspec)
    longer = torch.cat([tgt, torch.ones(7, 3)])
    f_b, l_b, _ = tsub.train_minibatches(ttp, ids, longer, _t(feats * 0.9), opt, lr=0.2, spec=tspec)
    assert torch.equal(f_a, f_b) and torch.equal(l_a, l_b) and float(l_a[0]) > 0


def test_bf16_pool_refused_by_default_update():
    """JAX's trainers refuse a bf16 pool under the default SGD (the tape
    gradient is float32, so the update changes the scan carry's type); the
    port refuses it too. An update_fn that keeps the type trains it in both,
    the gradient float32 in both."""
    jtp, ttp, opt, jspec, tspec, _, _ = _recorded(120)
    feats = _scene()[2]
    tgt = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec))[:, :-1]
    f0 = (feats * 0.9).astype(np.float32)
    ids = np.zeros((2, 8), np.int64)
    with pytest.raises(TypeError, match="float32 pool"):
        tsub.train_steps(ttp, tgt, _t(f0).to(torch.bfloat16), opt, 2, lr=0.3, spec=tspec)
    with pytest.raises(TypeError, match="float32 pool"):
        tsub.train_minibatches(ttp, ids, tgt, _t(f0).to(torch.bfloat16), opt, spec=tspec)
    with pytest.raises(TypeError):
        jsub.train_steps(jtp, tgt, jnp.asarray(f0).astype(jnp.bfloat16), opt, 2, lr=0.3, spec=jspec)
    with pytest.raises(TypeError):
        jsub.train_minibatches(jsub.TapeRowSource(jtp), ids, tgt, jnp.asarray(f0).astype(jnp.bfloat16),
                               opt, spec=jspec)

    def keep_type(f, g, state):
        assert g.dtype in (torch.float32, jnp.float32)
        return (f - 0.3 * g).astype(jnp.bfloat16) if isinstance(f, jax.Array) else \
            (f - 0.3 * g).to(torch.bfloat16), state

    f_out, losses, _ = tsub.train_steps(ttp, tgt, _t(f0).to(torch.bfloat16), opt, 2, spec=tspec,
                                        update_fn=keep_type)
    jf, jl, _ = jsub.train_steps(jtp, tgt, jnp.asarray(f0).astype(jnp.bfloat16), opt, 2, spec=jspec,
                                 update_fn=keep_type)
    assert f_out.dtype == torch.bfloat16
    jf = np.asarray(jf.astype(jnp.float32))
    # One bf16 ulp where a gradient summed in another order rounds the
    # other way.
    np.testing.assert_array_less(np.abs(f_out.float().numpy() - jf), np.abs(jf) * 2.0 ** -7 + 2e-6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="update_fn returned"):
        tsub.train_steps(ttp, tgt, _t(f0), opt, 1, spec=tspec, update_fn=lambda f, g, s: (f.double(), s))


def test_subset_streams():
    """The subset's streams: each chosen run copied, in ids order, with t
    (a record_t parent), vdirs, dscale and counts; origins and dirs only
    with_rays (zeros without)."""
    jt, pt, feats, _ = _scene()
    rays = make_rays(np.random.RandomState(3), 90)
    r = [_t(x) for x in rays]
    tp = ttape.record_tape(pt._baked_spec(), feats.shape[0], *r,
                           st.VolumeRenderer(jt)._get_options(False), record_t=True)
    ids = np.array([4, 80, 4, 0, 33])
    sub = tsub.subset_tape(tp, ids)
    off = tp.offsets.numpy()
    runs = lambda s: np.concatenate([s.numpy()[off[i]:off[i + 1]] for i in ids])  # noqa: E731
    for name in ("idx", "dt", "tval"):
        np.testing.assert_array_equal(getattr(sub, name).numpy(), runs(getattr(tp, name)))
    for name in ("vdirs", "dscale", "counts", "origins", "dirs"):
        np.testing.assert_array_equal(getattr(sub, name).numpy(), getattr(tp, name).numpy()[ids])
    np.testing.assert_array_equal(sub.offsets.numpy()[1:], np.cumsum(tp.counts.numpy()[ids]))
    assert sub.S == int(tp.counts.numpy()[ids].max()) and sub.geom == tp.geom
    bare = tsub.subset_tape(tp, ids, with_rays=False)
    assert not bare.origins.any() and not bare.dirs.any()


def test_train_steps_thresholded_matches_eager_chain():
    """Thresholded options: `train_steps` takes `replay_backward`'s march
    fallback over the tape's rays, as JAX's tape VJP does, and follows the
    port's eager chain of the same calls."""
    jt, pt, feats, _ = _scene()
    rays = make_rays(np.random.RandomState(12), 96)
    opt = st.VolumeRenderer(jt)._get_options(True)
    tspec = pt._baked_spec()
    tp = ttape.record_tape(tspec, feats.shape[0], *[_t(x) for x in rays], opt)
    tgt = ttape.replay_render(tp, _t(feats), opt, tspec)[:, :3].detach() + 0.01
    f_out, losses, _ = tsub.train_steps(tp, tgt, _t(feats * 0.9), opt, 2, lr=0.3, spec=tspec)
    f = _t(feats * 0.9)
    for n in range(2):
        ff = f.clone().requires_grad_()
        err = ttape.replay_render(tp, ff, opt, tspec)[:, :3] - tgt
        g, = torch.autograd.grad((err * err).sum() / (96 * 3), ff)
        f = f - 0.3 * g
    torch.testing.assert_close(f_out, f, atol=1e-5 * max(1.0, float(f.abs().max())), rtol=0)
    assert bool((f_out != _t(feats * 0.9)).any()) and losses[1] < losses[0]
