"""svox_t_tpu_torch's baked render backend against the JAX package (CPU).

`ops/bake.py` (the host bake, the K6 lookup, K7 refresh and skip-box
regrowth), `points_leaf_aabb`, and `VolumeRenderer` on its default
backend against the JAX package's default (``st.VolumeRenderer(tree)``,
the bake too): forward, `render_persp`, gradients, weights, the four aux
passes and the dynamic frame loop, in exact and fast mode.

Tables and point ops compare exactly. The port's tables are unpadded (the
JAX package pads each to a row width for the TPU), so cell ids differ and
compare through ``src_map``. Renders compare at atol 1e-5 (the JAX march
forms L per round, the port per sample) and gradients at
``1e-5 * max(1, max|g_jax|)``.

Fast mode starts a ray on the occupied box's face (``box_advance``),
where the last ulp of the sample position picks the cell. The port rounds
the position once, as XLA's fused multiply-add does in the JAX march, but
the JAX package's jitted ray setup rounds ``1/|d|`` through rsqrt, so for
some rays the two packages start one ulp apart. The fast-mode comparisons
take the rays whose ray setup (tree-space direction, its inverse, the
step scale) agrees bit for bit between the packages; all others would
compare ulps, not the march.
"""

import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import bake as jbake
from svox_t_tpu.ops import query as jquery
from svox_t_tpu.ops import render as jrender
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import bake as tbake
from svox_t_tpu_torch.ops import query as tquery
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.utils.scenes import orbit_camera

from helpers import build_tree, make_rays

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dynamic import Scene  # noqa: E402  (the boundary-safe dynamic scene)

ATOL = 1e-5


def _has_boxes(top):
    """Whether a top table packs any skip box (a row in the code space)."""
    code = (top & tbake.ROW_MASK) - tbake.SKIP_BASE
    return bool(((top >= 0) & (code >= 0) & (code < tbake._SKIP_BITS_SPAN)).any())


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _half_empty(seed=0, fmt="RGBA", ddim=4, N=2, depth=5, refines=3):
    """A random tree whose leaves with x < 0.45 hold rows (the rest is
    empty space, so the bake grows skip boxes), and its port copy."""
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, N=N, data_format=fmt, data_dim=ddim, depth_limit=depth,
                              n_random_refines=refines, sigma_scale=20.0,
                              occupy=lambda c: c[:, 0] < 0.45)
    rays = make_rays(rng, 512)
    return jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu"), np.asarray(feats), rays


def _same_setup(jt, rays):
    """Mask of the rays whose ray setup agrees bit for bit between the
    JAX package's jitted march and the port."""
    spec = jt._spec()
    jo = jax.jit(lambda o, d: jrender._ray_setup(spec, o, d))(rays.origins, rays.dirs)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    to = trender._ray_setup(pt._spec(), _t(rays.origins), _t(rays.dirs))
    same = np.ones(len(np.asarray(rays.origins)), bool)
    for a, b in zip(jo[:4], to[:4]):
        a, b = np.asarray(a), b.numpy()
        same &= (a == b).reshape(len(same), -1).all(axis=1)
    return same


def _subset(rays, mask):
    return st.Rays(*(jnp.asarray(np.asarray(r)[mask]) for r in rays))


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _compare(got, want, stop_thresh=0.0):
    """atol 1e-5; with early stop, rays whose alpha lies within 1e-6 of
    1 - stop_thresh are left out (the per-round and per-sample L can put
    the stop sample one apart there), as tests/test_torch_render.py does."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(len(got), bool)
    if stop_thresh > 0:
        near = lambda a: np.abs(a[:, -1] - (1.0 - stop_thresh)) < 1e-6  # noqa: E731
        keep = ~(near(got) | near(want))
        assert keep.mean() > 0.9
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL)


# ---------------------------------------------------------------------------
# The bake and the point ops


def _empty_tree():
    t = st.N3Tree(N=2, data_dim=4, depth_limit=4)
    t.refine(repeats=2)
    return t


def _full_tree():
    rng = np.random.RandomState(5)
    return build_tree(rng, depth_limit=4, n_random_refines=2)[0]


BAKES = {
    "half-empty": (lambda: _half_empty()[0], {}),
    "n3": (lambda: build_tree(np.random.RandomState(1), N=3, depth_limit=4)[0], {}),
    "three-stage": (lambda: _half_empty()[0], dict(top_levels=2, mid_levels=1)),
    "full": (_full_tree, {}),
    "empty": (_empty_tree, {}),
}


def _segments(jb):
    """The JAX bake's per-table segments of src_map / depth_parts, padded."""
    sizes = [jb.top.size] + ([jb.mid.size] if jb.mid is not None else []) + [jb.brick.size]
    return np.cumsum([0] + sizes)


@pytest.mark.parametrize("name", list(BAKES))
def test_bake_tables_match_jax(name):
    make, kw = BAKES[name]
    jt = make()
    jb = jbake.bake(jt._spec(), **kw)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    tb = tbake.bake(pt._spec(), **kw)
    for f in ("N", "top_levels", "mid_levels", "brick_levels", "n_tree_cells", "skip_base"):
        assert getattr(jb, f) == getattr(tb, f), f
    np.testing.assert_array_equal(np.asarray(jb.aabb_lo), tb.aabb_lo.numpy())
    np.testing.assert_array_equal(np.asarray(jb.aabb_hi), tb.aabb_hi.numpy())
    seg = _segments(jb)
    tables = [("top", tb.top)] + ([("mid", tb.mid)] if tb.mid is not None else []) + [("brick", tb.brick)]
    start = 0
    for i, (table, tt) in enumerate(tables):
        n = tt.numel()
        j = np.asarray(getattr(jb, table)).reshape(-1)
        np.testing.assert_array_equal(j[:n], tt.numpy(), err_msg=table)
        assert (j[n:] == jbake.EMPTY_ROW).all()  # the rest is row padding
        for aux in ("src_map", "depth_parts"):
            ja = np.asarray(getattr(jb, aux))[seg[i]:seg[i] + n]
            np.testing.assert_array_equal(ja, getattr(tb, aux).numpy()[start:start + n],
                                          err_msg=f"{table} {aux}")
        start += n
    assert start == tb.src_map.numel() == tb.depth_parts.numel()
    if name == "half-empty":
        assert tb.skip_base and _has_boxes(tb.top)
    if name == "empty":
        assert bool((tb.aabb_lo > tb.aabb_hi).all())


def _points(rng, N, n=3000):
    """Random points, points on cell boundaries (level 3) and points
    outside the cube."""
    R = N ** 3
    return np.concatenate([
        rng.rand(n, 3), rng.randint(0, R + 1, (n, 3)) / R, rng.rand(64, 3) * 1.4 - 0.2,
    ]).astype(np.float32)


@pytest.mark.parametrize("name", ["half-empty", "n3", "three-stage"])
def test_lookup_matches_jax(name):
    make, kw = BAKES[name]
    jt = make()
    jb = jbake.bake(jt._spec(), **kw)
    tb = tbake.bake(stt.tree_from_numpy(stt.tree_state(jt), device="cpu")._spec(), **kw)
    pts = _points(np.random.RandomState(2), jt.N)
    want = jbake.lookup(jb, jnp.asarray(pts))
    got = tbake.lookup(tb, _t(pts))
    for i, what in enumerate(("row", "cube", "frac")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=what)
    np.testing.assert_array_equal(tb.src_map.numpy()[got[3].numpy()],
                                  np.asarray(jb.src_map)[np.asarray(want[3])])


def test_refresh_grow_and_points_aabb_match_jax():
    """A re-point at a shuffled half of the leaf centres with x < 0.3: points_leaf_aabb,
    refresh with the union box and the skip-box regrowth, exactly."""
    jt, pt, _, _ = _half_empty(seed=3)
    centres = np.asarray(jax.device_get(jt.tree2world(jnp.asarray(
        jt[:].corners_local + 0.5 * jt[:].lengths_local[:, None]))))
    left = centres[centres[:, 0] < 0.3]  # leaves most of the cube empty
    pts = left[np.random.RandomState(3).permutation(len(left))[: len(left) // 2]]
    jspec, tspec = jt._spec(), pt._spec()
    jlo, jhi = jquery.points_leaf_aabb(jspec, jnp.asarray(pts))
    tlo, thi = tquery.points_leaf_aabb(tspec, _t(pts))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    for world in (False,):
        tp = tspec.offset + tspec.scaling * _t(pts)
        lo2, hi2 = tquery.points_leaf_aabb(tspec, tp, world)
        jlo2, jhi2 = jquery.points_leaf_aabb(jspec, jnp.asarray(tp.numpy()), world)
        np.testing.assert_array_equal(lo2.numpy(), np.asarray(jlo2))
        np.testing.assert_array_equal(hi2.numpy(), np.asarray(jhi2))
    new_j = jquery.construct_tree(jspec, jnp.asarray(pts))
    new_t = tquery.construct_tree(tspec, _t(pts))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    jb, tb = jt._baked_spec(), pt._baked_spec()
    jr = jbake.refresh(jb, new_j, aabb_lo=jnp.minimum(jlo, jb.aabb_lo),
                       aabb_hi=jnp.maximum(jhi, jb.aabb_hi))
    tr = tbake.refresh(tb, new_t, torch.minimum(tlo, tb.aabb_lo), torch.maximum(thi, tb.aabb_hi))
    R3 = tb.R ** 3
    np.testing.assert_array_equal(tr.top.numpy(), np.asarray(jr.top).reshape(-1)[:R3])
    np.testing.assert_array_equal(tr.aabb_lo.numpy(), np.asarray(jr.aabb_lo))
    np.testing.assert_array_equal(tr.aabb_hi.numpy(), np.asarray(jr.aabb_hi))
    # refresh degrades every skip box; the regrowth brings them back
    assert not _has_boxes(tr.top)
    jg, tg = jbake.grow_boxes_device(jr), tbake.grow_boxes_device(tr)
    np.testing.assert_array_equal(tg.top.numpy(), np.asarray(jg.top).reshape(-1)[:R3])
    assert _has_boxes(tg.top)
    # without a box, refresh covers the cube
    full = tbake.refresh(tb, new_t)
    assert full.aabb_lo.tolist() == [0.0] * 3 and full.aabb_hi.tolist() == [1.0] * 3
    with pytest.raises(ValueError, match="both"):
        tbake.refresh(tb, new_t, tlo)


def test_construct_tree_keeps_the_bake_current():
    """construct_tree on a tree with a bake: the union box, the refreshed
    rows and the regrown boxes are the JAX tree's."""
    jt, pt, _, _ = _half_empty(seed=4)
    jt._baked_spec(), pt._baked_spec()
    pts = np.random.RandomState(4).rand(300, 3).astype(np.float32) * 0.9 + 0.05
    jt.construct_tree(pts)
    pt.construct_tree(pts)
    jb, tb = jt._baked_spec(), pt._baked_spec()
    np.testing.assert_array_equal(tb.top.numpy(), np.asarray(jb.top).reshape(-1)[: tb.R ** 3])
    np.testing.assert_array_equal(tb.aabb_lo.numpy(), np.asarray(jb.aabb_lo))
    np.testing.assert_array_equal(tb.aabb_hi.numpy(), np.asarray(jb.aabb_hi))
    pt.refine(repeats=1)
    assert pt._cached_baked is None


# ---------------------------------------------------------------------------
# Renders on the default backend


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
@pytest.mark.parametrize("fast", [False, True])
def test_default_renderer_matches_jax_default(fmt, ddim, fast):
    """The port's default renderer is the JAX package's default (the
    bake), in exact and fast mode. The tree walk's fast mode has no box
    advance and no skip boxes, so it is another fast mode: on this scene
    27-28 of its rays are off by more than 1e-5 (up to 9.3e-3)."""
    jt, pt, feats, rays = _half_empty(seed=6, fmt=fmt, ddim=ddim)
    if fast:
        rays = _subset(rays, _same_setup(jt, rays))
        assert len(np.asarray(rays.origins)) > 300
    want = st.VolumeRenderer(jt)(jnp.asarray(feats), rays, fast=fast)
    r = stt.VolumeRenderer(pt)
    assert r.backend == "baked"
    got = r(_t(feats), _trays(rays), fast=fast)
    _compare(got, want, 1e-2 if fast else 0.0)
    tree = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays), fast=fast).numpy()
    if fast:  # the tree walk is another fast mode
        assert np.abs(tree - np.asarray(want)).max() > 1e-3
    else:  # and the same exact mode, bit for bit
        np.testing.assert_array_equal(tree, got.numpy())


def test_render_persp_matches_jax_default():
    """render_persp on the default backend, exact mode, at the camera
    tolerance of tests/test_torch_render.py (each package makes its own
    rays)."""
    jt, pt, feats, _ = _half_empty(seed=7, fmt="SH4", ddim=13)
    c2w = orbit_camera(0.3, 0.4, 2.0)
    want = np.asarray(st.VolumeRenderer(jt).render_persp(jnp.asarray(feats), c2w, 20, 16, fx=24.0))
    got = stt.VolumeRenderer(pt).render_persp(_t(feats), c2w, 20, 16, fx=24.0).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert want[..., -1].max() > 0.5


def test_box_advance_and_skip_box_overrides():
    """The renderer's box_advance / skip_boxes attributes override fast
    mode's, as in the JAX package."""
    jt, pt, feats, rays = _half_empty(seed=8)
    rays = _subset(rays, _same_setup(jt, rays))
    jr, tr = st.VolumeRenderer(jt), stt.VolumeRenderer(pt)
    base = tr(_t(feats), _trays(rays), fast=True).numpy()
    for attr in ("box_advance", "skip_boxes"):
        setattr(jr, attr, 0)
        setattr(tr, attr, 0)
        assert getattr(tr._get_options(True), attr) == 0
        got = tr(_t(feats), _trays(rays), fast=True).numpy()
        _compare(got, jr(jnp.asarray(feats), rays, fast=True), 1e-2)
    assert np.abs(got - base).max() > 1e-4  # the overrides change the march


@pytest.mark.parametrize("fast", [False, True])
def test_gradients_and_weights_match_jax(fast):
    jt, pt, feats, rays = _half_empty(seed=9, fmt="SH4", ddim=13)
    rays = _subset(rays, _same_setup(jt, rays))
    jr, tr = st.VolumeRenderer(jt), stt.VolumeRenderer(pt)
    G = np.random.RandomState(9).randn(len(np.asarray(rays.origins)), 4).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jr(f, rays, fast=fast) * G))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (g_t,) = torch.autograd.grad((tr(f, _trays(rays), fast=fast) * _t(G)).sum(), f)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))
    assert np.abs(g_j).max() > 0
    with jt.accumulate_weights() as ja:
        jr(jnp.asarray(feats), rays, fast=fast)
    with pt.accumulate_weights() as ta:
        tr(_t(feats), _trays(rays), fast=fast)
    w_j = np.asarray(ja())
    np.testing.assert_allclose(ta().numpy(), w_j, atol=_gtol(w_j))
    assert w_j.sum() > 0


@pytest.mark.parametrize("fast", [False, True])
def test_aux_passes_match_jax_default(fast):
    """opacity_render (and its gradient), render_depth, motion_render
    (with and without compat_hit_point) and motion_feature_render (and
    its gradient) on the default backend."""
    jt, pt, feats, rays = _half_empty(seed=10, fmt="SH4", ddim=13)
    joints = np.random.RandomState(10).rand(5, 3).astype(np.float32)
    jt.extra_data = joints
    pt.extra_data = joints
    if fast:
        rays = _subset(rays, _same_setup(jt, rays))
    B = len(np.asarray(rays.origins))
    M = len(feats)
    rng = np.random.RandomState(11)
    jf = rng.randn(5, 8).astype(np.float32)
    sw = (rng.rand(M, 3) - 0.2).astype(np.float32)
    ji = rng.randint(0, 5, (M, 3)).astype(np.int32)
    jr, tr = st.VolumeRenderer(jt), stt.VolumeRenderer(pt)
    trays = _trays(rays)
    G = rng.randn(B, 1).astype(np.float32)
    a_j, g_j = jax.value_and_grad(lambda f: jnp.sum(jr.opacity_render(f, rays, fast=fast) * G))(
        jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    alpha = tr.opacity_render(f, trays, fast=fast)
    (g_t,) = torch.autograd.grad((alpha * _t(G)).sum(), f)
    _compare(alpha.detach(), jr.opacity_render(jnp.asarray(feats), rays, fast=fast), 1e-2 if fast else 0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=_gtol(g_j))
    np.testing.assert_allclose(tr.render_depth(_t(feats), trays, fast=fast).numpy(),
                               np.asarray(jr.render_depth(jnp.asarray(feats), rays, fast=fast)),
                               atol=ATOL)
    for compat in (0, 1):
        jr.compat_hit_point = tr.compat_hit_point = compat
        want = jr.motion_render(jnp.asarray(feats), rays, fast=fast)
        got = tr.motion_render(_t(feats), trays, fast=fast)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    Gm = rng.randn(B, 8).astype(np.float32)
    mf_j, gjf_j = jax.value_and_grad(lambda x: jnp.sum(
        jr.motion_feature_render(jnp.asarray(feats), x, sw, ji, rays, fast=fast) * Gm))(jnp.asarray(jf))
    x = _t(jf).requires_grad_()
    mf = tr.motion_feature_render(_t(feats), x, sw, ji, trays, fast=fast)
    (gx,) = torch.autograd.grad((mf * _t(Gm)).sum(), x)
    np.testing.assert_allclose(float((mf.detach() * _t(Gm)).sum()), float(mf_j), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gjf_j), atol=_gtol(gjf_j))


def test_empty_tree_culls_every_ray():
    """An all-empty bake has an inverted box: every ray is the background,
    and the empty table's rows are never read."""
    jt = _empty_tree()
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    rays = make_rays(np.random.RandomState(12), 64)
    feats = np.ones((3, 4), np.float32)
    for fast in (False, True):
        got = stt.VolumeRenderer(pt)(_t(feats), _trays(rays), fast=fast).numpy()
        np.testing.assert_array_equal(got, np.asarray(st.VolumeRenderer(jt)(feats, rays, fast=fast)))
        np.testing.assert_array_equal(got[:, -1], 0.0)


def test_pool_rows_in_the_skip_code_space_raise():
    jt, pt, feats, rays = _half_empty(seed=13)
    r = stt.VolumeRenderer(pt)
    baked = pt._baked_spec()
    opt = r._get_options(True)
    huge = baked.with_(skip_base=4)  # a pool of more rows than the code base
    with pytest.raises(ValueError, match="skip boxes"):
        trender.volume_render(huge, _t(feats), *_trays(rays), opt)


@pytest.mark.parametrize("N", [2, 3])
def test_baked_equals_tree_bit_for_bit_in_exact_mode(N):
    """Exact mode: the bake (two- and three-stage) gives the tree walk's
    colors, alpha and depth bit for bit."""
    jt, pt, feats, rays = _half_empty(seed=14, N=N, depth=4 if N == 3 else 5,
                                      refines=1 if N == 3 else 3)
    opt = stt.VolumeRenderer(pt)._get_options(False)
    tr = stt.Rays(*(_t(r)[:192] for r in rays))
    args = (_t(feats), tr.origins, tr.dirs, tr.viewdirs, opt)
    want = trender.volume_render(pt._spec(), *args)
    for baked in (pt._baked_spec(), tbake.bake(pt._spec(), top_levels=2, mid_levels=1)):
        np.testing.assert_array_equal(trender.volume_render(baked, *args).numpy(), want.numpy())
        np.testing.assert_array_equal(
            stt.render_depth(baked, _t(feats), tr.origins, tr.dirs, opt).numpy(),
            stt.render_depth(pt._spec(), _t(feats), tr.origins, tr.dirs, opt).numpy())
    assert want[:, -1].max() > 0.5


# ---------------------------------------------------------------------------
# The dynamic frame loop


@pytest.fixture(scope="module")
def dyn():
    s = Scene()
    jt = s.jax_tree("SH4")
    rays = s.jax_rays()
    mask = _same_setup(jt, rays)
    return s, mask


@pytest.mark.parametrize("fast", [False, True])
def test_dynamic_frames_match_jax_default(dyn, fast):
    """render_dynamic_frames on the default backend: frames, the carried
    index table and the carried box union equal the JAX package's."""
    s, mask = dyn
    jt = s.jax_tree("SH4")
    jrays = _subset(s.jax_rays(), mask)
    want = np.asarray(st.VolumeRenderer(jt).render_dynamic_frames(
        jnp.asarray(s.sh4), *s.lbs(), rays=jrays, fast=fast))
    pt = s.port_tree("SH4")
    got = stt.VolumeRenderer(pt).render_dynamic_frames(_t(s.sh4), *s.lbs(), rays=_trays(jrays),
                                                       fast=fast)
    for k in range(len(want)):
        _compare(got[k].detach(), want[k], 1e-2 if fast else 0.0)
    assert (want[..., -1] > 0.5).any()
    np.testing.assert_array_equal(pt.data, np.asarray(jax.device_get(jt._data)))
    jb, tb = jt._baked_spec(), pt._baked_spec()
    np.testing.assert_array_equal(tb.aabb_lo.numpy(), np.asarray(jb.aabb_lo))
    np.testing.assert_array_equal(tb.aabb_hi.numpy(), np.asarray(jb.aabb_hi))
    np.testing.assert_array_equal(tb.top.numpy(), np.asarray(jb.top).reshape(-1)[: tb.R ** 3])
