"""svox_t_tpu_torch's trilinear interpolation (K4) against the JAX
package (CPU), continued from `tests/test_torch_interp.py` (split so that
the two files run on two test workers): weight accumulation, per-voxel
rotations, SG, the bake's box cull being off, the four aux passes and
`VolumeRenderer(interp="trilinear")` end to end. Tolerances as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops import render_aux as jaux
from svox_t_tpu.utils.spec import DATA_SENTINEL
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import render_aux as taux
from svox_t_tpu_torch.utils.scenes import orbit_camera

from helpers import build_tree, make_rays
from test_torch_bake import _same_setup, _subset, _trays
from test_torch_dynamic import Scene
from test_torch_interp import ATOL, _gtol, _opts, _port, _render, _t


def _half_occupied(seed, fmt="RGBA", ddim=4, **kw):
    """A tree whose leaves with x < 0.45 hold rows, the rest empty."""
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, data_format=fmt, data_dim=ddim, depth_limit=5,
                              sigma_scale=20.0, occupy=lambda c: c[:, 0] < 0.45, **kw)
    return rng, jt, _port(jt), np.asarray(feats), make_rays(rng, 128)


def test_weight_accumulation_matches_jax():
    """Under interp every compositing sample adds its weight into its own
    cell, also where its own leaf is empty; both backends."""
    rng, jt, pt, feats, rays = _half_occupied(20)
    jr = st.VolumeRenderer(jt, backend="tree", interp="trilinear")
    with jt.accumulate_weights() as ja:
        out_j = np.asarray(jr(jnp.asarray(feats), rays))
    w_j = np.asarray(ja())
    for backend in ("tree", "baked"):
        tr = stt.VolumeRenderer(pt, backend=backend, interp="trilinear")
        with pt.accumulate_weights() as ta:
            out_t = tr(_t(feats), _trays(rays))
        np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL)
        np.testing.assert_allclose(ta().numpy(), w_j, atol=_gtol(w_j))
    # Weight lands in leaves without a row: the skin outside the data.
    empty = np.asarray(jt[:].values)[:, -1] == 0
    assert w_j[empty].sum() > 0


def _vjp(fn, x, G):
    """(fn(x), the gradient of sum(fn(x) * G)) of a JAX function."""
    out, back = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(back(jnp.asarray(G))[0])


def test_rotations_read_row_zero_in_empty_leaves():
    """SH with per-voxel rotations: a sample in an empty leaf rotates its
    basis by transformation_matrices[0] (JAX `ops/render.py:814-816`), in
    the forward and the gradient; the two backends bit for bit."""
    rng, jt, pt, feats, rays = _half_occupied(21, "SH4", 13)
    M = feats.shape[0]
    ang = rng.rand(M).astype(np.float32) * 2.0
    tm = np.zeros((M, 4, 4), np.float32)
    tm[:, 0, 0], tm[:, 0, 1], tm[:, 1, 0], tm[:, 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    tm[:, 2, 2] = tm[:, 3, 3] = 1.0
    tm2 = tm.copy()
    tm2[0, :3, :3] = np.eye(3)[[1, 2, 0]]
    G = rng.randn(len(np.asarray(rays.origins)), 4).astype(np.float32)
    jr = st.VolumeRenderer(jt, interp="trilinear")
    out_j, g_j = _vjp(lambda f: jr(f, rays, jnp.asarray(tm)), feats, G)
    outs = {}
    for backend in ("tree", "baked"):
        tr = stt.VolumeRenderer(pt, backend=backend, interp="trilinear")
        f = _t(feats).requires_grad_()
        out = tr(f, _trays(rays), _t(tm))
        (g_t,) = torch.autograd.grad((out * _t(G)).sum(), f)
        np.testing.assert_allclose(out.detach().numpy(), out_j, atol=ATOL)
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))
        outs[backend] = out.detach().numpy()
    np.testing.assert_array_equal(outs["baked"], outs["tree"])
    # Another matrix in row 0 moves the render as it moves the JAX one.
    moved = stt.VolumeRenderer(pt, interp="trilinear")(_t(feats), _trays(rays), _t(tm2)).numpy()
    np.testing.assert_allclose(moved, np.asarray(jr(jnp.asarray(feats), rays, jnp.asarray(tm2))),
                               atol=ATOL)
    assert np.abs(moved - outs["baked"]).max() > 1e-4


def test_sg_matches_jax():
    """An SG pool (9 lobes), forward and gradient."""
    rng = np.random.RandomState(22)
    lobes = np.concatenate([rng.rand(9, 1) * 4 + 1, rng.randn(9, 3)], axis=1).astype(np.float32)
    lobes[:, 1:] /= np.linalg.norm(lobes[:, 1:], axis=1, keepdims=True)
    jt, feats, _ = build_tree(rng, data_format="SG9", data_dim=28, extra_data=jnp.asarray(lobes),
                              sigma_scale=20.0)
    feats = np.asarray(feats)[: int(feats.shape[0] * 0.6)]
    rays = make_rays(rng, 64)
    pt = _port(jt)
    jo, to = _opts(jt, pt, interp=1)
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jrender.volume_render(
        jt._baked_spec(), f, rays.origins, rays.dirs, rays.viewdirs, jo) ** 2))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    out = trender.volume_render(pt._baked_spec(), f, *_trays(rays), to)
    (g_t,) = torch.autograd.grad((out ** 2).sum(), f)
    want = jrender.volume_render(jt._baked_spec(), jnp.asarray(feats), rays.origins, rays.dirs,
                                 rays.viewdirs, jo)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))


def _low_corner_tree(seed, below=0.4):
    """`test_baked_chunked.py::test_occupied_aabb_cull_interp_parity`'s
    scene: only leaves with every centre coordinate < ``below`` hold rows."""
    rng = np.random.RandomState(seed)
    jt, _, centers = build_tree(rng, depth_limit=4, n_random_refines=2)
    jt.data[:] = DATA_SENTINEL
    jt._invalidate_spec()
    sub = centers[np.all(centers < below, axis=1)]
    jt.construct_tree(sub)
    feats = (np.abs(np.random.RandomState(3).randn(len(sub), 4)) * 8).astype(np.float32)
    return rng, jt, _port(jt), feats


def test_box_cull_is_off():
    """Corner cells bleed sigma up to half a cell outside the occupied
    box: under interp the bake neither culls nor clamps at the box, so its
    exact render is the tree walk's bit for bit, and rays that miss the
    box composite."""
    rng, jt, pt, feats = _low_corner_tree(23)
    baked = pt._baked_spec()
    assert float((baked.aabb_hi - baked.aabb_lo).max()) < 1.0
    rays = make_rays(rng, 256)
    jo, to = _opts(jt, pt, interp=1)
    out_b = _render(baked, feats, rays, to).numpy()
    np.testing.assert_array_equal(out_b, _render(pt._spec(), feats, rays, to).numpy())
    want = jrender.volume_render(jt._baked_spec(), jnp.asarray(feats), rays.origins, rays.dirs,
                                 rays.viewdirs, jo)
    np.testing.assert_allclose(out_b, np.asarray(want), atol=ATOL)
    culled = ~trender._ray_setup(baked, *_trays(rays)[:2], dataclasses.replace(to, interp=0))[-1]
    assert culled.any() and out_b[culled.numpy(), -1].max() > 1e-3
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jrender.volume_render(
        jt._baked_spec(), f, rays.origins, rays.dirs, rays.viewdirs, jo) ** 2))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (g_t,) = torch.autograd.grad((trender.volume_render(baked, f, *_trays(rays), to) ** 2).sum(), f)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))


@pytest.mark.parametrize("scene", ["full", "low-corner"])
def test_aux_passes_match_jax(scene):
    """`test_baked_chunked.py::test_aux_backend_interp_parity` and the
    boundary-skin tests of `test_render_aux.py`: opacity (and its
    gradient), depth, motion_render (with the reference's hit point, whose
    fraction is the one at t_hit) and motion features (and their
    gradient) under interp, on both backends, against the JAX default."""
    if scene == "full":
        rng = np.random.RandomState(7)
        jt, feats, _ = build_tree(rng, data_dim=13, data_format="SH4", depth_limit=5,
                                  n_random_refines=3)
        feats = np.asarray(feats)
        rays = make_rays(rng, 64)
    else:
        rng, jt, _, feats = _low_corner_tree(24, below=0.45)
        origins = ((rng.rand(64, 3) - 0.5) * 0.6 + 1.8).astype(np.float32)
        dirs = 0.25 - origins
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        rays = st.Rays(jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(dirs))
    jt.extra_data = jnp.asarray(np.random.RandomState(1).rand(5, 3).astype(np.float32))
    jt._invalidate_spec()
    pt = _port(jt)
    M = feats.shape[0]
    jo, to = _opts(jt, pt, interp=1, compat_hit_point=1)
    n_bones, J, jdim = 3, 5, 6
    sw = np.abs(rng.rand(M, n_bones)).astype(np.float32)
    ji = rng.randint(0, J, size=(M, n_bones)).astype(np.int32)
    jf = rng.randn(J, jdim).astype(np.float32)
    G, Gm = rng.randn(64, 1).astype(np.float32), rng.randn(64, jdim).astype(np.float32)
    jspec = jt._baked_spec()
    args = (rays.origins, rays.dirs, jo)
    a_j, g_j = _vjp(lambda f: jaux.opacity_render(jspec, f, *args), feats, G)
    motion_j = [np.asarray(x) for x in jaux.motion_render(jspec, jnp.asarray(feats), *args)]
    js = jt._baked_spec(skinning_weights=jnp.asarray(sw), joint_index=jnp.asarray(ji))
    mf_j, gjf_j = _vjp(lambda x: jaux.motion_feature_render(js, x, jnp.asarray(feats), *args), jf, Gm)
    assert np.abs(g_j).max() > 0 and (motion_j[1] > 0).any()
    o, d = _trays(rays)[:2]
    for backend in ("tree", "baked"):
        of = pt._spec if backend == "tree" else pt._baked_spec
        tspec = of()
        f = _t(feats).requires_grad_()
        alpha = taux.opacity_render(tspec, f, o, d, to)
        (g_t,) = torch.autograd.grad((alpha * _t(G)).sum(), f)
        np.testing.assert_allclose(alpha.detach().numpy(), a_j, atol=ATOL)
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))
        depth = taux.render_depth(tspec, _t(feats), o, d, to)
        motion = taux.motion_render(tspec, _t(feats), o, d, to)
        np.testing.assert_array_equal(depth.numpy(), motion[1].numpy())
        for w, g in zip(motion_j, motion):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=backend)
        assert (motion[3][motion[1][:, 0] > 0] < M).all()
        x = _t(jf).requires_grad_()
        mf = taux.motion_feature_render(of(skinning_weights=_t(sw), joint_index=_t(ji)), x,
                                        _t(feats), o, d, to)
        (gx,) = torch.autograd.grad((mf * _t(Gm)).sum(), x)
        np.testing.assert_allclose(mf.detach().numpy(), mf_j, atol=ATOL)
        np.testing.assert_allclose(gx.numpy(), gjf_j, atol=_gtol(gjf_j))
    if scene == "low-corner":
        # The skin: depth under interp lies before the nearest-mode depth on
        # some rays, never after.
        depth = depth.numpy()
        near = taux.render_depth(tspec, _t(feats), o, d, dataclasses.replace(to, interp=0)).numpy()
        both = (depth > 0) & (near > 0)
        assert both.any() and (depth[both] <= near[both] + 1e-5).all()
        assert (depth[both] < near[both] - 1e-4).any()


def test_renderer_forward_and_persp_match_jax():
    """forward (exact and fast) and render_persp on both backends against
    the JAX default; under interp fast mode has no box advance and no skip
    boxes, so the two backends agree there too."""
    rng, jt, pt, feats, rays = _half_occupied(26, "SH4", 13)
    jr = st.VolumeRenderer(jt, interp="trilinear")
    sub = _subset(rays, _same_setup(jt, rays))
    c2w = orbit_camera(0.3, 0.4, 2.0)
    want = [np.asarray(jr(jnp.asarray(feats), rays)),
            np.asarray(jr(jnp.asarray(feats), sub, fast=True)),
            np.asarray(jr.render_persp(jnp.asarray(feats), c2w, 20, 16, fx=24.0))]
    assert want[2][..., -1].max() > 0.5
    for backend in ("tree", "baked"):
        tr = stt.VolumeRenderer(pt, backend=backend, interp="trilinear")
        got = [tr(_t(feats), _trays(rays)), tr(_t(feats), _trays(sub), fast=True),
               tr.render_persp(_t(feats), c2w, 20, 16, fx=24.0)]
        for g, w, tol in zip(got, want, (ATOL, ATOL, 3e-5)):
            np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=backend)


def test_renderer_dynamic_frames_match_jax():
    """render_dynamic_frames under interp (rotations and depth) on both
    backends: frames, depths and the carried table equal the JAX
    default's."""
    s = Scene()
    jt = s.jax_tree("SH4")
    jrays = _subset(s.jax_rays(), _same_setup(jt, s.jax_rays()))
    cols_j, deps_j = st.VolumeRenderer(jt, interp="trilinear").render_dynamic_frames(
        jnp.asarray(s.sh4), *s.lbs(), rays=jrays, with_depth=True)
    assert (np.asarray(cols_j)[..., -1] > 0.5).any()
    for backend in ("tree", "baked"):
        pt = s.port_tree("SH4")
        cols, deps = stt.VolumeRenderer(pt, backend=backend, interp="trilinear").render_dynamic_frames(
            _t(s.sh4), *s.lbs(), rays=_trays(jrays), with_depth=True)
        np.testing.assert_allclose(cols.detach().numpy(), np.asarray(cols_j), atol=ATOL)
        np.testing.assert_allclose(deps.numpy(), np.asarray(deps_j), atol=ATOL)
        np.testing.assert_array_equal(pt.data, np.asarray(jax.device_get(jt._data)))
