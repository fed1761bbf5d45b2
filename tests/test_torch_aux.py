"""svox_t_tpu_torch's aux passes against the JAX package (CPU): opacity
and its sigma-only VJP, first-hit depth and motion render, and the
motion-feature (LBS) render with its corrected VJP.

Tolerances: outputs, depths and hit points atol 1e-5 (the JAX march
forms L as a per-round cumulative product, the port per sample, so they
round differently by a few ulps; in fast mode rays whose alpha lands
within 1e-6 of 1 - stop_thresh are left out, as in
tests/test_torch_render.py). Gradients against `jax.grad`:
``1e-5 * max(1, max|g_jax|)``, the tolerance of the main render's VJP.
Hits (`found`, data_idx) must agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render_aux as taux
from svox_t_tpu_torch.ops.traversal import descend, world2tree

from helpers import build_tree, make_rays

ATOL = 1e-5
J, KD, NB = 5, 6, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(g).max()))


def _scene(seed, fmt="RGBA", ddim=4, n_rays=160, occupy=None):
    rng = np.random.RandomState(seed)
    joints = rng.rand(J, 3).astype(np.float32)
    jt, feats, _ = build_tree(rng, data_format=fmt, data_dim=ddim, depth_limit=5,
                              sigma_scale=20.0, extra_data=joints, occupy=occupy)
    feats = np.array(feats)
    M = feats.shape[0]
    rays = make_rays(rng, n_rays)
    lbs = dict(
        jf=rng.randn(J, KD).astype(np.float32),
        # Some weights are zero or negative: the blend skips those bones.
        sw=(rng.rand(M, NB) - 0.2).astype(np.float32),
        ji=rng.randint(0, J, (M, NB)).astype(np.int32),
    )
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    return rng, jt, pt, feats, rays, lbs, joints


def _renderers(jt, pt, **attrs):
    jr, tr = st.VolumeRenderer(jt, backend="tree"), stt.VolumeRenderer(pt, backend="tree")
    for k, v in attrs.items():
        setattr(jr, k, v)
        setattr(tr, k, v)
    return jr, tr


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _keep(alpha, fast):
    """Rays whose stop sample is not within rounding of the threshold."""
    if not fast:
        return np.ones(len(alpha), bool)
    keep = np.abs(np.asarray(alpha)[:, 0] - (1.0 - 1e-2)) >= 1e-6
    assert keep.mean() > 0.9
    return keep


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
@pytest.mark.parametrize("fast", [False, True])
def test_opacity_matches_jax_and_render_alpha(fmt, ddim, fast):
    rng, jt, pt, feats, rays, _, _ = _scene(1 + ddim, fmt, ddim)
    jr, tr = _renderers(jt, pt)
    want = np.asarray(jr.opacity_render(jnp.asarray(feats), rays, fast=fast))
    got = tr.opacity_render(_t(feats), _trays(rays), fast=fast)
    keep = _keep(want, fast)
    assert got.shape == want.shape == (len(rays.origins), 1)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=ATOL)
    assert want.max() > 0.5
    # Bit for bit the alpha column of the port's own render.
    alpha = tr(_t(feats), _trays(rays), fast=fast)[:, -1:]
    np.testing.assert_array_equal(got.numpy(), alpha.detach().numpy())


@pytest.mark.parametrize("fast", [False, True])
def test_opacity_grad_matches_jax(fast):
    rng, jt, pt, feats, rays, _, _ = _scene(3, "SH4", 13)
    jr, tr = _renderers(jt, pt)
    G = rng.randn(len(rays.origins), 1).astype(np.float32)
    gj = np.asarray(jax.grad(lambda f: jnp.sum(jr.opacity_render(f, rays, fast=fast) * G))(
        jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (tr.opacity_render(f, _trays(rays), fast=fast) * _t(G)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), gj, atol=_gtol(gj))
    assert np.abs(gj[:, -1]).max() > 0 and not f.grad[:, :-1].any()


@pytest.mark.parametrize("fast", [False, True])
def test_opacity_grad_equals_render_alpha_grad(fast):
    """The sigma-only VJP is K3's sigma column with zero color gradients,
    in both the single- and the two-pass mode; a pool with large color
    columns shows that pass A writes nothing."""
    rng, jt, pt, feats, rays, _, _ = _scene(4, "SH4", 13)
    feats[:, :-1] *= 100.0
    tr = stt.VolumeRenderer(pt, backend="tree")
    G = _t(rng.randn(len(rays.origins), 1).astype(np.float32))
    f1 = _t(feats).requires_grad_()
    (tr.opacity_render(f1, _trays(rays), fast=fast) * G).sum().backward()
    f2 = _t(feats).requires_grad_()
    (tr(f2, _trays(rays), fast=fast)[:, -1:] * G).sum().backward()
    np.testing.assert_array_equal(f1.grad.numpy(), f2.grad.numpy())
    assert not f1.grad[:, :-1].any() and f1.grad[:, -1].abs().max() > 0


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
@pytest.mark.parametrize("fast", [False, True])
def test_depth_matches_jax(fmt, ddim, fast):
    rng, jt, pt, feats, rays, _, _ = _scene(5 + ddim, fmt, ddim)
    jr, tr = _renderers(jt, pt)
    want = np.asarray(jr.render_depth(jnp.asarray(feats), rays, fast=fast))
    got = tr.render_depth(_t(feats), _trays(rays), fast=fast).numpy()
    assert got.shape == want.shape == (len(rays.origins), 1)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (want > 0).mean() > 0.3


@pytest.mark.parametrize("compat", [0, 1])
def test_motion_render_matches_jax(compat):
    rng, jt, pt, feats, rays, _, joints = _scene(7, "SH4", 13)
    jr, tr = _renderers(jt, pt, compat_hit_point=compat)
    want = [np.asarray(x) for x in jr.motion_render(jnp.asarray(feats), rays)]
    got = [x.numpy() for x in tr.motion_render(_t(feats), _trays(rays))]
    names = ("motion", "depth", "hit_point", "data_idx")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
    found = want[1][:, 0] > 0
    assert found.mean() > 0.3 and (~found).any()
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].dtype == np.int32
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=ATOL)
    # Joint distances flow from the hit point.
    dist = np.linalg.norm(got[2][found][:, None, :] - joints[None], axis=-1)
    np.testing.assert_allclose(got[0][found], dist, atol=ATOL)
    assert not got[0][~found].any() and not got[2][~found].any()


def test_compat_hit_point_is_the_in_leaf_fraction():
    rng, jt, pt, feats, rays, _, _ = _scene(8, "RGBA", 4)
    _, tr = _renderers(jt, pt)
    _, depth, hp, didx = tr.motion_render(_t(feats), _trays(rays))
    tr.compat_hit_point = 1
    _, depth_c, hp_c, didx_c = tr.motion_render(_t(feats), _trays(rays))
    np.testing.assert_array_equal(depth_c.numpy(), depth.numpy())
    np.testing.assert_array_equal(didx_c.numpy(), didx.numpy())
    found = depth[:, 0] > 0
    spec = pt._spec()
    frac = descend(spec, world2tree(hp, spec.offset, spec.scaling)).frac
    want = pt.tree2world(frac)
    np.testing.assert_allclose(hp_c[found].numpy(), want[found].numpy(), atol=ATOL)
    assert float((hp_c[found] - hp[found]).abs().max()) > 1e-3


def _mf_jax(jr, feats, lbs, rays, fast, G=None):
    args = (jnp.asarray(lbs["sw"]), jnp.asarray(lbs["ji"]), rays)
    if G is None:
        return np.asarray(jr.motion_feature_render(jnp.asarray(feats), jnp.asarray(lbs["jf"]), *args,
                                                   fast=fast))
    return np.asarray(jax.grad(lambda j: jnp.sum(
        jr.motion_feature_render(jnp.asarray(feats), j, *args, fast=fast) * G))(jnp.asarray(lbs["jf"])))


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
@pytest.mark.parametrize("fast", [False, True])
def test_motion_feature_matches_jax(fmt, ddim, fast):
    rng, jt, pt, feats, rays, lbs, _ = _scene(9 + ddim, fmt, ddim)
    jr, tr = _renderers(jt, pt)
    want = _mf_jax(jr, feats, lbs, rays, fast)
    got = tr.motion_feature_render(_t(feats), _t(lbs["jf"]), _t(lbs["sw"]), _t(lbs["ji"]),
                                   _trays(rays), fast=fast)
    keep = _keep(np.asarray(jr.opacity_render(jnp.asarray(feats), rays, fast=fast)), fast)
    assert got.shape == want.shape == (len(rays.origins), KD)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=ATOL)
    # Rays that miss the cube give 0, not the background.
    miss = np.abs(want).max(axis=1) == 0
    assert miss.any() and not got[torch.from_numpy(miss)].any()
    assert (~miss).mean() > 0.3


@pytest.mark.parametrize("fast", [False, True])
def test_motion_feature_grad_matches_jax(fast):
    rng, jt, pt, feats, rays, lbs, _ = _scene(11, "SH4", 13)
    jr, tr = _renderers(jt, pt)
    G = rng.randn(len(rays.origins), KD).astype(np.float32)
    gj = _mf_jax(jr, feats, lbs, rays, fast, G)
    jf = _t(lbs["jf"]).requires_grad_()
    f = _t(feats).requires_grad_()
    out = tr.motion_feature_render(f, jf, _t(lbs["sw"]), _t(lbs["ji"]), _trays(rays), fast=fast)
    (out * _t(G)).sum().backward()
    np.testing.assert_allclose(jf.grad.numpy(), gj, atol=_gtol(gj))
    assert np.abs(gj).max() > 0 and f.grad is None


def test_empty_pool_matches_jax():
    rng, jt, pt, feats, rays, lbs, _ = _scene(12)
    jr, tr = _renderers(jt, pt)
    empty = feats[:0]
    trays = _trays(rays)
    np.testing.assert_array_equal(tr.opacity_render(_t(empty), trays).numpy(), 0.0)
    np.testing.assert_array_equal(tr.render_depth(_t(empty), trays).numpy(), 0.0)
    mr = tr.motion_render(_t(empty), trays)
    assert all(not x.any() for x in mr)
    want = _mf_jax(jr, empty, lbs, rays, False)
    got = tr.motion_feature_render(_t(empty), _t(lbs["jf"]), _t(lbs["sw"]), _t(lbs["ji"]), trays)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    f = _t(empty).requires_grad_()
    tr.opacity_render(f, trays).sum().backward()
    assert f.grad.shape == (0, 4)


def test_negative_sigma_thresh_matches_jax():
    """With sigma_thresh < 0 empty space is over the threshold: t_hit is
    the first sample of the march while found and the row come from the
    first resident sample, and the compat fraction is that of t_hit."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(13, "RGBA", 4, occupy=lambda c: c[:, 0] < 0.6)
    for compat in (0, 1):
        jr, tr = _renderers(jt, pt, sigma_thresh=-1.0, compat_hit_point=compat)
        want = [np.asarray(x) for x in jr.motion_render(jnp.asarray(feats), rays)]
        got = [x.numpy() for x in tr.motion_render(_t(feats), _trays(rays))]
        np.testing.assert_array_equal(got[3], want[3])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_allclose(tr.render_depth(_t(feats), _trays(rays)).numpy(),
                               np.asarray(jr.render_depth(jnp.asarray(feats), rays)), atol=ATOL)
    # The hit precedes the resident sample on some rays.
    spec = pt._spec()
    opt = tr._get_options()
    found, t_hit, row, frac = taux.first_hit(spec, _t(feats), *_trays(rays)[:2], opt)
    _, t_plain, _, _ = taux.first_hit(spec, _t(feats), *_trays(rays)[:2],
                                      dataclasses.replace(opt, sigma_thresh=0.0))
    assert bool((found & (t_hit < t_plain - 1e-4)).any())
    want = _mf_jax(jr, feats, lbs, rays, False)
    got = tr.motion_feature_render(_t(feats), _t(lbs["jf"]), _t(lbs["sw"]), _t(lbs["ji"]),
                                   _trays(rays))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gradients_use_the_captured_spec():
    """Re-pointing the tree between forward and backward changes neither
    the opacity nor the motion-feature gradient."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(14, "SH4", 13)
    tr = stt.VolumeRenderer(pt, backend="tree")
    trays = _trays(rays)

    def grads(repoint):
        f = _t(feats).requires_grad_()
        jf = _t(lbs["jf"]).requires_grad_()
        loss = tr.opacity_render(f, trays).sum() + tr.motion_feature_render(
            f.detach(), jf, _t(lbs["sw"]), _t(lbs["ji"]), trays).sum()
        if repoint:
            pt.construct_tree(torch.rand(len(feats), 3))
        loss.backward()
        return f.grad, jf.grad

    want = grads(False)
    got = grads(True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert w.abs().max() > 0


def test_spec_attaches_lbs_tables_per_call():
    rng, jt, pt, feats, rays, lbs, _ = _scene(15)
    base = pt._spec()
    spec = pt._spec(joint_features=lbs["jf"], skinning_weights=lbs["sw"],
                    joint_index=lbs["ji"])
    assert spec.skinning_weights.dtype == torch.float32 and spec.joint_index.dtype == torch.int32
    np.testing.assert_array_equal(spec.joint_index.numpy(), lbs["ji"])
    assert tuple(spec.joint_features.shape) == (J, KD)
    assert pt._spec() is base and base.skinning_weights is None


def test_unsupported_inputs_raise():
    rng, jt, pt, feats, rays, lbs, _ = _scene(16)
    tr = stt.VolumeRenderer(pt, backend="tree")
    trays = _trays(rays)
    with pytest.raises(ValueError, match="extra_data"):
        stt.VolumeRenderer(stt.tree_from_numpy(dict(stt.tree_state(jt), extra_data=None), device="cpu"), backend="tree").motion_render(
            _t(feats), trays)
    o, d = trays.origins, trays.dirs
    # An int8 quantized pool (K5; it raised NotImplementedError before):
    # the opacity render equals the JAX package's on the same pool.
    jq = st.quantize_features(jnp.asarray(feats))
    qf = stt.quantized_from_numpy(*(np.asarray(a) for a in jq), device="cpu")
    jr = st.VolumeRenderer(jt, backend="tree")
    want = jr.opacity_render(jq, st.Rays(*(jnp.asarray(x) for x in rays)))
    got = tr.opacity_render(qf, trays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not got.requires_grad and float(got.max()) > 0.5
    with pytest.raises(ValueError, match="skinning_weights"):
        taux.motion_feature_render(pt._spec(), _t(lbs["jf"]), _t(feats), o, d, tr._get_options())


def test_kernel_wrappers_reject_cpu_and_oversize_tables():
    """The kernel wrappers launch or raise; they never run the plain
    version in their place."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(17)
    opt = stt.VolumeRenderer(pt, backend="tree")._get_options()
    o, d = _trays(rays)[:2]
    f = _t(feats)
    spec = pt._spec(skinning_weights=lbs["sw"], joint_index=lbs["ji"])
    g1 = torch.zeros(len(o), 1)
    for call in (lambda: taux.opacity_backward_cuda(spec, f, o, d, g1, opt),
                 lambda: taux.first_hit_cuda(spec, f, o, d, opt),
                 lambda: taux.motion_feature_forward_cuda(spec, _t(lbs["jf"]), f, o, d, opt)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    wide = torch.zeros(J, taux.KERNEL_MAX_JOINT_DIM + 1)
    with pytest.raises(NotImplementedError, match="32 joint-feature columns"):
        taux.motion_feature_forward_cuda(spec, wide, f, o, d, opt)
    many = torch.zeros(taux.KERNEL_MAX_JOINT_TABLE // 4 + 1, 4)
    with pytest.raises(NotImplementedError, match="12288 joint-table floats"):
        taux.motion_feature_backward_cuda(spec, many, f, o, d, torch.zeros(len(o), 4), opt)
