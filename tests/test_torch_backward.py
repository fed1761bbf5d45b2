"""svox_t_tpu_torch's training path against the JAX package on the CPU:
gradients of `VolumeRenderer.forward`, `render_persp` and
`N3Tree.forward` with respect to the feature pool, the raw
`volume_render_backward`, and per-leaf weight accumulation.

The JAX side is `jax.grad` through the JAX package's own custom VJPs; the
port side is `torch.autograd.grad` through the port's autograd Functions,
which run their plain PyTorch versions on CPU tensors. Inputs are NumPy
arrays from fixed seeds handed to both packages, and each loss is
``sum(out * G)`` with a seeded ``G``, so the gradient of the output is
``G`` itself.

Tolerance: gradients agree to ``atol = 1e-5 * max(1, max|g_jax|)``. The
JAX backward forms L per round with a cumulative product and adds
gradient rows in one deterministic scatter per round, while the port
multiplies per sample and adds row by row, so the two round differently
by a few ulps of the largest entries.

Per-leaf weights agree to atol 1e-5 (WEIGHT_ATOL), not 1e-6: a weight is
``L * (1 - att)``, and where a sample's ``sigma * dt`` is small the
difference ``1 - att`` cancels, so the one-ulp difference between XLA's
and PyTorch's ``exp`` becomes up to ~6e-5 of that weight; a leaf sums
the weights of every sample that crosses it (up to ~100 here), which
measured up to 4.7e-6 on these scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.utils.scenes import orbit_camera

from helpers import build_tree, make_rays

N_RAYS = 160
WEIGHT_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    atol = 1e-5 * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _scene(seed, fmt="RGBA", ddim=4, toward_center=True, extra=None, N=2):
    rng = np.random.RandomState(seed)
    jt, feats, centers = build_tree(rng, N=N, data_format=fmt, data_dim=ddim,
                                    depth_limit=4, sigma_scale=20.0, extra_data=extra)
    rays = make_rays(rng, N_RAYS, toward_center=toward_center)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    return rng, jt, pt, np.array(feats), rays, centers


def _gmat(rng, n_out, n=N_RAYS):
    return rng.randn(n, n_out).astype(np.float32)


def _grads(jt, pt, feats, rays, G, fast=False, rot=None, **kw):
    """(port gradient, JAX gradient) of sum(forward(features) * G)."""
    jr = st.VolumeRenderer(jt, backend="tree", **kw)
    jrot = None if rot is None else jnp.asarray(rot)
    gj = jax.grad(lambda f: jnp.sum(jr(f, rays, jrot, fast=fast) * G))(jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    out = stt.VolumeRenderer(pt, **kw, backend="tree")(f, _trays(rays), None if rot is None else _t(rot), fast=fast)
    (gt,) = torch.autograd.grad((out * _t(G)).sum(), f)
    return gt.numpy(), np.asarray(gj)


def _sg_asg_extra(rng, width):
    extra = rng.rand(4, width).astype(np.float32)
    for a in range(1 if width == 4 else 2, width, 3):
        extra[:, a:a + 3] /= np.linalg.norm(extra[:, a:a + 3], axis=1, keepdims=True)
    return extra


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13), ("SH9", 28)])
@pytest.mark.parametrize("fast", [False, True])
def test_grad_matches_jax(fmt, ddim, fast):
    """Exact mode takes the single pass, fast mode the two passes."""
    rng, jt, pt, feats, rays, _ = _scene(30 + ddim, fmt, ddim)
    G = _gmat(rng, 4)
    gt, gj = _grads(jt, pt, feats, rays, G, fast=fast)
    _assert_grad_close(gt, gj)
    assert np.abs(gj).max() > 1e-2  # the gradient is not trivially zero
    assert (np.abs(gj[:, -1]) > 0).mean() > 0.2  # sigma columns are reached


@pytest.mark.parametrize("fmt,width", [("SG", 4), ("ASG", 11)])
@pytest.mark.parametrize("fast", [False, True])
def test_grad_sg_asg_match_jax(fmt, width, fast):
    rng = np.random.RandomState(40 + width)
    extra = _sg_asg_extra(rng, width)
    rng, jt, pt, feats, rays, _ = _scene(40 + width, f"{fmt}4", 13, extra=extra)
    G = _gmat(rng, 4)
    gt, gj = _grads(jt, pt, feats, rays, G, fast=fast)
    _assert_grad_close(gt, gj)
    assert np.abs(gj[:, :-1]).max() > 1e-3


@pytest.mark.parametrize("fast", [False, True])
def test_grad_matrices_match_jax(fast):
    rng, jt, pt, feats, rays, _ = _scene(50, "SH4", 13)
    M = len(feats)
    rot = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    rot[:, :3, :3] = np.linalg.qr(rng.randn(M, 3, 3).astype(np.float32))[0]
    G = _gmat(rng, 4)
    gt, gj = _grads(jt, pt, feats, rays, G, fast=fast, rot=rot)
    _assert_grad_close(gt, gj)
    g_plain, _ = _grads(jt, pt, feats, rays, G, fast=fast)
    assert np.abs(gt - g_plain).max() > 1e-3  # the rotation matters


@pytest.mark.parametrize("fast", [False, True])
def test_grad_window_background_max_steps_match_jax(fast):
    """A [min_comp, max_comp] window, a grey background and a ragged step
    cap (37 is no multiple of the JAX round size)."""
    rng, jt, pt, feats, rays, _ = _scene(51, "SH9", 28)
    G = _gmat(rng, 4)
    kw = dict(min_comp=1, max_comp=5, background_brightness=0.3, max_steps=37)
    gt, gj = _grads(jt, pt, feats, rays, G, fast=fast, **kw)
    _assert_grad_close(gt, gj)
    coeffs = gt[:, :27].reshape(-1, 3, 9)
    assert np.abs(coeffs[:, :, [0, 6, 7, 8]]).max() == 0  # outside the window
    g_full, _ = _grads(jt, pt, feats, rays, G, fast=fast)
    assert np.abs(gt - g_full).max() > 1e-3


def test_grad_misses_and_empty_pool_match_jax():
    rng, jt, pt, feats, rays, _ = _scene(52, "SH4", 13, toward_center=False)
    G = _gmat(rng, 4)
    gt, gj = _grads(jt, pt, feats, rays, G)
    _assert_grad_close(gt, gj)
    out = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays)).numpy()
    assert (out[:, -1] == 0).any() and (out[:, -1] > 0).any()  # misses and hits
    empty = np.zeros((0, 13), np.float32)
    gt0, gj0 = _grads(jt, pt, empty, rays, G)
    assert gt0.shape == gj0.shape == (0, 13)


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
def test_raw_backward_two_pass_without_out_res_matches_jax(fmt, ddim):
    """`volume_render_backward(..., out_res=None)` takes the two passes
    even in exact mode, as the JAX one does."""
    rng, jt, pt, feats, rays, _ = _scene(53 + ddim, fmt, ddim)
    G = _gmat(rng, 4)
    opt_j = st.VolumeRenderer(jt, backend="tree")._get_options(False)
    opt_t = stt.VolumeRenderer(pt, backend="tree")._get_options(False)
    gj = jrender.volume_render_backward(jt._spec(), jnp.asarray(feats), *rays, jnp.asarray(G), opt_j)
    gt = trender.volume_render_backward(pt._spec(), _t(feats), *(_t(r) for r in rays), _t(G), opt_t)
    _assert_grad_close(gt.numpy(), np.asarray(gj))
    # The single pass from the forward output gives the same gradient.
    out = trender.volume_render(pt._spec(), _t(feats), *(_t(r) for r in rays), opt_t)
    g1 = trender.volume_render_backward(pt._spec(), _t(feats), *(_t(r) for r in rays), _t(G),
                                        opt_t, out_res=out)
    _assert_grad_close(g1.numpy(), gt.numpy())


def test_render_persp_grad_matches_jax():
    rng, jt, pt, feats, _, _ = _scene(55, "SH4", 13)
    c2w = orbit_camera(0.2, 0.5, 2.0)
    G = rng.randn(10, 12, 4).astype(np.float32)
    jr = st.VolumeRenderer(jt, backend="tree")
    gj = jax.grad(lambda f: jnp.sum(jr.render_persp(f, c2w, 12, 10, fx=14.0) * G))(jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    tr = stt.VolumeRenderer(pt, backend="tree")
    (gt,) = torch.autograd.grad((tr.render_persp(f, c2w, 12, 10, fx=14.0) * _t(G)).sum(), f)
    _assert_grad_close(gt.numpy(), np.asarray(gj))
    assert np.abs(gt.numpy()).max() > 1e-2
    # The same gradient as forward() on the camera's rays.
    o, d = trender.cam2world_rays(_t(c2w), 12, 10, 14.0, 14.0)
    (gf,) = torch.autograd.grad((tr(f, stt.Rays(o, d, d)) * _t(G).reshape(-1, 4)).sum(), f)
    np.testing.assert_array_equal(gt.numpy(), gf.numpy())


@pytest.mark.parametrize("fast", [False, True])
def test_weight_accumulation_matches_jax(fast):
    rng, jt, pt, feats, rays, _ = _scene(56, "SH4", 13)
    jr, tr = st.VolumeRenderer(jt, backend="tree"), stt.VolumeRenderer(pt, backend="tree")
    with jt.accumulate_weights() as jacc:
        jout = np.asarray(jr(jnp.asarray(feats), rays, fast=fast))
        with pytest.raises(RuntimeError, match="Tree locked"):
            jt.refine()
    f = _t(feats).requires_grad_()
    with pt.accumulate_weights() as tacc:
        tout = tr(f, _trays(rays), fast=fast)
        with pytest.raises(RuntimeError, match="Tree locked"):
            pt.refine()
        with pytest.raises(RuntimeError, match="Tree locked"):
            pt.shrink_to_fit()
    np.testing.assert_allclose(tout.detach().numpy(), jout, atol=1e-5)
    wj, wt = np.asarray(jacc()), tacc().numpy()
    assert wt.shape == wj.shape == (pt.n_leaves,)
    np.testing.assert_allclose(wt, wj, atol=WEIGHT_ATOL)
    np.testing.assert_allclose(tacc.value.numpy(), np.asarray(jacc.value), atol=WEIGHT_ATOL)
    assert wt.sum() > 0
    if not fast:  # every weight is counted once: sum = total alpha
        np.testing.assert_allclose(wt.sum(), tout[:, -1].sum().item(), rtol=1e-4)
    # Unlocked again, and the colors still carry gradients.
    assert pt._weight_accum is None and not pt._lock_tree_structure
    G = _gmat(rng, 4)
    (g,) = torch.autograd.grad((tout * _t(G)).sum(), f)
    gj = jax.grad(lambda x: jnp.sum(jr(x, rays, fast=fast) * G))(jnp.asarray(feats))
    _assert_grad_close(g.numpy(), np.asarray(gj))


def test_volume_render_with_weight_accum_matches_jax():
    rng, jt, pt, feats, rays, _ = _scene(57, "RGBA", 4)
    opt_j = st.VolumeRenderer(jt, backend="tree")._get_options(True)
    opt_t = stt.VolumeRenderer(pt, backend="tree")._get_options(True)
    jout, jw = jrender.volume_render_with_weight_accum(jt._spec(), jnp.asarray(feats), *rays, opt_j)
    tout, tw = trender.volume_render_with_weight_accum(pt._spec(), _t(feats), *(_t(r) for r in rays), opt_t)
    assert tw.shape == (pt._spec().child_flat.numel(),) and not tw.requires_grad
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=WEIGHT_ATOL)
    np.testing.assert_array_equal(
        trender.volume_render_with_weight_accum_plain(pt._spec(), _t(feats), *(_t(r) for r in rays), opt_t)[1].numpy(),
        tw.numpy())


def test_query_values_and_grads_match_jax_with_duplicates():
    rng, jt, pt, feats, _, centers = _scene(58, "SH1", 4)
    f = feats[: int(len(feats) * 0.7)]  # rows past M read as empty
    # Every leaf centre, some twice, and points that share a leaf.
    pts = np.concatenate([centers, centers[:9], centers[3:6] + 1e-4,
                          rng.rand(40, 3).astype(np.float32)]).astype(np.float32)
    G = rng.randn(len(pts), 4).astype(np.float32)
    (jv, jn, jd) = jt(jnp.asarray(f), jnp.asarray(pts), want_node_ids=True, want_data_ids=True)
    gj = jax.grad(lambda x: jnp.sum(jt(x, jnp.asarray(pts)) * G))(jnp.asarray(f))
    x = _t(f).requires_grad_()
    tv, tn, td = pt(x, pts, want_node_ids=True, want_data_ids=True)
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    (gt,) = torch.autograd.grad((tv * _t(G)).sum(), x)
    _assert_grad_close(gt.numpy(), np.asarray(gj))
    rows = np.asarray(jd)
    assert np.bincount(rows[rows < len(f)]).max() >= 3  # duplicates summed
    # The distinct hit leaves of the duplicated cloud, as the JAX package lists them.
    _, jl = jt(jnp.asarray(f), jnp.asarray(pts), want_leaf_node=True)
    _, tl = pt(x, pts, want_leaf_node=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert len(tl) < len(pts)


def test_captured_spec_survives_construct_tree():
    """The backward uses the spec captured at forward time, as JAX's
    residuals do: re-pointing the tree in between changes nothing."""
    rng, jt, pt, feats, rays, centers = _scene(59, "SH4", 13)
    G = _t(_gmat(rng, 4))
    r = stt.VolumeRenderer(pt, backend="tree")
    f = _t(feats).requires_grad_()
    (want,) = torch.autograd.grad((r(f, _trays(rays)) * G).sum(), f)
    qpts = centers[::2].copy()
    Gq = torch.randn(len(qpts), 13, generator=torch.Generator().manual_seed(59))
    (want_q,) = torch.autograd.grad((pt(f, qpts) * Gq).sum(), f)
    out = r(f, _trays(rays))
    qv = pt(f, qpts)
    before = pt._spec().data_flat.clone()
    pt.construct_tree(centers[rng.permutation(len(centers))])
    assert not torch.equal(before, pt._spec().data_flat)
    (got,) = torch.autograd.grad((out * G).sum(), f)
    (got_q,) = torch.autograd.grad((qv * Gq).sum(), f)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got_q.numpy(), want_q.numpy())
    (moved,) = torch.autograd.grad((r(f, _trays(rays)) * G).sum(), f)
    assert np.abs(moved.numpy() - want.numpy()).max() > 1e-3


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
def test_gradcheck_plain_float64(fmt, ddim):
    """Finite differences in float64 through the plain versions: the
    exact-mode backward is the derivative of the forward (as
    tests/test_render.py checks the JAX VJP)."""
    rng = np.random.RandomState(60 + ddim)
    jt, feats, centers = build_tree(rng, data_format=fmt, data_dim=ddim,
                                    n_random_refines=1, sigma_scale=5.0)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    rays = _trays(make_rays(rng, 24))
    f64 = torch.from_numpy(np.array(feats, np.float64)).requires_grad_()
    r = stt.VolumeRenderer(pt, backend="tree")
    torch.manual_seed(60 + ddim)  # fast_mode's random projections
    assert torch.autograd.gradcheck(lambda f: r(f, rays), (f64,), eps=1e-6,
                                    atol=1e-6, rtol=1e-4, fast_mode=True)
    assert torch.autograd.gradcheck(lambda f: pt(f, np.array(centers[::3])), (f64,), eps=1e-6,
                                    atol=1e-6, rtol=1e-4, fast_mode=True)
