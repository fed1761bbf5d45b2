"""svox_t_tpu_torch's trilinear interpolation (K4, ``interp=1``) against
the JAX package (CPU): the port's counterpart of
`tests/test_fuzz_parity.py` (seeds 101-103, truncated pools, backend x
interp x fast) with gradients, a constant pool, an N = 3 tree and the
renderer's ``interp`` argument. `tests/test_torch_interp_passes.py` holds
the rest (weights, rotations, SG, the box cull, the aux passes, the
renderer end to end).

Tolerances: outputs atol 1e-5 (the JAX march forms L per round and
interpolates the feature row before the basis sum; the port multiplies
per sample and weights each corner's basis sum, as its kernels do: the
sums are linear in the row, so the two agree to rounding); gradients
``1e-5 * max(1, max|g_jax|)``. Fast mode compares only the rays whose ray
setup agrees bit for bit between the packages (`test_torch_bake.py`
`_same_setup`). The port's two backends agree bit for bit in exact mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import traversal as ttrav

from helpers import build_tree, make_rays
from test_torch_bake import _same_setup, _trays

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _port(jt):
    return stt.tree_from_numpy(stt.tree_state(jt), device="cpu")


def _opts(jt, pt, fast=False, **kw):
    """The JAX renderer's and the port's options, with ``kw`` replaced."""
    jo = dataclasses.replace(st.VolumeRenderer(jt)._get_options(fast), **kw)
    to = dataclasses.replace(stt.VolumeRenderer(pt)._get_options(fast), **kw)
    return jo, to


def _render(spec, feats, rays, opt):
    return trender.volume_render(spec, _t(feats), *_trays(rays), opt)


# ---------------------------------------------------------------------------
# The counterpart of tests/test_fuzz_parity.py


def _partial_scene(seed):
    """`test_fuzz_parity._partial_scene`: a truncated pool leaves part of
    the tree empty, with a tight occupied box."""
    rng = np.random.RandomState(seed)
    fmt, ddim = [("RGBA", 4), ("SH4", 13)][seed % 2]
    t, feats, _ = build_tree(rng, data_format=fmt, data_dim=ddim,
                             n_random_refines=1 + seed % 3, sigma_scale=25.0)
    feats = np.asarray(feats)[: max(8, int(feats.shape[0] * 0.55))]
    return t, _port(t), feats, make_rays(rng, 64)


@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("interp", [0, 1])
@pytest.mark.parametrize("fast", [False, True])
def test_fuzz_outputs_match_jax(seed, interp, fast):
    """Both backends against the JAX package with box_advance off (exact
    mode: the port's tree walk and bake bit for bit, so the JAX tree walk
    serves both); the box-advanced fast render within 5e-3 of the other,
    as in the JAX fuzz."""
    jt, pt, feats, rays = _partial_scene(seed)
    jo, to = _opts(jt, pt, fast, interp=interp, box_advance=0)
    jargs = (jnp.asarray(feats), rays.origins, rays.dirs, rays.viewdirs, jo)
    got = {"tree": _render(pt._spec(), feats, rays, to).numpy(),
           "baked": _render(pt._baked_spec(), feats, rays, to).numpy()}
    want = {"tree": np.asarray(jrender.volume_render(jt._spec(), *jargs))}
    if fast:
        want["baked"] = np.asarray(jrender.volume_render(jt._baked_spec(), *jargs))
        keep = _same_setup(jt, rays)
        assert keep.sum() > 40
        ba = _render(pt._baked_spec(), feats, rays, dataclasses.replace(to, box_advance=1)).numpy()
        np.testing.assert_allclose(ba, got["tree"], atol=5e-3)
    else:
        want["baked"] = want["tree"]
        keep = np.ones(len(np.asarray(rays.origins)), bool)
        np.testing.assert_array_equal(got["baked"], got["tree"])
    for b in ("tree", "baked"):
        np.testing.assert_allclose(got[b][keep], want[b][keep], atol=ATOL, err_msg=b)
    assert got["tree"][:, -1].max() > 0.5


@pytest.mark.parametrize("seed", [101, 102])
@pytest.mark.parametrize("interp", [0, 1])
@pytest.mark.parametrize("backend", ["tree", "baked"])
def test_fuzz_gradients_match_jax(seed, interp, backend):
    jt, pt, feats, rays = _partial_scene(seed)
    jo, to = _opts(jt, pt, interp=interp)
    jspec, tspec = ((jt._spec(), pt._spec()) if backend == "tree"
                    else (jt._baked_spec(), pt._baked_spec()))
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jrender.volume_render(
        jspec, f, rays.origins, rays.dirs, rays.viewdirs, jo) ** 2))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (g_t,) = torch.autograd.grad((trender.volume_render(tspec, f, *_trays(rays), to) ** 2).sum(), f)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))
    assert np.abs(g_j).max() > 0


# ---------------------------------------------------------------------------
# Counterparts of the JAX package's interp tests


def test_constant_pool_equals_nearest():
    """`test_render.py::test_trilinear_constant_pool_equals_nearest`: with
    one row everywhere and every leaf occupied the weights sum to 1."""
    rng = np.random.RandomState(0)
    jt, feats, _ = build_tree(rng, n_random_refines=0)
    const = np.tile(np.array([[0.3, -0.2, 0.8, 12.0]], np.float32), (feats.shape[0], 1))
    rays = make_rays(rng, 24)
    pt = _port(jt)
    for backend in ("tree", "baked"):
        r = stt.VolumeRenderer(pt, backend=backend)
        near = r(_t(const), _trays(rays)).numpy()
        r.interp = 1
        tri = r(_t(const), _trays(rays)).numpy()
        np.testing.assert_allclose(tri, near, atol=2e-5)
    jo, to = _opts(jt, pt, interp=1)
    want = jrender.volume_render(jt._spec(), jnp.asarray(const), rays.origins, rays.dirs,
                                 rays.viewdirs, jo)
    np.testing.assert_allclose(tri, np.asarray(want), atol=ATOL)


def test_n3_tree_matches_jax():
    """N = 3: cube_sz is a power of 3, so ``p * cube_sz`` rounds, and XLA
    on the CPU contracts ``p * cube_sz - 0.5`` into one rounding where the
    port rounds twice (as its kernels, built with -fmad=false, do). On
    200,000 random points of this tree the corner rows agree and the
    weights differ by up to 1.6e-6; the outputs stay within tolerance, and
    the port's two backends agree bit for bit."""
    rng = np.random.RandomState(25)
    jt, feats, _ = build_tree(rng, N=3, data_format="SH4", data_dim=13, depth_limit=3,
                              n_random_refines=1, sigma_scale=20.0)
    feats = np.asarray(feats)[: int(feats.shape[0] * 0.7)]
    rays = make_rays(rng, 96)
    pt = _port(jt)
    pts = rng.rand(200000, 3).astype(np.float32)
    cube = ttrav.descend(pt._spec(), _t(pts)).cube_sz
    jspec = jt._spec()
    corners = jax.jit(lambda x, y, z, c: jrender._interp_corners(jspec, x, y, z, c))(
        *(jnp.asarray(pts[:, a]) for a in range(3)), jnp.asarray(cube.numpy()))
    rows, w = (a.numpy() for a in trender.interp_corners(pt._spec(), _t(pts), cube))
    np.testing.assert_array_equal(rows, np.stack([np.asarray(i) for i, _ in corners]))
    w_j = np.stack([np.asarray(x) for _, x in corners])
    np.testing.assert_allclose(w, w_j, atol=2e-6)
    assert (w != w_j).any()  # the rounding differs; with N = 2 it would not
    jo, to = _opts(jt, pt, interp=1)
    out_t = _render(pt._spec(), feats, rays, to).numpy()
    np.testing.assert_array_equal(_render(pt._baked_spec(), feats, rays, to).numpy(), out_t)
    want = jrender.volume_render(jt._spec(), jnp.asarray(feats), rays.origins, rays.dirs,
                                 rays.viewdirs, jo)
    np.testing.assert_allclose(out_t, np.asarray(want), atol=ATOL)
    g_j = np.asarray(jax.grad(lambda f: jnp.sum(jrender.volume_render(
        jt._spec(), f, rays.origins, rays.dirs, rays.viewdirs, jo) ** 2))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    (g_t,) = torch.autograd.grad((trender.volume_render(pt._spec(), f, *_trays(rays), to) ** 2).sum(), f)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))


# ---------------------------------------------------------------------------
# VolumeRenderer(interp="trilinear") end to end


def test_renderer_takes_trilinear():
    pt = stt.N3Tree(N=2, data_dim=4, depth_limit=3, device="cpu")
    assert stt.VolumeRenderer(pt, interp="trilinear").interp == 1
    assert stt.VolumeRenderer(pt, interp=1)._get_options().interp == 1
    assert stt.VolumeRenderer(pt)._get_options().interp == 0
    with pytest.raises(ValueError, match="interp"):
        stt.VolumeRenderer(pt, interp="cubic")
