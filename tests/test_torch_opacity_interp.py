"""K9a+K4, the opacity VJP under trilinear interpolation, on the CPU: its
corners come from the sample's own lookup (`csrc/render_bwd.cuh`
`opacity_march`, `svox::corners_keep`), which the plain mirror
`ops/corner_lookup.py` reproduces.

  * the mirror on K9a's own samples (the backward march's rule: every
    sample while t < tmax, up to max_steps, exact and fast options) gives
    `interp_corners`' rows bit for bit, on both structures, N = 2 and 3
    (`tests/test_torch_corner_lookup.py` holds N = 4 on seeded points);
  * the opacity render and its gradient against the JAX package on both
    structures, N = 2 and 3, exact (single pass) and fast (two passes).
    Tolerances as `tests/test_torch_interp.py`'s (N = 3: XLA on the CPU
    contracts ``p * cube_sz - 0.5``, so weights differ in the last ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svox_t_tpu.ops import render_aux as jaux
from svox_t_tpu_torch.ops import corner_lookup as cl
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import render_aux as taux

from helpers import build_tree, make_rays
from test_torch_bake import _trays
from test_torch_interp import ATOL, _gtol, _opts, _port, _t


def _scene(N, seed):
    """A tree of irregular depth with a part of it empty, its port, the
    pool and seeded rays."""
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, N=N, data_format="SH4", data_dim=13, depth_limit={2: 5, 3: 3}[N],
                              n_random_refines=2, sigma_scale=20.0, occupy=lambda c: c[:, 0] < 0.6)
    return jt, _port(jt), np.asarray(feats), make_rays(rng, 256)


def _march_samples(spec, opt, rays):
    """(pos (S, 3), cube_sz (S,)) of every sample K9a's march takes on the
    rays (`render_aux._opacity_march_plain`'s loop)."""
    o, d = _trays(rays)[:2]
    setup = trender._ray_setup(spec, o, d, opt)
    o_t, d_t, _, _, tmin, tmax, hit = setup
    t = tmin
    pos, cube = [], []
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        leaf, dt = trender._sample_leaf(spec, opt, setup, t)
        pos.append(trender.sample_position(o_t, t, d_t)[active])
        cube.append(leaf.cube_sz[active])
        t = torch.where(active, t + dt, t)
    return torch.cat(pos), torch.cat(cube)


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("structure", ["tree", "baked"])
@pytest.mark.parametrize("fast", [False, True])
def test_corner_mirror_on_opacity_samples(N, structure, fast):
    jt, pt, _, rays = _scene(N, 40 + N)
    spec = pt._spec() if structure == "tree" else pt._baked_spec()
    _, to = _opts(jt, pt, fast=fast, interp=1)
    pos, cube = _march_samples(spec, to, rays)
    assert pos.shape[0] > 1000, pos.shape
    rows, _ = trender.interp_corners(spec, pos, cube)
    got = cl.corner_lookups(spec, pos, cube)
    assert torch.equal(got.rows.to(rows.dtype), rows)
    assert bool((got.loads <= got.loads_root).all())
    if N != 3 or structure == "baked":
        assert int(got.loads.sum()) < int(got.loads_root.sum())


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_opacity_interp_matches_jax(N, fast):
    jt, pt, feats, rays = _scene(N, 50 + N)
    jo, to = _opts(jt, pt, fast=fast, interp=1)
    G = np.random.RandomState(N).randn(rays.origins.shape[0], 1).astype(np.float32)
    a_j, back = jax.vjp(lambda f: jaux.opacity_render(jt._baked_spec(), f, rays.origins, rays.dirs, jo),
                        jnp.asarray(feats))
    g_j = np.asarray(back(jnp.asarray(G))[0])
    assert np.abs(g_j).max() > 0
    o, d = _trays(rays)[:2]
    for spec in (pt._spec(), pt._baked_spec()):
        f = _t(feats).requires_grad_()
        alpha = taux.opacity_render(spec, f, o, d, to)
        (g_t,) = torch.autograd.grad((alpha * _t(G)).sum(), f)
        np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(a_j), atol=ATOL)
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=_gtol(g_j))
        assert not bool(g_t[:, :-1].any())
