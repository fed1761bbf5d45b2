"""The first-hit march's path-started lookups (K9b's ``path`` design,
`tools/first_hit_designs.cuh` `lookup_next`) through their plain mirror
`ops/first_hit_path.py`, and its census (CPU):

  * the descent of a ray's next sample started on the previous sample's
    path (the node of the first level whose digits part, the fraction there
    computed at once; a point in the previous leaf takes it with no load)
    gives the root descent's leaf, cube size and fraction bit for bit, for
    N = 2 and 4, on seeded rays marched through small irregular trees;
  * N = 3 descends from the root;
  * the census's march is the plain first hit's, and K9b's plain version
    still matches the JAX package's `_first_hit` on the scene of
    tests/test_torch_aux.py (found and rows exactly, t_hit within 1e-5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu.ops import render_aux as jaux
from svox_t_tpu_torch.ops import first_hit_path as fhp
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import render_aux as taux
from svox_t_tpu_torch.ops.traversal import descend

from helpers import build_tree, make_rays

ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _scene(N):
    """A small irregular tree with part of it empty (the port's copy), its
    pool with densities on 40% of the rows, and seeded rays, some starting
    inside the cube."""
    rng = np.random.RandomState(20 + N)
    jt, feats, _ = build_tree(rng, N=N, data_format="RGBA", data_dim=4, depth_limit={2: 5, 3: 3, 4: 3}[N],
                              sigma_scale=20.0, occupy=lambda c: c[:, 0] < 0.7)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    feats = torch.from_numpy(np.array(feats))
    feats[torch.from_numpy(rng.rand(feats.shape[0]) < 0.6), -1] = 0.0
    rays = make_rays(rng, B=300)
    o = torch.from_numpy(np.array(rays.origins))
    d = torch.from_numpy(np.array(rays.dirs))
    o[:30] = torch.from_numpy(rng.rand(30, 3).astype(np.float32))
    return jt, pt, feats, o, d


def _march_points(spec, o, d, steps, step_size=1e-3):
    """Every ray's samples, step by step, under the march's rules: (B, 3)
    tree-space points per step and the mask of rays still marching."""
    opt = stt.RenderOptions(step_size=step_size)
    o_, d_, invdir, _, tmin, tmax, hit = trender._ray_setup(spec, o, d, opt)
    t, active = tmin, hit.clone()
    for _ in range(steps):
        if not bool(active.any()):
            return
        pos = trender.sample_position(o_, t, d_)
        yield pos, active
        leaf = descend(spec, pos)
        t = torch.where(active, t + trender._step(leaf, invdir, step_size, 0), t)
        active = active & (t < tmax)


@pytest.mark.parametrize("N", [2, 4])
def test_path_started_descent_equals_root(N):
    """Each sample's path-started descent equals the root's bit for bit
    (`path_lookup` raises otherwise; checked here again), and no sample
    loads more than the root descent, most of them less."""
    _, pt, _, o, d = _scene(N)
    spec = pt._spec()
    state, n_path, n_root, n = None, 0, 0, 0
    for pos, active in _march_points(spec, o, d, 400):
        leaf, loads, new = fhp.path_lookup(spec, pos, state)
        root = descend(spec, pos)
        assert torch.equal(leaf.node_flat, root.node_flat)
        assert torch.equal(leaf.data_idx, root.data_idx)
        assert torch.equal(leaf.cube_sz, root.cube_sz)
        assert torch.equal(leaf.frac, root.frac)
        root_loads = fhp._root_loads(spec, pos)[0]
        if state is not None:
            n_path += int(loads[active].sum())
            n_root += int(root_loads[active].sum())
            n += int(active.sum())
            assert bool((loads <= root_loads).all())
            new = fhp.PathState(*(torch.where(active.view(-1, *([1] * (a.ndim - 1))), a, b)
                                  for a, b in zip(new, state)))
        state = new
    assert n > 1000
    assert n_path < 0.8 * n_root


def test_n3_descends_from_the_root():
    """For N = 3 every lookup takes the root descent's loads."""
    _, pt, _, o, d = _scene(3)
    spec = pt._spec()
    state, n = None, 0
    for pos, active in _march_points(spec, o, d, 200):
        leaf, loads, state = fhp.path_lookup(spec, pos, state)
        assert torch.equal(loads, fhp._root_loads(spec, pos)[0])
        assert torch.equal(leaf.frac, descend(spec, pos).frac)
        n += int(active.sum())
    assert n > 1000


@pytest.mark.parametrize("N", [2, 3, 4])
@pytest.mark.parametrize("structure", ["tree", "baked"])
@pytest.mark.parametrize("interp", [False, True])
def test_census_counts(N, structure, interp):
    """The census marches as the plain first hit (it checks its hits
    itself); on the tree walk the path-started loads are fewer for N a
    power of two and equal for N = 3; on a bake the trail saves a load for
    each sample in its previous sample's top or mid cell (the N = 4 bake has
    bricks under its top grid, so some do); under interp corners_keep makes
    fewer lookups than 9 a sample."""
    _, pt, feats, o, d = _scene(N)
    spec = pt._spec() if structure == "tree" else pt._baked_spec()
    opt = stt.VolumeRenderer(pt, interp="trilinear" if interp else "nearest")._get_options()
    c = fhp.first_hit_census(spec, feats, o, d, opt)
    assert c["samples"] > 300 and c["found"] > 0
    if structure == "tree":
        assert (c["path_loads"] < c["root_loads"]) if N != 3 else (c["path_loads"] == c["root_loads"])
    else:
        assert c["trail_loads"] == c["root_loads"] - c["same_top"] - c["same_mid"]
        assert c["same_top"] > 0 or N != 4
    if interp:
        assert c["lookups_keep"] < c["lookups_9"] == 9 * c["samples"]
        assert c["loads_keep"] < c["loads_9"]


@pytest.mark.parametrize("sigma_thresh", [0.0, 5.0])
def test_first_hit_plain_matches_jax(sigma_thresh):
    """K9b's plain version against the JAX package's `_first_hit` on the
    scene of tests/test_torch_aux.py (depth 5, RGBA): found and rows
    exactly, t_hit within 1e-5."""
    rng = np.random.RandomState(9)
    joints = rng.rand(5, 3).astype(np.float32)
    jt, feats, _ = build_tree(rng, data_format="RGBA", data_dim=4, depth_limit=5, sigma_scale=20.0,
                              extra_data=joints)
    rays = make_rays(rng, 160)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    jr = __import__("svox_t_tpu").VolumeRenderer(jt, backend="tree")
    jr.sigma_thresh = sigma_thresh
    tr = stt.VolumeRenderer(pt, backend="tree")
    tr.sigma_thresh = sigma_thresh
    found_j, t_j, _, idx_j, _ = jaux._first_hit(jt._spec(), jnp.asarray(feats), rays.origins, rays.dirs,
                                                 jr._get_options())
    found, t_hit, row, _ = taux.first_hit_plain(pt._spec(), torch.from_numpy(np.array(feats)),
                                                torch.from_numpy(np.array(rays.origins)),
                                                torch.from_numpy(np.array(rays.dirs)), tr._get_options())
    found_j = np.asarray(found_j)
    np.testing.assert_array_equal(found.numpy(), found_j)
    np.testing.assert_array_equal(row.numpy()[found_j], np.asarray(idx_j)[found_j])
    np.testing.assert_allclose(t_hit.numpy()[found_j], np.asarray(t_j)[found_j], atol=ATOL)
    assert found_j.mean() > 0.3
