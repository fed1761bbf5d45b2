"""svox_t_tpu_torch basis and traversal functions against the JAX package.

The same NumPy inputs go through `svox_t_tpu` (on the CPU) and its
PyTorch counterpart. Basis values agree to atol 1e-6 (both evaluate the
same float32 expressions in the same association order; the dot
products of SG/ASG may sum in another order). The descent is integer
control flow over basic float32 operations and must agree exactly, in
leaf ids and data rows; fractions to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import sh as jsh
from svox_t_tpu.ops import traversal as jtr
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import sh as tsh
from svox_t_tpu_torch.ops import traversal as ttr

from helpers import build_tree


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return stt.tree_from_numpy(stt.tree_state(tree), device="cpu")


def _unit_dirs(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_bases_matches_jax(deg):
    rng = np.random.RandomState(deg)
    dirs = _unit_dirs(rng, 257)
    want = _np(jsh.eval_sh_bases(deg, jnp.asarray(dirs)))
    got = tsh.eval_sh_bases(deg, _t(dirs)).numpy()
    assert got.shape == want.shape == (257, (deg + 1) ** 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_eval_sh_matches_jax():
    rng = np.random.RandomState(7)
    dirs = _unit_dirs(rng, 64)
    coeffs = rng.randn(64, 3, 9).astype(np.float32)
    want = _np(jsh.eval_sh(2, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = tsh.eval_sh(2, _t(coeffs), _t(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fmt,width", [(st.utils.spec.FORMAT_SG, 4),
                                       (st.utils.spec.FORMAT_ASG, 11)])
def test_eval_basis_sg_asg_matches_jax(fmt, width):
    rng = np.random.RandomState(fmt)
    basis_dim = 6
    # Unit lobe axes and non-negative sharpness, as fitted SG/ASG lobes
    # have: basis values stay in [-1, 1].
    extra = rng.randn(basis_dim, width).astype(np.float32)
    extra[:, :2] = np.abs(extra[:, :2]) * 3
    for a in range(1 if width == 4 else 2, width, 3):
        extra[:, a:a + 3] /= np.linalg.norm(extra[:, a:a + 3], axis=1, keepdims=True)
    dirs = _unit_dirs(rng, 128)
    want = _np(jsh.eval_basis(fmt, basis_dim, jnp.asarray(dirs), jnp.asarray(extra)))
    got = tsh.eval_basis(fmt, basis_dim, _t(dirs), _t(extra)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _boundary_points(rng, N, depth, n_random=400):
    """Random points plus points exactly on cell boundaries of every level
    (and on the cube's faces), where the descent's floor/clamp decide."""
    grid = np.concatenate([np.arange(N ** d + 1) / N ** d for d in range(1, depth + 2)])
    grid = np.unique(grid.astype(np.float32))
    pick = rng.choice(grid, size=(n_random, 3))
    edge = np.stack(np.meshgrid(grid[:6], grid[-6:], grid[::7], indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([rng.rand(n_random, 3), pick, edge, [[1.0, 1.0, 1.0], [0, 0, 0]]])
    return pts.astype(np.float32)


@pytest.mark.parametrize("N", [2, 3])
def test_descend_matches_jax(N):
    rng = np.random.RandomState(10 + N)
    tree, _, _ = build_tree(rng, N=N, depth_limit=4 if N == 2 else 3)
    port = _port(tree)
    pts = _boundary_points(rng, N, tree.max_depth)
    want = jtr.descend(tree._spec(), jnp.asarray(pts))
    got = ttr.descend(port._spec(), _t(pts))
    np.testing.assert_array_equal(got.data_idx.numpy(), _np(want.data_idx))
    np.testing.assert_array_equal(got.node_flat.numpy(), _np(want.node_flat))
    np.testing.assert_array_equal(got.cube_sz.numpy(), _np(want.cube_sz))
    np.testing.assert_allclose(got.frac.numpy(), _np(want.frac), atol=1e-6)
    assert len(np.unique(got.node_flat.numpy())) > 10


def test_clamp_world_transforms_match_jax():
    rng = np.random.RandomState(3)
    pos = (rng.rand(50, 3) * 3 - 1).astype(np.float32)
    off = rng.rand(3).astype(np.float32)
    sc = (rng.rand(3) + 0.5).astype(np.float32)
    np.testing.assert_array_equal(ttr.clamp_coord(_t(pos)).numpy(), _np(jtr.clamp_coord(jnp.asarray(pos))))
    a = ttr.world2tree(_t(pos), _t(off), _t(sc)).numpy()
    np.testing.assert_array_equal(a, _np(jtr.world2tree(jnp.asarray(pos), jnp.asarray(off), jnp.asarray(sc))))
    b = ttr.tree2world(_t(a), _t(off), _t(sc)).numpy()
    np.testing.assert_allclose(b, _np(jtr.tree2world(jnp.asarray(a), jnp.asarray(off), jnp.asarray(sc))), atol=1e-6)
    np.testing.assert_allclose(b, pos, atol=1e-5)


def test_dda_unit_and_delta_scale_match_jax():
    rng = np.random.RandomState(4)
    cen = (rng.rand(100, 3) * 3 - 1).astype(np.float32)
    dirs = _unit_dirs(rng, 100)
    sc = np.array([1.0, 2.0, 0.5], np.float32)
    d_w, ds_w = jtr.get_delta_scale(jnp.asarray(sc), jnp.asarray(dirs))
    d_g, ds_g = ttr.get_delta_scale(_t(sc), _t(dirs))
    np.testing.assert_allclose(d_g.numpy(), _np(d_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ds_g.numpy(), _np(ds_w), rtol=1e-6)
    inv = 1.0 / (d_g.numpy() + 1e-9)
    want = jtr.dda_unit(jnp.asarray(cen), jnp.asarray(inv))
    got = ttr.dda_unit(_t(cen), _t(inv))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


@pytest.mark.parametrize("N", [2, 3])
def test_pack_unpack_index_match_jax(N):
    rng = np.random.RandomState(N)
    txyz = np.concatenate([rng.randint(0, 500, (64, 1)), rng.randint(0, N, (64, 3))], 1).astype(np.int32)
    flat = ttr.pack_index(_t(txyz), N)
    np.testing.assert_array_equal(flat.numpy(), _np(jtr.pack_index(jnp.asarray(txyz), N)))
    np.testing.assert_array_equal(ttr.unpack_index(flat, N).numpy(), txyz)
