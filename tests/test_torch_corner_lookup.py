"""The forward march's trilinear corner lookups (K2+K4, `csrc/common.cuh`
`corners_keep`) through their plain mirror `ops/corner_lookup.py` (CPU):

  * lever 1: the corner of `interp_corners` that `own_corner` names lies in
    the sample's own leaf, so its row is the own lookup's, on both
    structures, for N = 2, 3 and 4, with samples on and just outside the
    cube's faces and on cell boundaries;
  * lever 2, on the tree walk: the path-reusing descent (the own path's
    node of the first level whose digits part, the fraction there computed
    at once) gives the root descent's leaves for N = 2 and 4; N = 3
    descends from the root; a bake takes lever 1 alone.

The corners themselves are held to the JAX package's `_interp_corners`
(exact rows) for N = 2 and 4; for N = 3, XLA on the CPU contracts ``p *
cube_sz - 0.5`` (ROADMAP.md §3), so the port's own corners are the
reference there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu.ops import render as jrender
from svox_t_tpu_torch.ops import corner_lookup as cl
from svox_t_tpu_torch.ops import render as trender

from helpers import build_tree

N_POINTS = 3000


@functools.lru_cache(maxsize=None)
def _scene(N, seed=5):
    """A JAX tree of irregular depth with a part of it empty, and the port's
    copy of it (each baked once, on first use)."""
    rng = np.random.RandomState(seed)
    jt, _, _ = build_tree(rng, N=N, data_format="RGBA", data_dim=4, depth_limit={2: 4, 3: 3, 4: 2}[N],
                          n_random_refines=2, occupy=lambda c: c[:, 0] < 0.6)
    return jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu")


def _points(N, depth_limit):
    """Seeded samples in the cube, on its faces, just outside them (by
    rounding, as a march's last sample can be), and on the cell boundaries
    of every resolution the tree holds."""
    rng = np.random.RandomState(N)
    p = rng.rand(N_POINTS, 3).astype(np.float32)
    faces = np.array([0.0, 1.0, 0.999999, -1e-7, 1.0 + 1e-7], np.float32)
    q = N_POINTS // 4
    p[:q, 0] = faces[rng.randint(0, len(faces), q)]
    p[q:2 * q, 1] = faces[rng.randint(0, len(faces), q)]
    p[2 * q:3 * q, 2] = faces[rng.randint(0, len(faces), q)]
    cs = np.float32(N) ** rng.randint(1, depth_limit + 2, N_POINTS - 3 * q)
    p[3 * q:, rng.randint(0, 3)] = (rng.randint(0, 1 << 20, N_POINTS - 3 * q) % cs) / cs
    return torch.from_numpy(p)


def _spec(tree, structure):
    return tree._spec() if structure == "tree" else tree._baked_spec()


@pytest.mark.parametrize("N", [2, 3, 4])
@pytest.mark.parametrize("structure", ["tree", "baked"])
def test_own_corner_is_the_own_leaf(N, structure):
    """Lever 1: every sample has an own corner, and its row from
    `interp_corners` is the own leaf's, bit for bit."""
    jt, pt = _scene(N)
    spec = _spec(pt, structure)
    pos = _points(N, jt.depth_limit)
    leaf = trender._locate(spec, pos)
    rows, _ = trender.interp_corners(spec, pos, leaf.cube_sz)
    n = cl.own_corner(pos, leaf.cube_sz, cl.own_cell(spec, pos))
    assert bool((n >= 0).all())
    assert torch.equal(rows[n, torch.arange(pos.shape[0])], leaf.data_idx)
    # Not always the same corner: each axis takes both.
    assert len(set(n.tolist())) == 8


@pytest.mark.parametrize("N", [2, 3, 4])
@pytest.mark.parametrize("structure", ["tree", "baked"])
def test_reusing_lookups_give_the_root_lookups(N, structure):
    """Lever 2: the mirror's corner rows equal `interp_corners`' (its
    reusing lookups are checked against the root lookups inside), with
    fewer table loads; N = 3 on the tree walk descends from the root, and a
    bake looks each other corner up from the root (only lever 1 saves loads
    there). Each sample makes its own lookup and at most 7 more: exactly 7
    on a bake, fewer on the tree walk where a clamped corner lies in the
    own cell."""
    jt, pt = _scene(N)
    spec = _spec(pt, structure)
    pos = _points(N, jt.depth_limit)
    leaf = trender._locate(spec, pos)
    rows, _ = trender.interp_corners(spec, pos, leaf.cube_sz)
    got = cl.corner_lookups(spec, pos, leaf.cube_sz)
    assert torch.equal(got.rows.to(rows.dtype), rows)
    assert bool((got.loads <= got.loads_own).all()) and bool((got.loads_own < got.loads_root).all())
    assert bool((got.lookups >= 1).all()) and bool((got.lookups <= 8).all())
    if structure == "baked" or N == 3:
        assert torch.equal(got.loads, got.loads_own)
    else:
        assert int(got.loads.sum()) < int(got.loads_own.sum())
    if structure == "baked":
        assert bool((got.lookups == 8).all())


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("structure", ["tree", "baked"])
def test_corners_match_jax(N, structure):
    """The corners the levers reproduce are the JAX package's: the rows of
    `_interp_corners` at the same samples and leaves, exactly."""
    jt, pt = _scene(N)
    spec = _spec(pt, structure)
    pos = _points(N, jt.depth_limit)
    leaf = trender._locate(spec, pos)
    jspec = jt._spec() if structure == "tree" else jt._baked_spec()
    p = jnp.asarray(pos.numpy())
    want = jrender._interp_corners(jspec, p[:, 0], p[:, 1], p[:, 2], jnp.asarray(leaf.cube_sz.numpy()))
    got = cl.corner_lookups(spec, pos, leaf.cube_sz).rows
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(r) for r, _ in want]))
