"""svox_t_tpu_torch's N3Tree, construct_tree, query, builders and scenes
against the JAX package.

Structure edits are host NumPy in both packages and must give equal
buffers. `construct_tree` is compared on clouds with one point per leaf
(the JAX scatter leaves the winner among duplicates unspecified; the port
picks the largest point id, tested separately). `.npz` files move both
ways between the packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from benchmarks import scenes as jscenes
from svox_t_tpu.ops import query as jquery
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import query as tquery
from svox_t_tpu_torch.ops.traversal import descend
from svox_t_tpu_torch.utils import scenes as tscenes

from helpers import build_tree

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _port(tree):
    return stt.tree_from_numpy(stt.tree_state(tree), device="cpu")


def _leaf_centers(tree):
    """World-space centres of every leaf of a JAX tree, (L, 3)."""
    local = tree[:].corners_local + 0.5 * tree[:].lengths_local[:, None]
    return np.array(jax.device_get(tree.tree2world(jnp.asarray(local))), np.float32)


def _assert_same_structure(port, tree):
    np.testing.assert_array_equal(port.child, tree.child)
    np.testing.assert_array_equal(port.data, np.asarray(tree.data))
    np.testing.assert_array_equal(port.parent_depth, tree.parent_depth)
    assert port.n_internal == tree.n_internal
    assert port.filled == tree.filled
    assert port.capacity == tree.capacity
    assert port.n_leaves == tree.n_leaves
    assert port.max_depth == tree.max_depth


@pytest.mark.parametrize("N,init_refine", [(2, 0), (2, 1), (3, 0)])
def test_refine_buffers_match_jax(N, init_refine):
    kw = dict(N=N, data_dim=4, depth_limit=4, init_refine=init_refine,
              radius=[0.7, 0.5, 0.9], center=[0.1, 0.2, 0.3])
    jt, pt = st.N3Tree(**kw), stt.N3Tree(**kw, device="cpu")
    _assert_same_structure(pt, jt)
    assert jt.refine(repeats=2) == pt.refine(repeats=2)
    _assert_same_structure(pt, jt)
    rng = np.random.RandomState(N)
    leaves = jt._all_leaves()[np.sort(rng.choice(jt.n_leaves, 5, replace=False))]
    jt.refine(leaf_node=leaves)
    pt.refine(sel=tuple(leaves.T))
    _assert_same_structure(pt, jt)
    np.testing.assert_array_equal(pt.offset, jt.offset)
    np.testing.assert_array_equal(pt.invradius, jt.invradius)
    pts = (rng.rand(20, 3) * 2 - 0.5).astype(np.float32)
    np.testing.assert_allclose(pt.world2tree(pts).numpy(), np.asarray(jt.world2tree(pts)), atol=1e-6)
    np.testing.assert_allclose(pt.tree2world(pts).numpy(), np.asarray(jt.tree2world(pts)), atol=1e-6)


def test_tree_state_roundtrip_and_spec():
    rng = np.random.RandomState(0)
    jt, _, _ = build_tree(rng, data_format="SH4", data_dim=13)
    pt = _port(jt)
    _assert_same_structure(pt, jt)
    assert repr(pt.data_format) == "SH4" and pt.data_dim == 13
    again = stt.tree_from_numpy(stt.tree_state(pt), device="cpu")
    _assert_same_structure(again, jt)
    js, ps = jt._spec(), pt._spec()
    assert (ps.N, ps.n_levels, ps.n_internal) == (js.N, js.n_levels, js.n_internal)
    np.testing.assert_array_equal(ps.child_flat.numpy(), np.asarray(js.child_flat))
    np.testing.assert_array_equal(ps.data_flat.numpy(), np.asarray(js.data_flat))


@pytest.mark.parametrize("N", [2, 3])
def test_construct_tree_matches_jax(N):
    rng = np.random.RandomState(20 + N)
    jt, _, _ = build_tree(rng, N=N, depth_limit=4 if N == 2 else 3)
    pt = _port(jt)
    centers = _leaf_centers(jt)
    keep = rng.rand(len(centers)) < 0.7
    cloud = centers[keep][rng.permutation(int(keep.sum()))]
    want = np.asarray(jquery.construct_tree(jt._spec(), jnp.asarray(cloud)))
    got = tquery.construct_tree(pt._spec(), torch.from_numpy(cloud))
    np.testing.assert_array_equal(got.numpy(), want)
    # Through the tree's entry point, as the serving loop calls it.
    jt.construct_tree(cloud)
    pt.construct_tree(cloud)
    np.testing.assert_array_equal(pt.data, np.asarray(jt.data))
    np.testing.assert_array_equal(pt._spec().data_flat.numpy(), np.asarray(jt._spec().data_flat))


def test_construct_tree_duplicates_largest_id_wins():
    rng = np.random.RandomState(5)
    jt, _, _ = build_tree(rng)
    pt = _port(jt)
    centers = _leaf_centers(jt)
    cloud = np.concatenate([centers, centers[::-1], centers[:7]])
    got = tquery.construct_tree_plain(pt._spec(), torch.from_numpy(cloud)).numpy()
    L = len(centers)
    slots = descend(pt._spec(), torch.from_numpy(centers)).node_flat.numpy()
    # leaf i is hit by points i, 2L-1-i and (for i < 7) 2L+i
    expect = np.maximum(np.arange(L), 2 * L - 1 - np.arange(L))
    expect[:7] = 2 * L + np.arange(7)
    np.testing.assert_array_equal(got[slots], expect)


def test_construct_tree_cuda_rejects_cpu_tensors():
    """The kernel wrapper never runs its plain version in its place."""
    pt = _port(build_tree(np.random.RandomState(6))[0])
    with pytest.raises(ValueError, match="CUDA"):
        tquery.construct_tree_cuda(pt._spec(), torch.zeros(4, 3))


def test_query_matches_jax():
    rng = np.random.RandomState(8)
    jt, feats, _ = build_tree(rng, data_format="SH1", data_dim=4)
    pt = _port(jt)
    f = np.array(feats)[: int(len(feats) * 0.6)]  # rows past M read as empty
    pts = rng.rand(300, 3).astype(np.float32)
    jv, jn, jd = jquery.query(jt._spec(), jnp.asarray(f), jnp.asarray(pts), True)
    tv, tn, td = tquery.query(pt._spec(), torch.from_numpy(f), torch.from_numpy(pts))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("world", [True, False])
def test_query_grad_matches_jax(world):
    """The query's backward adds each point's value gradient into its
    row; rows past M and empty leaves take nothing."""
    rng = np.random.RandomState(13)
    jt, feats, _ = build_tree(rng, data_format="SH4", data_dim=13)
    pt = _port(jt)
    f = np.array(feats)[: int(len(feats) * 0.8)]
    centers = _leaf_centers(jt)
    local = np.array(jt.world2tree(centers)) if not world else centers
    pts = np.concatenate([local, local[::4], rng.rand(50, 3).astype(np.float32)]).astype(np.float32)
    G = rng.randn(len(pts), 13).astype(np.float32)
    gj = jax.grad(lambda x: jnp.sum(jquery.query(jt._spec(), x, jnp.asarray(pts), world)[0] * G))(
        jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_()
    vals = tquery.query(pt._spec(), x, torch.from_numpy(pts), world)[0]
    (gt,) = torch.autograd.grad((vals * torch.from_numpy(G)).sum(), x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(gj).max())))
    assert np.abs(np.asarray(gj)).max() > 0


def test_tree_forward_matches_jax():
    rng = np.random.RandomState(14)
    jt, feats, _ = build_tree(rng, data_format="SH1", data_dim=4)
    pt = _port(jt)
    pts = rng.rand(120, 3).astype(np.float32)
    f = np.array(feats)
    jv, jn, jd = jt(jnp.asarray(f), jnp.asarray(pts), want_node_ids=True, want_data_ids=True)
    tv, tn, td = pt(torch.from_numpy(f), pts, want_node_ids=True, want_data_ids=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    local = np.array(jt.world2tree(pts))
    np.testing.assert_array_equal(pt(torch.from_numpy(f), local, world=False).numpy(),
                                  np.asarray(jt(jnp.asarray(f), jnp.asarray(local), world=False)))
    assert pt.forward(torch.from_numpy(f), pts, want_node_ids=True)[1].dtype == torch.int32


def test_query_cuda_wrappers_reject_cpu_tensors():
    """The query kernel wrappers never run their plain versions in their
    place."""
    pt = _port(build_tree(np.random.RandomState(15))[0])
    with pytest.raises(ValueError, match="CUDA"):
        tquery.query_forward_cuda(pt._spec(), torch.zeros(5, 4), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tquery.query_backward_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 4), 5)


def test_save_port_load_jax(tmp_path):
    rng = np.random.RandomState(9)
    jt, feats, _ = build_tree(rng, data_format="SH1", data_dim=4)
    pt = _port(jt)
    pt.features = torch.from_numpy(np.array(feats))
    p = os.path.join(tmp_path, "port.npz")
    pt.save(p)
    back = st.N3Tree.load(p)
    _assert_same_structure(pt, back)
    np.testing.assert_array_equal(np.asarray(back.features), np.array(feats))
    assert repr(back.data_format) == "SH1"


def test_save_jax_load_port(tmp_path):
    rng = np.random.RandomState(10)
    jt, feats, _ = build_tree(rng, data_format="SH1", data_dim=4)
    jt.features = feats
    p = os.path.join(tmp_path, "jax.npz")
    jt.save(p)
    pt = stt.N3Tree.load(p, device="cpu")
    _assert_same_structure(pt, jt)
    np.testing.assert_array_equal(pt.features.numpy(), np.asarray(feats))
    np.testing.assert_array_equal(pt.invradius, jt.invradius)
    np.testing.assert_array_equal(pt.offset, jt.offset)


def test_load_reference_schema_fixture():
    path = os.path.join(FIX, "reference_schema.npz")
    jt, pt = st.N3Tree.load(path), stt.N3Tree.load(path, device="cpu")
    _assert_same_structure(pt, jt)
    assert str(pt.data_format) == "SH1" and pt.data_dim == 4 and pt.N == 2
    probe = np.load(os.path.join(FIX, "reference_schema_probe.npz"))
    f, c = probe["features"], probe["centers_local"].astype(np.float32)
    want = np.asarray(jt(jnp.asarray(f), jnp.asarray(c), world=False))
    got = tquery.query(pt._spec(), torch.from_numpy(f), torch.from_numpy(c), world=False)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_load_legacy_float_data(tmp_path):
    t = st.N3Tree(N=2, data_dim=4)
    raw = np.random.RandomState(11).rand(1, 2, 2, 2, 4).astype(np.float16)
    p = os.path.join(tmp_path, "legacy.npz")
    np.savez(p, data_dim=4, child=t.child, parent_depth=t.parent_depth,
             n_internal=1, invradius=1.0, offset=np.zeros(3, np.float32),
             depth_limit=4, geom_resize_fact=1.5, data=raw)
    jt, pt = st.N3Tree.load(p), stt.N3Tree.load(p, device="cpu")
    np.testing.assert_array_equal(pt.features.numpy(), np.asarray(jt.features))
    np.testing.assert_array_equal(pt.data, np.asarray(jt.data))
    np.testing.assert_array_equal(pt.data.ravel(), np.arange(8))


@pytest.mark.parametrize("depth,fmt,ddim", [(3, "RGBA", 4), (5, "SH9", 28)])
def test_scenes_match_benchmark_scenes(depth, fmt, ddim):
    jt, jf = jscenes.build_shell_tree(depth=depth, data_format=fmt, data_dim=ddim)
    state, feats, centers = tscenes.build_shell_tree(depth=depth, data_format=fmt, data_dim=ddim)
    np.testing.assert_array_equal(state["child"], jt.child)
    np.testing.assert_array_equal(state["data"], np.asarray(jt.data))
    np.testing.assert_array_equal(state["parent_depth"], jt.parent_depth)
    np.testing.assert_array_equal(state["offset"], jt.offset)
    np.testing.assert_array_equal(state["invradius"], jt.invradius)
    assert state["n_internal"] == jt.n_internal and state["depth_limit"] == jt.depth_limit
    np.testing.assert_array_equal(feats, np.asarray(jf))
    # centers[i] is the centre of the leaf pointing at row i
    pt = stt.tree_from_numpy(state, device="cpu")
    rows = descend(pt._spec(), torch.from_numpy(centers)).data_idx.numpy()
    np.testing.assert_array_equal(rows, np.arange(len(centers)))
    _, jof = jscenes.build_opaque_tree(depth=3)
    _, of, _ = tscenes.build_opaque_tree(depth=3)
    np.testing.assert_array_equal(of, np.asarray(jof))
    np.testing.assert_array_equal(tscenes.orbit_camera(0.3, 0.2, 2.0), jscenes.orbit_camera(0.3, 0.2, 2.0))


def test_tree_from_occupancy_matches_jax():
    rng = np.random.RandomState(12)
    occ = rng.rand(8, 8, 8) < 0.1
    jt, jn = st.tree_from_occupancy(occ, data_dim=13, data_format="SH4", radius=0.8)
    pt, pn = stt.tree_from_occupancy(occ, data_dim=13, data_format="SH4", radius=0.8,
                                     device="cpu")
    assert jn == pn
    _assert_same_structure(pt, jt)
    np.testing.assert_array_equal(pt.invradius, jt.invradius)


@pytest.mark.parametrize("entry", ["N3Tree", "load", "tree_from_occupancy", "tree_from_numpy"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Trees land on CUDA unless the caller names a device: without a card
    the default raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py checks the default there")
    path = str(tmp_path / "t.npz")
    stt.N3Tree(N=2, data_dim=4, depth_limit=2, device="cpu").save(path)
    state = stt.tree_state(stt.N3Tree(N=2, data_dim=4, depth_limit=2, device="cpu"))
    occ = np.zeros((4, 4, 4), bool)
    occ[1, 2, 3] = True
    make = {
        "N3Tree": lambda: stt.N3Tree(N=2, data_dim=4, depth_limit=2),
        "load": lambda: stt.N3Tree.load(path),
        "tree_from_occupancy": lambda: stt.tree_from_occupancy(occ),
        "tree_from_numpy": lambda: stt.tree_from_numpy(state),
    }[entry]
    with pytest.raises((AssertionError, RuntimeError)):
        make()
