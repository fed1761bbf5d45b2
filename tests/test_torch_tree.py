"""svox_t_tpu_torch's N3Tree, construct_tree, query, builders and scenes
against the JAX package.

Structure edits are host NumPy in both packages and must give equal
buffers. `construct_tree` is compared on clouds with one point per leaf
(the JAX scatter leaves the winner among duplicates unspecified; the port
picks the largest point id, tested separately). `.npz` files move both
ways between the packages.

The editing half of the tree (set, snap, merge + shrink_to_fit, the
frontier reductions and their gradients, partial/clone, _refine_at) is
applied in both packages to trees carried across with `tree_state`:
structure arrays exact, pools after a merge's mean to 1e-6 relative (the
JAX package divides in float64, the port in float32), gradients to
``1e-5 * max(1, max|g_jax|)``, corners at N 3 to 2 ulp
(tests/test_torch_view.py says why). `map_location` is an alias of
`device` (fault F1 of the port).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.models.tree import WeightAccumulator as JaxWeightAccumulator
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


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("cloud_kind", ["leaves", "outside", "shared"])
def test_construct_tree_aabb_matches_jax(N, cloud_kind):
    """The fused re-point's plain version: its table equal to the JAX
    package's construct_tree and its box to JAX's points_leaf_aabb joined
    with the union by min / max, exactly, with no union, a box and an empty
    one (lo > hi); on leaf centres in a random order, on points outside the
    cube (clamped) among them, and on points that share leaves (where JAX
    leaves the winner unspecified, the shared slots hold the largest id, as
    construct_tree's)."""
    rng = np.random.RandomState(40 + N)
    jt, _, _ = build_tree(rng, N=N, depth_limit=4 if N == 2 else 3)
    pt = _port(jt)
    centers = _leaf_centers(jt)
    cloud = centers[rng.permutation(len(centers))][: len(centers) // 2]
    if cloud_kind == "outside":
        cloud = np.concatenate([cloud, (rng.rand(40, 3) * 3 - 1).astype(np.float32)])
    elif cloud_kind == "shared":
        cloud = np.concatenate([cloud, cloud[:9], cloud[3:5]])
    jtable = np.asarray(jquery.construct_tree(jt._spec(), jnp.asarray(cloud)))
    jbox = [np.asarray(x) for x in jquery.points_leaf_aabb(jt._spec(), jnp.asarray(cloud))]
    spec, pts = pt._spec(), torch.from_numpy(cloud)
    slots = descend(spec, spec.offset + spec.scaling * pts).node_flat.numpy()
    leaves, hits = np.unique(slots, return_counts=True)
    once = ~np.isin(np.arange(spec.data_flat.numel()), leaves[hits > 1])
    assert cloud_kind != "shared" or not once.all()
    for u in (None, (np.full(3, 0.3, np.float32), np.full(3, 0.6, np.float32)),
              (np.ones(3, np.float32), np.zeros(3, np.float32))):
        jlo, jhi = jbox if u is None else (np.minimum(jbox[0], u[0]), np.maximum(jbox[1], u[1]))
        tu = None if u is None else tuple(torch.from_numpy(x) for x in u)
        for fn in (tquery.construct_tree_aabb, tquery.construct_tree_aabb_plain):
            table, lo, hi = fn(spec, pts, tu)
            np.testing.assert_array_equal(lo.numpy(), jlo)
            np.testing.assert_array_equal(hi.numpy(), jhi)
            np.testing.assert_array_equal(table.numpy()[once], jtable[once])
            np.testing.assert_array_equal(table.numpy(), tquery.construct_tree_plain(spec, pts).numpy())
            if cloud_kind == "shared":
                np.testing.assert_array_equal(table.numpy()[slots[-2:]], [len(cloud) - 2, len(cloud) - 1])


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



def _pair(rng, **kw):
    """A JAX tree with its pool, the port's copy on the CPU with the same
    pool, and the leaf centres (world space)."""
    jt, feats, centers = build_tree(rng, **kw)
    jt.features = feats
    pt = _port(jt)
    pt.features = torch.from_numpy(np.array(feats))
    return jt, pt, centers


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def _assert_same_tree(pt, jt):
    """Equal structure arrays, counts, leaves and frontier."""
    np.testing.assert_array_equal(pt.child, jt.child)
    np.testing.assert_array_equal(pt.data, np.asarray(jt.data))
    np.testing.assert_array_equal(pt.parent_depth, jt.parent_depth)
    assert (pt.n_internal, pt._n_free, pt.filled, pt.capacity) == \
        (jt.n_internal, jt._n_free, jt.filled, jt.capacity)
    np.testing.assert_array_equal(pt._all_leaves(), jt._all_leaves())
    np.testing.assert_array_equal(pt._frontier, jt._frontier)

# ---------------------------------------------------------------------
# N3Tree entry points


def test_forward_want_leaf_node_matches_jax():
    rng = np.random.RandomState(44)
    jt, pt, centers = _pair(rng, N=3, depth_limit=3)
    pts = np.concatenate([centers[::3], centers[::5], rng.rand(25, 3).astype(np.float32)])
    jv, jn, jd, jl = jt(jt.features, jnp.asarray(pts), want_node_ids=True, want_data_ids=True,
                        want_leaf_node=True)
    tv, tn, td, tl = pt(pt.features, pts, want_node_ids=True, want_data_ids=True,
                        want_leaf_node=True)
    for a, b in ((tv, jv), (tn, jn), (td, jd), (tl, jl)):
        np.testing.assert_array_equal(_np(a), _np(b))
    _, tl2 = pt(pt.features, pts, want_leaf_node=True)
    assert torch.equal(tl2, tl)


def test_set_matches_jax():
    rng = np.random.RandomState(45)
    jt, pt, centers = _pair(rng)
    pts = centers[rng.permutation(len(centers))[:9]]
    vals = rng.randn(9, 4).astype(np.float32)
    jt.set(pts, vals)
    pt.set(pts, vals)
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))
    np.testing.assert_array_equal(pt(pt.features, pts).numpy(), vals)


def test_snap_matches_jax():
    rng = np.random.RandomState(46)
    jt, pt, centers = _pair(rng)
    pts = (centers[:12] + 0.01 * rng.randn(12, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(pt.snap(pts)), _np(jt.snap(pts)))


def test_construct_tree_device_leaves_the_tree():
    rng = np.random.RandomState(47)
    jt, pt, centers = _pair(rng)
    cloud = centers[rng.permutation(len(centers))]
    spec = pt._spec()
    before = pt.data.copy()
    got = pt.construct_tree_device(spec, torch.from_numpy(cloud))
    want = jt.construct_tree_device(jt._spec(), jnp.asarray(cloud))
    np.testing.assert_array_equal(got.data_flat.numpy(), _np(want.data_flat))
    np.testing.assert_array_equal(pt.data, before)


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("op", ["mean", "none", "max"])
def test_merge_and_shrink_match_jax(N, op):
    rng = np.random.RandomState(50 + N)
    jt, pt, _ = _pair(rng, N=N, depth_limit=4 if N == 2 else 3, n_random_refines=1)
    j_op, t_op = {"mean": (np.mean, torch.mean), "none": (None, None),
                  "max": (np.max, torch.amax)}[op]
    sel = np.arange(min(3, len(jt._frontier)))
    assert jt.merge(sel, op=j_op)
    assert pt.merge(sel, op=t_op)
    _assert_same_tree(pt, jt)
    jf = _np(jt.features)
    np.testing.assert_allclose(pt.features.numpy(), jf, rtol=1e-6, atol=0)
    # a merged, unshrunk tree moves across with its freed nodes
    back = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    _assert_same_tree(back, jt)
    assert jt.shrink_to_fit() and pt.shrink_to_fit() and back.shrink_to_fit()
    _assert_same_tree(pt, jt)
    _assert_same_tree(back, jt)
    leaves = jt._all_leaves()
    np.testing.assert_array_max_ulp(_np(pt._calc_corners(leaves)), _np(jt._calc_corners(leaves)),
                                    maxulp=0 if N == 2 else 2)
    # nothing left to merge returns False
    assert pt.merge(np.zeros(0, np.int64)) is False


def test_merge_with_features_argument_and_root_guard():
    rng = np.random.RandomState(53)
    jt, pt, _ = _pair(rng, n_random_refines=1)
    other = rng.randn(*jt.features.shape).astype(np.float32)
    jt.merge(np.arange(2), features=jnp.asarray(other))
    pt.merge(np.arange(2), features=torch.from_numpy(other.copy()))
    np.testing.assert_allclose(pt.features.numpy(), _np(jt.features), rtol=1e-6, atol=0)
    root = stt.N3Tree(N=2, data_dim=4, device="cpu")
    with pytest.raises(RuntimeError):
        root.merge()


@pytest.mark.parametrize("dim", [None, 3])
def test_frontier_reductions_match_jax(dim):
    rng = np.random.RandomState(54)
    jt, pt, _ = _pair(rng, n_random_refines=1)
    np.testing.assert_array_equal(pt._frontier, jt._frontier)
    for name in ("reduce_frontier", "max_frontier", "diam_frontier"):
        want = np.asarray(getattr(jt, name)(dim=dim))
        got = getattr(pt, name)(dim=dim)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        got_t = getattr(pt, name)(dim=dim, grad=True)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_allclose(got_t.detach().numpy(), _np(getattr(jt, name)(dim=dim, grad=True)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.reduce_frontier(op=np.min, dim=dim),
                               np.asarray(jt.reduce_frontier(op=np.min, dim=dim)), rtol=1e-6)

    f = np.array(jt.features)
    G = {n: rng.randn(*np.shape(getattr(jt, n)(dim=dim))).astype(np.float32)
         for n in ("reduce_frontier", "max_frontier")}
    for name, g in G.items():
        gj = _np(jax.grad(lambda x: jnp.sum(getattr(jt, name)(dim=dim, grad=True, features=x) * g))(
            jnp.asarray(f)))
        x = torch.from_numpy(f.copy()).requires_grad_()
        (gt,) = torch.autograd.grad((getattr(pt, name)(dim=dim, grad=True, features=x)
                                     * torch.from_numpy(g)).sum(), x)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5 * max(1.0, np.abs(gj).max()))
        assert np.abs(gj).max() > 0


def test_diam_frontier_gradient():
    """The JAX package's diam_frontier gradient is NaN (the norm of the
    zero diagonal differences); the port's is checked against jax.grad of
    the same function with a norm that is 0 at 0."""
    rng = np.random.RandomState(55)
    jt, pt, _ = _pair(rng, n_random_refines=1)
    f = np.array(jt.features)
    nid = jt._frontier
    g = rng.randn(len(nid)).astype(np.float32)

    def diam(x):
        v = jt._leaf_feature_values_jnp(x, nid)
        d = v[:, :, None, :] - v[:, None, :, :]
        sq = jnp.sum(d * d, axis=-1)
        norm = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)), 0.0)
        return jnp.sum(jnp.max(norm, axis=(1, 2)) * g)

    gj = _np(jax.grad(diam)(jnp.asarray(f)))
    x = torch.from_numpy(f.copy()).requires_grad_()
    (gt,) = torch.autograd.grad((pt.diam_frontier(grad=True, features=x) * torch.from_numpy(g)).sum(), x)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5 * max(1.0, np.abs(gj).max()))
    assert np.abs(gj).max() > 0


@pytest.mark.parametrize("data_sel", [None, slice(1, 3), 2])
def test_partial_and_clone_match_jax(data_sel):
    rng = np.random.RandomState(56)
    jt, pt, _ = _pair(rng, data_format="SH1", data_dim=4, n_random_refines=1)
    jt.merge(np.arange(1))
    pt.merge(np.arange(1))
    j2 = jt.partial(data_sel) if data_sel is not None else jt.clone()
    t2 = pt.partial(data_sel) if data_sel is not None else pt.clone()
    _assert_same_tree(t2, j2)
    assert t2.data_dim == j2.data_dim and t2.device == pt.device
    assert repr(t2.data_format) == repr(j2.data_format)
    np.testing.assert_allclose(t2.features.numpy(), _np(j2.features), rtol=1e-6, atol=0)
    t2.features[:] = 0  # a copy: the source pool is untouched
    assert float(pt.features.abs().sum()) > 0
    assert pt.partial(device="cpu").device == torch.device("cpu")


def test_refine_at_matches_jax():
    jt = st.N3Tree(N=2, data_dim=4, depth_limit=5)
    pt = stt.N3Tree(N=2, data_dim=4, depth_limit=5, device="cpu")
    for t in (jt, pt):
        t.refine()
        t._refine_at(1, (0, 0, 0))
        t._refine_at(2, (1, 0, 1))
        t._refine_at(10, (0, 1, 0))
        t._refine_at(10, (0, 1, 0))  # internal now: a no-op
    _assert_same_tree(pt, jt)
    with pytest.raises(ValueError):
        pt._refine_at(0, (0, 0, 2))
    t3 = stt.N3Tree(N=3, data_dim=4, depth_limit=1, device="cpu")
    t3.refine()
    n = t3.n_internal
    assert t3._refine_at(1, (2, 2, 2)) is None and t3.n_internal == n  # at the depth limit


def test_shrink_defrag_parent_links_port():
    """After merge + shrink_to_fit every kept node's parent link
    round-trips and every leaf keeps its corner (the JAX regression test
    on the port)."""
    t = stt.N3Tree(N=2, data_dim=4, depth_limit=5, device="cpu")
    t.refine()
    t._refine_at(1, (0, 0, 0))
    t._refine_at(2, (0, 0, 0))
    t._refine_at(10, (0, 0, 0))
    before = {tuple(np.round(c, 6)) for c in t._calc_corners(t._all_leaves()).numpy()}
    t.merge(np.asarray([0]))
    assert t._n_free == 1
    t.shrink_to_fit()
    for c in t._calc_corners(t._all_leaves()).numpy():
        assert tuple(np.round(c, 6)) in before
    pd = t.parent_depth
    for nid in range(1, t.n_internal):
        pn, px, py, pz = map(int, t._unpack_index_np(np.asarray([pd[nid, 0]]))[0])
        assert t.child[pn, px, py, pz] == nid - pn


def test_index_helpers_and_shapes_match_jax():
    rng = np.random.RandomState(57)
    jt, pt, _ = _pair(rng, N=3, depth_limit=3)
    leaves = jt._all_leaves()
    packed = jt._pack_index_np(leaves)
    np.testing.assert_array_equal(pt._unpack_index_np(packed), jt._unpack_index_np(packed))
    np.testing.assert_array_equal(pt._unpack_index(torch.from_numpy(packed)), jt._unpack_index(packed))
    np.testing.assert_array_equal(_np(pt._pack_index(torch.from_numpy(leaves))),
                                  _np(jt._pack_index(leaves)))
    for val in (2.5, [1.0], np.ones((3, 1), np.float32), np.arange(8, dtype=np.float32).reshape(2, 4)):
        np.testing.assert_array_equal(_np(pt._make_val_tensor(val)), _np(jt._make_val_tensor(val)))
    assert pt.ndim == jt.ndim == 2 and pt.shape == jt.shape and len(pt) == len(jt)
    assert pt.size(0) == jt.size(0) and pt.size(1) == jt.size(1) and pt.numel() == jt.numel()
    assert pt.max_depth == jt.max_depth


def test_weight_accumulator_reads_through_aux():
    rng = np.random.RandomState(58)
    jt, pt, _ = _pair(rng, data_format="SH1", data_dim=4)
    o = np.tile([[0.5, 0.5, -1.0]], (64, 1)).astype(np.float32)
    d = np.concatenate([rng.rand(64, 2) * 0.6 - 0.3, np.ones((64, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = stt.VolumeRenderer(pt, backend="tree")
    with pt.accumulate_weights() as acc:
        r(pt.features, stt.Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d)))
    w = acc()
    assert torch.equal(w, pt[:].aux(acc.value)) and float(w.sum()) > 0
    jacc = JaxWeightAccumulator(jt)
    jacc.weight_accum = jnp.asarray(acc.value.numpy())
    np.testing.assert_array_equal(w.numpy(), np.asarray(jacc()))


# ---------------------------------------------------------------------
# F1: map_location


def test_map_location_builds_the_same_tree():
    kw = dict(N=3, data_dim=7, depth_limit=3, init_refine=1, radius=0.8)
    a = stt.N3Tree(**kw, map_location="cpu")
    b = stt.N3Tree(**kw, device="cpu")
    assert a.device == b.device == torch.device("cpu")
    for name in ("child", "data", "parent_depth", "offset", "invradius"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.features, b.features)
    assert stt.N3Tree(device="cpu", map_location=torch.device("cpu")).device.type == "cpu"
    with pytest.raises(ValueError, match="disagree"):
        stt.N3Tree(device="cpu", map_location="cuda")


def test_load_jax_file_with_map_location(tmp_path):
    rng = np.random.RandomState(59)
    jt, feats, _ = build_tree(rng, data_format="SH1", data_dim=4, n_random_refines=1)
    jt.features = feats
    jt.merge(np.arange(1))
    p = os.path.join(tmp_path, "jax.npz")
    jt.save(p, shrink=False)
    pt = stt.N3Tree.load(p, map_location="cpu")
    ref = stt.N3Tree.load(p, device="cpu")
    _assert_same_tree(pt, jt)
    _assert_same_tree(ref, jt)
    assert pt.device == torch.device("cpu")
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))
    with pytest.raises(ValueError, match="disagree"):
        stt.N3Tree.load(p, map_location="cpu", device="cuda")
