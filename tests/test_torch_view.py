"""svox_t_tpu_torch's tree editing against the JAX package: the three K8b
editing ops (`assign`, `unique_leaf_nodes`, `calc_corners`) and
`N3TreeView` (its keys, values, set, in-place helpers, geometry and
samples, and the tree's leaf-view redirects). The editing half of
`N3Tree` (set, snap, merge, the frontier ops, partial/clone, _refine_at)
is held against the JAX package in tests/test_torch_tree.py.

Trees come from a numpy seed in the JAX package and move across with
`tree_state` / `tree_from_numpy`; each edit is applied in both packages.
Index tables, leaf lists and corners must agree exactly, but for corners
at N 3: XLA on the CPU multiplies by float32(1/3) where the JAX function
divides by 3, which moves 59% of the coordinates of a depth-3 N-3 tree by
1 or 2 ulp; the port divides, and equals a NumPy walk with true float32
divisions bit for bit, so the JAX package is held to 2 ulp there; pools after a merge's mean to
1e-6 relative (the JAX package divides in float64, the port in
float32); gradients of the frontier reductions to ``1e-5 * max(1,
max|g_jax|)``. `assign` is compared on clouds with one point per pool
row: where points share a row the JAX scatter leaves the winner
unspecified, and the port's rule (the largest point id) is pinned on its
own. The random helpers draw from each tree's own ``RandomState(0)``, so
their results must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import query as jquery
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import query as tquery
from svox_t_tpu_torch.ops.traversal import descend

from helpers import build_tree


def _pair(rng, **kw):
    """A JAX tree with its pool, the port's copy on the CPU with the same
    pool, and the leaf centres (world space)."""
    jt, feats, centers = build_tree(rng, **kw)
    jt.features = feats
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    pt.features = torch.from_numpy(np.array(feats))
    return jt, pt, centers


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(jax.device_get(x))


def _assert_same_tree(pt, jt):
    np.testing.assert_array_equal(pt.child, jt.child)
    np.testing.assert_array_equal(pt.data, np.asarray(jt.data))
    np.testing.assert_array_equal(pt.parent_depth, jt.parent_depth)
    assert (pt.n_internal, pt._n_free, pt.filled, pt.capacity) == \
        (jt.n_internal, jt._n_free, jt.filled, jt.capacity)
    np.testing.assert_array_equal(pt._all_leaves(), jt._all_leaves())
    np.testing.assert_array_equal(pt._frontier, jt._frontier)


# ---------------------------------------------------------------------
# The three kernels' ops


@pytest.mark.parametrize("N", [2, 3])
def test_calc_corners_matches_jax(N):
    rng = np.random.RandomState(30 + N)
    jt, pt, _ = _pair(rng, N=N, depth_limit=4 if N == 2 else 3)
    leaves = jt._all_leaves()
    want = _np(jquery.calc_corners(jt._spec(), jnp.asarray(leaves, jnp.int32)))
    got = _np(tquery.calc_corners(pt._spec(), torch.as_tensor(leaves, dtype=torch.int32)))
    # the walk with a true float32 division per level, in NumPy
    pd, N3 = jt.parent_depth, N ** 3
    exact = np.zeros_like(got)
    for r, (node, x, y, z) in enumerate(leaves):
        o = np.zeros(3, np.float32)
        while True:
            o = (o + np.asarray([x, y, z], np.float32)) / np.float32(N)
            if node == 0:
                break
            p = pd[node, 0]
            node, x, y, z = p // N3, p % N3 // (N * N), p % (N * N) // N, p % N
        exact[r] = o
    np.testing.assert_array_equal(got, exact)
    if N == 2:
        np.testing.assert_array_equal(got, want)
    else:
        # XLA on the CPU turns the division by 3 into a multiply by
        # float32(1/3); the port divides, as the function is written.
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
    # and every leaf's centre descends to that leaf again
    cen = torch.from_numpy(got) + 0.5 * pt[:].lengths_local[:, None]
    flat = descend(pt._spec(), cen).node_flat.numpy()
    np.testing.assert_array_equal(flat, pt._pack_index_np(leaves))


def test_calc_corners_walks_freed_nodes_as_jax():
    """Cells of a node freed by merge (parent link -1) are still leaves
    until shrink_to_fit; their walk unpacks -1 with floor division."""
    rng = np.random.RandomState(35)
    jt, pt, _ = _pair(rng, n_random_refines=1)
    jt.merge(np.arange(2))
    pt.merge(np.arange(2))
    leaves = jt._all_leaves()
    np.testing.assert_array_equal(_np(pt._calc_corners(leaves)), _np(jt._calc_corners(leaves)))


@pytest.mark.parametrize("world", [True, False])
def test_assign_matches_jax(world):
    rng = np.random.RandomState(40)
    jt, pt, centers = _pair(rng, data_format="SH1", data_dim=4)
    f = np.array(jt.features)[: int(len(centers) * 0.7)]  # rows past M drop the write
    order = rng.permutation(len(centers))
    pts = centers[order]
    if not world:
        pts = np.array(jt.world2tree(pts), np.float32)
    pts = np.concatenate([pts, rng.rand(40, 3).astype(np.float32)]) if world else pts
    vals = rng.randn(len(pts), 4).astype(np.float32)
    # one point per pool row: random points may only hit rows >= M or leaves
    # no centre hits
    rows = _np(jquery.query(jt._spec(), jnp.asarray(f), jnp.asarray(pts), world)[2])
    keep = np.ones(len(pts), bool)
    seen = set()
    for i, r in enumerate(rows):
        if r < len(f):
            keep[i] = r not in seen
            seen.add(int(r))
    pts, vals = pts[keep], vals[keep]
    want = _np(jquery.assign(jt._spec(), jnp.asarray(f), jnp.asarray(pts), jnp.asarray(vals), world))
    got = tquery.assign(pt._spec(), torch.from_numpy(f), torch.from_numpy(pts),
                        torch.from_numpy(vals), world)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, f)


def test_assign_largest_point_id_wins():
    """Port-only rule: where several points address one row, the largest
    point id writes it; the input pool is left untouched."""
    rng = np.random.RandomState(41)
    _, pt, centers = _pair(rng)
    L = len(centers)
    f = pt.features.clone()
    pts = np.concatenate([centers, centers[::-1], centers[:5]])
    vals = np.arange(len(pts) * 4, dtype=np.float32).reshape(-1, 4)
    got = tquery.assign_plain(pt._spec(), f, torch.from_numpy(pts), torch.from_numpy(vals))
    # row i is addressed by points i, 2L-1-i and (i < 5) 2L+i
    winner = np.maximum(np.arange(L), 2 * L - 1 - np.arange(L))
    winner[:5] = 2 * L + np.arange(5)
    np.testing.assert_array_equal(got.numpy(), vals[winner])
    assert torch.equal(f, pt.features)


@pytest.mark.parametrize("pad", [None, 5, -3])
def test_unique_leaf_nodes_matches_jax(pad):
    rng = np.random.RandomState(42)
    jt, pt, centers = _pair(rng)
    pts = np.concatenate([centers[:20], centers[:10], centers[5:15],
                          rng.rand(30, 3).astype(np.float32)])
    _, jn, _ = jquery.query(jt._spec(), jt.features, jnp.asarray(pts), True)
    n_uniq = len(np.unique(_np(jn)))
    size = None if pad is None else n_uniq + pad
    j_leaf, j_count = jquery.unique_leaf_nodes(jn, jt.N, size=size)
    t_ids = torch.from_numpy(_np(jn).astype(np.int32))
    t_leaf, t_count = tquery.unique_leaf_nodes(t_ids, pt.N, size=size,
                                               n_cells=pt._spec().data_flat.numel())
    np.testing.assert_array_equal(t_leaf.numpy(), _np(j_leaf))
    assert int(t_count) == int(j_count) == min(n_uniq, size or len(pts))
    assert t_leaf.dtype == torch.int32 and t_count.dtype == torch.int32
    # the default range (largest id + 1) gives the same
    d_leaf, d_count = tquery.unique_leaf_nodes(t_ids, pt.N, size=size)
    assert torch.equal(d_leaf, t_leaf) and int(d_count) == int(t_count)


def test_unique_leaf_nodes_drops_ids_out_of_range():
    ids = torch.tensor([7, 3, 7, 100, -1, 3, 0], dtype=torch.int32)
    leaf, count = tquery.unique_leaf_nodes(ids, 2, size=6, n_cells=16)
    assert int(count) == 3
    np.testing.assert_array_equal(leaf.numpy(), [[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 1, 1]]
                                  + [[-1] * 4] * 3)


def test_edit_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run their plain versions in their place."""
    _, pt, centers = _pair(np.random.RandomState(43))
    spec = pt._spec()
    pts = torch.tensor(centers[:4])
    with pytest.raises(ValueError, match="CUDA"):
        tquery.assign_cuda(spec, pt.features, pts, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tquery.unique_leaf_nodes_cuda(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tquery.calc_corners_cuda(spec, torch.zeros(4, 4, dtype=torch.int32))


# ---------------------------------------------------------------------
# N3TreeView


def _view_geometry(v):
    return {name: _np(getattr(v, name)) for name in
            ("values", "depths", "lengths", "lengths_local", "corners", "corners_local")}


def _assert_same_view(tv, jv, corner_ulp=0):
    """Equal leaves, values and geometry; corners within ``corner_ulp``
    (2 at N 3, see the module docstring)."""
    np.testing.assert_array_equal(tv._leaf_node, jv._leaf_node)
    assert len(tv) == len(jv) and tv.shape == jv.shape
    got, want = _view_geometry(tv), _view_geometry(jv)
    for name in got:
        if name.startswith("corners"):
            np.testing.assert_array_max_ulp(got[name], want[name], maxulp=corner_ulp)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(tv.data_values, jv.data_values)


@pytest.mark.parametrize("N", [2, 3])
def test_view_keys_match_jax(N):
    rng = np.random.RandomState(60 + N)
    jt, pt, centers = _pair(rng, N=N, depth_limit=4 if N == 2 else 3)
    n = jt.n_leaves
    ulp = 0 if N == 2 else 2
    mask = rng.rand(n) < 0.3
    keys = [slice(None), slice(3, n // 2), slice(None, None, 7), np.arange(0, n, 5), mask]
    for key in keys:
        _assert_same_view(pt[key], jt[key], ulp)
    _assert_same_view(pt[torch.from_numpy(mask)], jt[mask], ulp)
    # int key: one leaf, values (D,)
    assert pt[4].values.shape == (pt.data_dim,)
    np.testing.assert_array_equal(_np(pt[4].values), _np(jt[4].values))
    # point keys: float, integer and torch matrices, an x, y, z tuple, LocalIndex
    pts = np.concatenate([centers[::4], centers[:6]]).astype(np.float32)
    _assert_same_view(pt[pts], jt[jnp.asarray(pts)], ulp)
    _assert_same_view(pt[torch.from_numpy(pts)], jt[jnp.asarray(pts)], ulp)
    np.testing.assert_array_equal(pt[pts]._packed_ids, jt[jnp.asarray(pts)]._packed_ids)
    ikey = np.round(centers * 64).astype(np.int64)
    np.testing.assert_array_equal(_np(pt[ikey].values), _np(jt[ikey].values))
    c = centers[3]
    _assert_same_view(pt[float(c[0]), float(c[1]), float(c[2])],
                      jt[float(c[0]), float(c[1]), float(c[2])], ulp)
    local = np.array(jt.world2tree(jnp.asarray(centers[:9])), np.float32)
    _assert_same_view(pt[stt.LocalIndex(local)], jt[st.LocalIndex(jnp.asarray(local))], ulp)
    # channel keys
    for key in ((slice(None), 1), (slice(2, 9), slice(0, 2)), (mask, -1)):
        np.testing.assert_array_equal(_np(pt[key].values), _np(jt[key].values))
    one = pt[0, 0]
    assert isinstance(one.item(), float) and one.item() == jt[0, 0].item()
    # the tree's redirects are those of tree[:]
    for name in ("depths", "lengths", "lengths_local", "values", "values_local"):
        np.testing.assert_array_equal(_np(getattr(pt, name)), _np(getattr(jt, name)), err_msg=name)
    for name in ("corners", "corners_local"):
        np.testing.assert_array_max_ulp(_np(getattr(pt, name)), _np(getattr(jt, name)), maxulp=ulp)


def test_view_values_are_differentiable_and_empty_leaves_read_zero():
    rng = np.random.RandomState(63)
    jt, pt, centers = _pair(rng)
    M = pt.features.shape[0]
    f = pt.features[: M // 2].clone().requires_grad_()
    pt.features = f
    v = pt[:].values
    assert bool((v[torch.from_numpy(pt[:].data_values >= M // 2)] == 0).all())
    (g,) = torch.autograd.grad(v.sum(), f)
    assert float(g.sum()) == float((pt[:].data_values < M // 2).sum()) * pt.data_dim
    assert not pt[:].values_nograd.requires_grad


def test_view_set_matches_jax():
    rng = np.random.RandomState(64)
    jt, pt, centers = _pair(rng)
    for t in (jt, pt):
        t[:4].set(np.full((4, 4), 3.0, np.float32))
        t[5].set(np.arange(4, dtype=np.float32))
        t[7:9] = np.float32(-2.0)
    # the view's __setitem__ (the JAX package's writes into a read-only
    # array here, so its effect is spelled out on that side)
    pt[10:13][1] = np.full(4, 9.0, np.float32)
    block = np.array(jt[10:13].values)
    block[1] = 9.0
    jt[10:13].set(block)
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))
    # a view as the value
    pt[20:24].set(pt[:4])
    np.testing.assert_array_equal(_np(pt[20:24].values), np.full((4, 4), 3.0, np.float32))


def test_view_set_channel_key_matches_jax():
    rng = np.random.RandomState(65)
    jt, pt, centers = _pair(rng)
    n = jt.n_leaves
    vec = np.linspace(0.0, 1.0, n).astype(np.float32)
    for t in (jt, pt):
        t[:, 1].set(7.5)
        t[:, 2].set(vec)
        t[:, 0:2].set(np.stack([vec, 2 * vec], axis=1))
        t[3:9, -1].set(np.float32(0.25))
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))


def test_view_inplace_helpers_match_jax():
    """The random helpers draw from each tree's own RandomState(0): the
    same draws in both packages."""
    rng = np.random.RandomState(66)
    jt, pt, centers = _pair(rng)
    for t in (jt, pt):
        t[:10].normal_(0.5, 2.0)
        t[10:30].uniform_(-1.0, 3.0)
        t[::3].clamp_(min=-0.5, max=0.7)
        t.normal_()
        t[5:40].relu_()
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))
    for t in (jt, pt):
        t.sigmoid_()
    np.testing.assert_allclose(pt.features.numpy(), _np(jt.features), rtol=1e-6, atol=0)
    f = np.array(jt.features)
    f[0, 0], f[1, 1], f[2, 2] = np.nan, np.inf, -np.inf
    jt.features = jnp.asarray(f)
    pt.features = torch.from_numpy(f.copy())
    for t in (jt, pt):
        t.nan_to_num_(inf_val=123.0)
        t.clamp_(max=0.9)
        t.uniform_()
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))


def test_view_sample_matches_jax():
    rng = np.random.RandomState(67)
    jt, pt, centers = _pair(rng)
    for _ in range(2):
        np.testing.assert_array_equal(_np(pt[::2].sample(5)), _np(jt[::2].sample(5)))
        np.testing.assert_array_equal(_np(pt.sample_local(3)), _np(jt.sample_local(3)))
    s = pt[:4].sample(2, device="cpu")
    assert s.shape == (4, 2, 3) and s.device == torch.device("cpu")


def test_view_invalidation_repr_and_len():
    rng = np.random.RandomState(68)
    _, pt, centers = _pair(rng)
    view = pt[:]
    assert "N3Tree" in repr(pt) and repr(view).startswith("N3TreeView(")
    assert len(pt) == pt.n_leaves == len(view)
    assert pt.shape == (pt.n_leaves, pt.data_dim) and pt.numel() == pt.n_leaves * pt.data_dim
    pt.construct_tree(centers)  # re-pointing keeps the layout: views stay valid
    _ = view.values
    pt.data = pt.data  # so does a new index table
    _ = view.values
    pt.refine()
    with pytest.raises(RuntimeError, match="invalidated"):
        _ = view.values
    with pytest.raises(RuntimeError, match="invalidated"):
        view.set(0.0)


def test_view_tensor_conveniences_and_dunders_match_jax():
    rng = np.random.RandomState(69)
    jt, pt, _ = _pair(rng)
    jv, tv = jt[:], pt[:]
    n = len(tv)
    assert tv.size() == (n, 4) and tv.size(0) == n and tv.size(1) == 4
    assert tv.dim() == 2 and tv.numel() == n * 4 and tv.ndim == 2
    pairs = [
        (tv.clamp(-0.1, 0.1), jv.clamp(-0.1, 0.1)), (tv.clamp_min(0.0), jv.clamp_min(0.0)),
        (tv.clamp_max(0.0), jv.clamp_max(0.0)), (tv.relu(), jv.relu()),
        (tv + 1.5, jv + 1.5), (2.0 * tv, 2.0 * jv), (tv - 1.0, jv - 1.0), (1.0 - tv, 1.0 - jv),
        (tv / 4.0, jv / 4.0), (-tv, -jv), (abs(tv), abs(jv)), (tv > 0.1, jv > 0.1),
        (tv == tv.values, jv == jv.values), (tv[3], jv[3]), (tv.sum(), jv.sum()),
        (tv.max(), jv.max()), (tv.min(), jv.min()),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tv.sigmoid()), _np(jv.sigmoid()), rtol=1e-6)
    np.testing.assert_allclose(_np(tv.mean()), _np(jv.mean()), rtol=1e-6)
    vals = pt[:].values.clone()
    tv.clamp(-0.1, 0.1)
    assert torch.equal(pt[:].values, vals)  # non-mutating


def test_tree_inplace_arithmetic_matches_jax():
    rng = np.random.RandomState(70)
    jt, pt, _ = _pair(rng)
    for t in (jt, pt):
        t += 1.0
        t *= 2.0
        t -= 0.5
    pt /= 4.0
    jt.__idiv__(4.0)
    np.testing.assert_array_equal(pt.features.numpy(), _np(jt.features))


def test_view_refine_and_aux():
    rng = np.random.RandomState(71)
    jt, pt, _ = _pair(rng)
    arr = rng.rand(*jt.child.shape).astype(np.float32)
    np.testing.assert_array_equal(pt[::3].aux(arr), jt[::3].aux(arr))
    np.testing.assert_array_equal(pt[::3].aux(torch.from_numpy(arr)).numpy(), jt[::3].aux(arr))
    assert jt[2:5].refine() == pt[2:5].refine()
    _assert_same_tree(pt, jt)
