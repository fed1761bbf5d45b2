"""svox_t_tpu_torch's LBS warp (K10) and p2v voxelize (K11) against the
JAX package (CPU): the port's plain versions, outputs and gradients.

Tolerances: warp outputs atol 1e-6 (the same float32 products and sums,
up to the order XLA's einsum adds the bones in); `get_transformation_matrix`
1e-5 (a 4x4 inverse). Voxelize outputs atol 1e-5 (the JAX package's own
naive check holds 1e-4; the splat sums in another order). Gradients
against `jax.grad`: ``1e-5 * max(1, max|g_jax|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.utils.scenes import skin_to_nearest_joints

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _rig(seed, Q=24, J=3, nb=2, low=-0.3, bad_ids=False):
    """Transforms near the identity, points, weights (some <= 0) and ids
    (with ``bad_ids`` also -1 and J + 3)."""
    rng = np.random.RandomState(seed)
    T = (np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
         + rng.randn(J, 4, 4).astype(np.float32) * 0.1)
    pts = rng.rand(Q, 3).astype(np.float32)
    sw = rng.uniform(low, 1.0, (Q, nb)).astype(np.float32)
    sw[0, 0] = 0.0
    ji = rng.randint(0, J, (Q, nb)).astype(np.int32)
    if bad_ids:
        ji[1, 0], ji[2, -1], ji[3, 0] = -1, J + 3, -J - 2
        sw[1:4] = np.abs(sw[1:4]) + 0.1
    return T, pts, sw, ji


def _warp_both(T, pts, sw, ji):
    jw, jm = st.warp_vertices(jnp.asarray(T), jnp.asarray(pts), jnp.asarray(sw), jnp.asarray(ji))
    pw, pm = stt.warp_vertices(_t(T), _t(pts), _t(sw), _t(ji))
    return (np.asarray(jw), np.asarray(jm)), (pw.numpy(), pm.numpy())


def test_warp_identity():
    _, pts, sw, ji = _rig(0)
    sw = np.abs(sw) / np.abs(sw).sum(1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    (jw, jm), (pw, pm) = _warp_both(T, pts, sw, ji)
    np.testing.assert_allclose(pw, pts, atol=ATOL)
    np.testing.assert_allclose(pm, np.tile(np.eye(4), (len(pts), 1, 1)), atol=ATOL)
    np.testing.assert_allclose(pw, jw, atol=ATOL)
    np.testing.assert_allclose(pm, jm, atol=ATOL)


def test_warp_translation_blend():
    Q = 10
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[0, 0, 3], T[1, 0, 3] = 1.0, -1.0
    pts = np.random.RandomState(1).rand(Q, 3).astype(np.float32)
    sw = np.stack([np.full(Q, 0.25), np.full(Q, 0.75)], -1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (Q, 1))
    (jw, _), (pw, _) = _warp_both(T, pts, sw, ji)
    want = pts.copy()
    want[:, 0] += 0.25 - 0.75
    np.testing.assert_allclose(pw, want, atol=ATOL)
    np.testing.assert_allclose(pw, jw, atol=ATOL)


def test_warp_nonpositive_weights_skipped():
    Q = 6
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[1] *= 100.0
    T[2] *= -7.0
    pts = np.random.RandomState(2).rand(Q, 3).astype(np.float32)
    sw = np.stack([np.ones(Q), -np.ones(Q), np.zeros(Q)], -1).astype(np.float32)
    ji = np.tile(np.array([0, 1, 2], np.int32), (Q, 1))
    (jw, jm), (pw, pm) = _warp_both(T, pts, sw, ji)
    np.testing.assert_allclose(pw, pts, atol=ATOL)
    np.testing.assert_allclose(pw, jw, atol=ATOL)
    np.testing.assert_allclose(pm, jm, atol=ATOL)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("bad_ids", [False, True])
def test_warp_matches_jax(nb, bad_ids):
    """Random rigs, some weights <= 0; with ``bad_ids`` joint ids -1, J + 3
    and -J - 2, read as a JAX gather reads them."""
    T, pts, sw, ji = _rig(3 + nb, nb=nb, bad_ids=bad_ids)
    (jw, jm), (pw, pm) = _warp_both(T, pts, sw, ji)
    np.testing.assert_allclose(pw, jw, atol=ATOL)
    np.testing.assert_allclose(pm, jm, atol=ATOL)
    np.testing.assert_array_equal(pm[:, 3], np.tile([0, 0, 0, 1], (len(pts), 1)))


def test_blend_transformation_matrix():
    T, _, sw, ji = _rig(5)
    T = np.random.RandomState(5).randn(*T.shape).astype(np.float32)
    want = np.asarray(st.blend_transformation_matrix(jnp.asarray(T), jnp.asarray(sw), jnp.asarray(ji)))
    got = stt.blend_transformation_matrix(_t(T), _t(sw), _t(ji)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[:, 3], [[0, 0, 0, 1]] * len(sw))


def test_get_transformation_matrix():
    rng = np.random.RandomState(6)
    src = (np.eye(4) + rng.randn(5, 4, 4) * 0.1).astype(np.float32)
    tgt = (np.eye(4) + rng.randn(5, 4, 4) * 0.1).astype(np.float32)
    want = np.asarray(st.get_transformation_matrix(jnp.asarray(src), jnp.asarray(tgt)))
    got = stt.get_transformation_matrix(_t(src), _t(tgt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got @ src, tgt, atol=1e-5)


def _warp_loss_jax(which):
    def loss(T_, pts_, sw_, ji_):
        w, m = st.warp_vertices(T_, pts_, sw_, ji_)
        return {"both": jnp.sum(w ** 2) + jnp.sum(m), "warped": jnp.sum(w ** 2),
                "mats": jnp.sum(m * m)}[which]
    return loss


@pytest.mark.parametrize("nb,bad_ids", [(2, False), (4, True)])
@pytest.mark.parametrize("which", ["both", "warped", "mats"])
def test_warp_grads_match_jax(nb, bad_ids, which):
    """Gradients of sum(w^2) + sum(M) (and of each output alone) with
    respect to T, x and w against `jax.grad`; a joint id outside [0, J)
    after the wrap adds nothing to dT, as XLA's scatter drops it."""
    T, pts, sw, ji = _rig(7 + nb, nb=nb, bad_ids=bad_ids)
    gj = jax.grad(_warp_loss_jax(which), argnums=(0, 1, 2))(
        jnp.asarray(T), jnp.asarray(pts), jnp.asarray(sw), jnp.asarray(ji))
    Tt, pt, st_ = (_t(a).requires_grad_() for a in (T, pts, sw))
    w, m = stt.warp_vertices(Tt, pt, st_, _t(ji))
    loss = {"both": (w ** 2).sum() + m.sum(), "warped": (w ** 2).sum(), "mats": (m * m).sum()}[which]
    loss.backward()
    for got, want in zip((Tt.grad, pt.grad, st_.grad), gj):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=_gtol(want))
    assert not Tt.grad[:, 3].any()
    assert not st_.grad[sw <= 0].any()


def test_warp_grad_only_where_asked():
    T, pts, sw, ji = _rig(11)
    Tt = _t(T).requires_grad_()
    w, _ = stt.warp_vertices(Tt, _t(pts), _t(sw), _t(ji))
    w.sum().backward()
    assert Tt.grad is not None and Tt.grad.abs().sum() > 0
    dT, dx, dw = stt.ops.warp.warp_backward_plain(
        _t(T), _t(pts), _t(sw), _t(ji), torch.ones(len(pts), 3), None, True, False, False)
    assert dx is None and dw is None
    np.testing.assert_allclose(dT.numpy(), Tt.grad.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# p2v
# ---------------------------------------------------------------------------


def _cloud(seed, Q=40, F=1):
    rng = np.random.RandomState(seed)
    pts = rng.rand(Q, 3).astype(np.float32)
    pts[-1] = [10.0, 10.0, 10.0]  # outside the volume: deposits nothing
    pts[-2] = [-0.05, 0.5, 1.02]  # just outside one face: part of its window clips
    feats = np.abs(rng.rand(Q, F)).astype(np.float32) + 0.1
    return pts, feats


GRIDS = {
    "unit": ([0, 0, 0], [1, 1, 1], 16, 0.08, 0.15),
    "box": ([-0.1, 0.0, 0.05], [1.2, 1.0, 0.9], 12, 0.06, 0.17),
}


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_voxelize_matches_jax(F, grid):
    """Only the last feature column is splatted (F = 3 shows it)."""
    pts, feats = _cloud(20 + F, F=F)
    args = GRIDS[grid]
    want = np.asarray(st.voxelize(jnp.asarray(pts), jnp.asarray(feats), *args))
    got = stt.voxelize(_t(pts), _t(feats), *args)
    assert got.shape == want.shape == (args[2],) * 3 + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert want.max() > 0.1
    other = feats.copy()
    other[:, :-1] = 50.0
    np.testing.assert_array_equal(stt.voxelize(_t(pts), _t(other), *args).numpy(), got.numpy())


def test_voxelize_point_outside_volume():
    pts = np.array([[10.0, 10.0, 10.0], [-3.0, 0.5, 0.5]], np.float32)
    out = stt.voxelize(_t(pts), torch.ones(2, 1), [0, 0, 0], [1, 1, 1], 8, 0.1, 0.2)
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_voxelize_grid_constants_match_jax_window():
    """W, the float32 voxel size and the radii as the JAX package forms
    them, with the radius one voxel."""
    c = stt.ops.p2v.grid_consts([0, 0, 0], [1, 1, 1], 11, 0.05, 0.1)
    assert c.W == int(np.max(np.ceil(2.0 * 0.1 / (np.float32(1.0) / np.float32(10))))) + 2
    assert c.cr == float(np.float32(0.1)) and c.cr2 == float(np.float32(0.1 * 0.1))
    assert c.c2k == float(np.float32(2.0 * 0.05 * 0.05))
    pts, feats = _cloud(30)
    want = np.asarray(st.voxelize(jnp.asarray(pts), jnp.asarray(feats), [0, 0, 0], [1, 1, 1],
                                  11, 0.05, 0.1))
    got = stt.voxelize(_t(pts), _t(feats), [0, 0, 0], [1, 1, 1], 11, 0.05, 0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("F", [1, 3])
def test_voxelize_grads_match_jax(F):
    pts, feats = _cloud(40 + F, Q=30, F=F)
    n = 10
    G = np.random.RandomState(F).randn(n, n, n, 1).astype(np.float32)

    def loss(p, f):
        v = st.voxelize(p, f, [0, 0, 0], [1, 1, 1], n, 0.08, 0.2)
        return jnp.sum(v * G) + jnp.sum(v ** 2)

    gp, gf = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts),
                                                                      jnp.asarray(feats)))
    p, f = _t(pts).requires_grad_(), _t(feats).requires_grad_()
    v = stt.voxelize(p, f, [0, 0, 0], [1, 1, 1], n, 0.08, 0.2)
    ((v * _t(G)).sum() + (v ** 2).sum()).backward()
    np.testing.assert_allclose(p.grad.numpy(), gp, atol=_gtol(gp))
    np.testing.assert_allclose(f.grad.numpy(), gf, atol=_gtol(gf))
    assert not f.grad[:, :-1].any() and f.grad[:, -1].abs().max() > 0
    assert not p.grad[-1].any()  # the point outside the volume
    assert np.abs(gp).max() > 0


def test_voxelize_grad_only_where_asked():
    pts, feats = _cloud(50, Q=12)
    f = _t(feats).requires_grad_()
    v = stt.voxelize(_t(pts), f, [0, 0, 0], [1, 1, 1], 8, 0.1, 0.2)
    v.sum().backward()
    assert f.grad is not None and f.grad.abs().max() > 0
    c = stt.ops.p2v.grid_consts([0, 0, 0], [1, 1, 1], 8, 0.1, 0.2)
    dp, df = stt.ops.p2v.voxelize_backward_plain(_t(pts), _t(feats), c, torch.ones(8, 8, 8, 1),
                                                 want_points=False)
    assert dp is None
    np.testing.assert_array_equal(df.numpy(), f.grad.numpy())


# ---------------------------------------------------------------------------
# The kernels' sum orders, through their plain mirrors
# ---------------------------------------------------------------------------


def _morton_cloud(seed, Q, bits=6):
    """Q random points in the unit cube in Morton order of a 2^bits grid,
    as the shell's rows go within a level."""
    pts = np.random.RandomState(seed).rand(Q, 3).astype(np.float32)
    g = (pts * (1 << bits)).astype(np.int64)
    code = np.zeros(Q, np.int64)
    for b in range(bits):
        for a in range(3):
            code |= ((g[:, a] >> b) & 1) << (3 * b + a)
    return pts[np.argsort(code, kind="stable")]


ORDERS = ("morton", "shuffled")


def _ordered(a, order, seed=5):
    if order == "morton":
        return a
    return a[np.random.RandomState(seed).permutation(len(a))]


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("nb", [2, 4])
def test_warp_runs_mirror_matches_jax(order, nb):
    """dT summed as the backward kernel sums it (runs of points, kThreads
    apart, in a register cache of joints; `warp_dT_runs_plain`) against
    the JAX package's VJP, on a cloud skinned to its nb nearest joints."""
    Q, J = 4096, 6
    pts = _morton_cloud(11, Q)
    joints = np.random.RandomState(12).rand(J, 3).astype(np.float32)
    sw, ji = skin_to_nearest_joints(pts, joints, nb)
    rng = np.random.RandomState(13)
    T = (np.eye(4) + 0.1 * rng.randn(J, 4, 4)).astype(np.float32)
    g_x = rng.randn(Q, 3).astype(np.float32)
    g_M = rng.randn(Q, 4, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda T_: st.warp_vertices(T_, jnp.asarray(pts), jnp.asarray(sw), jnp.asarray(ji)),
                     jnp.asarray(T))
    want = np.asarray(vjp((jnp.asarray(g_x), jnp.asarray(g_M)))[0])
    perm = _ordered(np.arange(Q), order)
    dT, census = stt.ops.warp.warp_dT_runs_plain(_t(T), *(_t(a[perm]) for a in (pts, sw, ji, g_x, g_M)))
    assert _rel(dT.numpy(), want) <= 1e-5
    assert census["terms"] == Q * nb
    assert census["hits"] + census["evictions"] <= census["terms"]
    adds = ("evict_warp_adds", "evict_lane_adds", "end_warp_adds", "end_lane_adds")
    assert census["shared_adds"] == 12 * sum(census[k] for k in adds)
    assert census["evict_warp_adds"] + census["evict_lane_adds"] <= census["evictions"]


def test_warp_runs_mirror_one_rig():
    """bench.py's rig (two joints, every point on both): every term after a
    thread's first two hits its cache, nothing is evicted, and each warp
    adds each joint once at its run's end."""
    Q = 2 * stt.ops.warp.RUN_BLOCK * stt.ops.warp.RUN_POINTS
    pts = _morton_cloud(14, Q)
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], 1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (Q, 1))
    T = (np.eye(4) + 0.1 * np.random.RandomState(15).randn(2, 4, 4)).astype(np.float32)
    g_x = np.random.RandomState(16).randn(Q, 3).astype(np.float32)
    dT, census = stt.ops.warp.warp_dT_runs_plain(_t(T), _t(pts), _t(sw), _t(ji), _t(g_x), None)
    want = stt.ops.warp.warp_backward_plain(_t(T), _t(pts), _t(sw), _t(ji), _t(g_x), None, True, False, False)[0]
    assert _rel(dT.numpy(), want.numpy()) <= 1e-5
    threads = Q // stt.ops.warp.RUN_POINTS
    assert census["evictions"] == 0 and census["end_lane_adds"] == 0
    assert census["hits"] == 2 * Q - 2 * threads
    assert census["end_warp_adds"] == 2 * threads // stt.ops.warp.WARP


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_voxelize_tiled_mirror_matches_jax(order, grid):
    """The volume summed as the forward kernel sums it (per block of
    consecutive points a tile of their windows' box where it fits, else
    straight into the grid; `voxelize_forward_tiled_plain`) against the
    JAX package, with the kernel's tile and a small one that only some
    blocks fit."""
    pts = _ordered(_morton_cloud(21, 2048), order)
    feats = (np.random.RandomState(22).rand(len(pts), 2) + 0.1).astype(np.float32)
    args = GRIDS[grid]
    want = np.asarray(st.voxelize(jnp.asarray(pts), jnp.asarray(feats), *args))
    c = stt.ops.p2v.grid_consts(*args)
    tiled = []
    for cap in (stt.ops.p2v.TILE_FLOATS, 1100):
        got, census = stt.ops.p2v.voxelize_forward_tiled_plain(_t(pts), _t(feats), c, block=128, cap=cap)
        assert _rel(got.numpy(), want) <= 1e-5
        _, _, fits = stt.ops.p2v.tile_boxes(_t(pts), c, block=128, cap=cap)
        assert census["blocks"] == 16 and census["tiled"] == int(fits.sum())
        if census["tiled"] == census["blocks"]:
            assert census["shared_adds"] > census["global_adds"]
        tiled.append(census["tiled"])
    assert tiled[0] == 16
    if order == "morton":
        assert 0 < tiled[1] < 16
    else:
        assert tiled[1] == 0
