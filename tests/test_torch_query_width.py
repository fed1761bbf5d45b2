"""The point query's forward (K8b, `csrc/query_fwd.cuh`) on the CPU, where no
kernel runs:

  * `query_unit`, the copy unit of a launch: the widest of 16, 8, 4 (and, for
    a bf16 pool, 2) bytes that divides the row and the pool's and the
    output's addresses;
  * the override (``unit=`` of `query_forward_cuda`): the rule's unit or a
    narrower one that divides the row and the pointers; anything else
    raises;
  * the query against the JAX package, float32 and bf16 pools at D = 1, 4,
    5 and 28, with duplicated points and points in empty leaves and past the
    pool's last row: values, node ids and row ids exact, and the gradient;
  * the backward (`csrc/query_bwd.cuh`): `query_bwd_unit`, the widest of
    4, 2, 1 values a unit that divides the row and the gradients' address
    (its values the float32 gradient's), its launch counters, and the
    gradient against `jax.vjp` of the JAX query at rows that take the 8-
    and 4-byte units (and bf16's 4 and 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu.ops import query as jquery
from svox_t_tpu_torch.ops import query as tquery

from helpers import build_tree

F32, BF16 = torch.float32, torch.bfloat16

# (D, dtype, address offsets in bytes of (pool, output), want).
UNIT_CASES = [
    (28, F32, (0, 0), 16), (4, F32, (0, 0), 16), (8, F32, (0, 0), 16), (2, F32, (0, 0), 8),
    (6, F32, (0, 0), 8), (5, F32, (0, 0), 4), (1, F32, (0, 0), 4), (13, F32, (0, 0), 4),
    (28, F32, (4, 0), 4), (28, F32, (8, 0), 8), (28, F32, (0, 8), 8), (28, F32, (12, 0), 4),
    (4, F32, (16, 0), 16),
    (28, BF16, (0, 0), 8), (4, BF16, (0, 0), 8), (8, BF16, (0, 0), 16), (2, BF16, (0, 0), 4),
    (5, BF16, (0, 0), 2), (1, BF16, (0, 0), 2), (28, BF16, (2, 0), 2), (28, BF16, (4, 0), 4),
    (8, BF16, (8, 0), 8), (28, BF16, (0, 6), 2),
]


@pytest.mark.parametrize("D,dtype,offs,want", UNIT_CASES)
def test_query_unit_rule(D, dtype, offs, want):
    ptrs = tuple((1 << 20) + o for o in offs)
    assert tquery.query_unit(D, dtype, ptrs) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_query_unit_override(dtype):
    """No override takes the rule's unit; a narrower unit that divides the
    row and the pointers is taken; a wider one, one the pool type has no
    instance for and anything else raise."""
    ptrs = (1 << 20, 1 << 21)
    units = tquery.QUERY_UNITS[dtype]
    rule = tquery.query_unit(28, dtype, ptrs)
    assert tquery._query_launch_unit(28, dtype, ptrs, None) == rule
    for u in units:
        if u <= rule:
            assert tquery._query_launch_unit(28, dtype, ptrs, u) == u
        else:
            with pytest.raises(ValueError, match="this launch takes at most"):
                tquery._query_launch_unit(28, dtype, ptrs, u)
    with pytest.raises(ValueError, match="this launch takes at most 4"):
        tquery._query_launch_unit(28, dtype, ((1 << 20) + 4, 1 << 21), 8)
    for bad in (0, 1, 3, 12, 32, "16", 16.0, True) + ((2,) if dtype == F32 else ()):
        with pytest.raises(ValueError, match="must be one of"):
            tquery._query_launch_unit(28, dtype, ptrs, bad)


def test_query_unit_launches_are_counted_by_unit():
    assert set(tquery.QUERY_FWD_UNIT_LAUNCHES) == {"f32 16", "f32 8", "f32 4", "bf16 16", "bf16 8",
                                                   "bf16 4", "bf16 2"}


def test_query_forward_cuda_refuses_cpu_tensors_and_bad_units():
    pt = stt.N3Tree(N=2, data_dim=4, depth_limit=3, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tquery.query_forward_cuda(pt._spec(), torch.zeros(5, 4), torch.zeros(4, 3), unit=16)


@pytest.fixture(scope="module")
def scene():
    """A JAX tree with a third of its leaves empty, its port, and query
    points: every leaf centre, a duplicated fifth of them, and random
    points, in a seeded order."""
    rng = np.random.RandomState(31)
    jt, feats, _ = build_tree(rng, data_format="RGBA", data_dim=4, depth_limit=5,
                              occupy=lambda c: c[:, 1] < 0.66)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    local = jt[:].corners_local + 0.5 * jt[:].lengths_local[:, None]
    centres = np.asarray(jax.device_get(jt.tree2world(jnp.asarray(local))), np.float32)
    pts = np.concatenate([centres, centres[rng.choice(len(centres), len(centres) // 5, replace=False)],
                          rng.rand(200, 3).astype(np.float32)])
    return jt, pt, pts[rng.permutation(len(pts))], len(feats), rng


@pytest.mark.parametrize("D", [1, 4, 5, 28])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_matches_jax_at_each_width(scene, D, dtype):
    jt, pt, pts, n_rows, rng = scene
    f = rng.randn(int(n_rows * 0.8), D).astype(np.float32)  # the last rows' leaves read as empty
    fj = jnp.asarray(f).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ft = torch.from_numpy(np.array(fj.astype(jnp.float32))).to(getattr(torch, dtype))
    jv, jn, jd = jquery.query(jt._spec(), fj, jnp.asarray(pts), True)
    tv, tn, td = tquery.query(pt._spec(), ft, torch.from_numpy(pts))
    assert tv.dtype == ft.dtype
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    empty = (td < 0) | (td >= f.shape[0])
    assert bool(empty.any()) and bool((~empty).any())
    assert not bool(tv[empty].any())
    if dtype == "float32":
        G = rng.randn(len(pts), D).astype(np.float32)
        gj = jax.grad(lambda x: jnp.sum(jquery.query(jt._spec(), x, jnp.asarray(pts), True)[0] * G))(fj)
        x = ft.clone().requires_grad_()
        (gt,) = torch.autograd.grad((tquery.query(pt._spec(), x, torch.from_numpy(pts))[0]
                                     * torch.from_numpy(G)).sum(), x)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(np.asarray(gj)).max())))


# (D, dtype, address offsets in bytes of (value gradients, float32 gradient), want).
BWD_UNIT_CASES = [
    (28, F32, (0, 0), 16), (4, F32, (0, 0), 16), (6, F32, (0, 0), 8), (3, F32, (0, 0), 4),
    (28, F32, (8, 0), 8), (28, F32, (4, 0), 4), (28, F32, (0, 8), 8), (28, F32, (0, 4), 4),
    (28, BF16, (0, 0), 8), (4, BF16, (0, 0), 8), (6, BF16, (0, 0), 4), (3, BF16, (0, 0), 2),
    (28, BF16, (4, 0), 4), (28, BF16, (2, 0), 2), (28, BF16, (0, 8), 4), (28, BF16, (0, 4), 2),
]


@pytest.mark.parametrize("D,dtype,offs,want", BWD_UNIT_CASES)
def test_query_bwd_unit_rule(D, dtype, offs, want):
    ptrs = tuple((1 << 20) + o for o in offs)
    assert tquery.query_bwd_unit(D, dtype, ptrs) == want


def test_query_bwd_unit_launches_are_counted_by_unit():
    assert set(tquery.QUERY_BWD_UNIT_LAUNCHES) == {"f32 16", "f32 8", "f32 4", "bf16 8", "bf16 4", "bf16 2"}


def test_query_backward_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tquery.query_backward_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 6), 5, unit=8)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (float32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.exp2(e - 7)


@pytest.mark.parametrize("D", [6, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_backward_matches_jax_vjp_at_narrow_units(scene, D, dtype):
    """The port's query gradient against `jax.vjp` of the JAX query, at rows
    whose width takes the 8- and 4-byte units (float32 D = 6, 3; bf16 4 and
    2): float32 within 1e-5 * max(1, max|g|); bf16 (the JAX sum of a row's
    k gradients in bf16, rounded k - 1 times, the port's in float32 cast
    once) within max(k - 1, 1) bf16 ulps of the sum of their magnitudes
    plus that."""
    jt, pt, pts, n_rows, rng = scene
    f = rng.randn(int(n_rows * 0.8), D).astype(np.float32)
    bf = dtype == "bfloat16"
    fj = jnp.asarray(f).astype(jnp.bfloat16 if bf else jnp.float32)
    ft = torch.from_numpy(np.array(fj.astype(jnp.float32))).to(getattr(torch, dtype))
    G = rng.randn(len(pts), D).astype(np.float32)
    Gj = jnp.asarray(G).astype(fj.dtype)
    unit = tquery.query_bwd_unit(D, ft.dtype, (1 << 20, 1 << 20))
    assert unit == {("float32", 6): 8, ("float32", 3): 4, ("bfloat16", 6): 4, ("bfloat16", 3): 2}[dtype, D]
    _, vjp = jax.vjp(lambda x: jquery.query(jt._spec(), x, jnp.asarray(pts), True)[0], fj)
    (gj,) = vjp(Gj)
    gj = np.asarray(gj.astype(jnp.float32))
    x = ft.clone().requires_grad_()
    (gt,) = torch.autograd.grad((tquery.query(pt._spec(), x, torch.from_numpy(pts))[0]
                                 * torch.from_numpy(np.asarray(Gj.astype(jnp.float32))).to(ft.dtype)).sum(), x)
    assert gt.dtype == ft.dtype
    gt = gt.float().numpy()
    tol = 1e-5 * max(1.0, float(np.abs(gj).max()))
    if bf:
        rows = tquery.query(pt._spec(), ft, torch.from_numpy(pts))[2].numpy()
        ok = (rows >= 0) & (rows < len(f))
        k = np.bincount(rows[ok], minlength=len(f))
        mag = np.zeros_like(f)
        np.add.at(mag, rows[ok], np.abs(np.asarray(Gj.astype(jnp.float32)))[ok])
        tol = tol + np.maximum(k - 1, 1)[:, None] * _bf16_ulp(np.maximum(mag, np.abs(gt)))
    assert np.all(np.abs(gt - gj) <= tol)
    assert np.abs(gj).max() > 0
