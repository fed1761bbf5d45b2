"""svox_t_tpu_torch's feature pools in their own type (K5) against the JAX
package, on the CPU: int8 quantized pools (`quantize_features`) and bf16
pools through every entry point that takes a pool, on both backends,
nearest and trilinear. The same seeded NumPy pools, trees and rays go to
both packages; an int8 pool moves across with `quantized_from_numpy`.

Tolerances, each with its reason:

* `quantize_features`: q, scale and zero exact (both packages divide
  truly and round half to even).
* Dequantization: XLA on the CPU contracts the JAX source's
  ``q * scale + zero`` (a multiply, then an add) into one fused
  multiply-add, while the port rounds the product and the sum separately,
  as that source writes them; counted here, the two differ by at most two
  float32 ulps of the larger of the product and the zero point, on a share
  of a seeded pool's values (`test_dequantize_ulps`).
  The kernels stay equal to the port's plain version bit for bit.
* Outputs of int8 and bf16 renders: atol 1e-5 (the float32 tests' ATOL;
  the march's per-round products differ by a few ulps, and the
  dequantization by the ulp above).
* First-hit depth over an int8 pool: a dequantized sigma one ulp off can
  move a first hit (the JAX package's own quantized test allows 10% of
  rays); 90% of rays must hit the same row in both, and depths are
  compared where they do and that row's sigma dequantizes to the same
  float bit for bit.
* bf16 gradients come back as bf16. Both packages sum in float32 (to
  1e-5 * max(1, max|g|) of each other, as the float32 tests hold them)
  and cast once, so each element is within that plus one bf16 ulp of
  JAX's. JAX's point query sums a bf16 pool's gradient in bf16 (a rounding
  per add), the port in float32: a row that k points add into is allowed k
  ulps of the sum of its terms' magnitudes (no partial sum is larger).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.utils.scenes import joint_pose_sequence, skin_to_nearest_joints

from helpers import build_tree, make_rays

ATOL = 1e-5
J, KD, NB = 5, 6, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed, fmt="SH4", ddim=13, n_rays=160):
    rng = np.random.RandomState(seed)
    joints = rng.rand(J, 3).astype(np.float32)
    jt, feats, _ = build_tree(rng, data_format=fmt, data_dim=ddim, depth_limit=5,
                              sigma_scale=20.0, extra_data=joints)
    feats = np.array(feats)
    M = feats.shape[0]
    rays = make_rays(rng, n_rays)
    lbs = dict(jf=rng.randn(J, KD).astype(np.float32),
               sw=(rng.rand(M, NB) - 0.2).astype(np.float32),
               ji=rng.randint(0, J, (M, NB)).astype(np.int32))
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    return jt, pt, feats, rays, lbs


def _quantized(feats):
    """(JAX QuantizedFeatures, the port's copy of it)."""
    jq = st.quantize_features(jnp.asarray(feats))
    return jq, stt.quantized_from_numpy(*(np.asarray(a) for a in jq), device="cpu")


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _jrays(rays):
    return st.Rays(*(jnp.asarray(r) for r in rays))


def _renderers(jt, pt, backend, interp):
    return (st.VolumeRenderer(jt, backend="tree", interp=interp),
            stt.VolumeRenderer(pt, backend=backend, interp=interp))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.frexp(np.maximum(np.abs(x), 1e-30))[1]
    return np.ldexp(1.0, e - 8)


def _assert_bf16_grad(got, want, k=1, scale=None):
    """``got`` (a bf16 tensor) within k bf16 ulps of JAX's bf16 ``want``
    plus the float32 sums' tolerance; the ulps are taken at ``scale``
    where given (default: the larger of the two values)."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    at = np.maximum(np.abs(g), np.abs(w)) if scale is None else scale
    tol = k * _bf16_ulp(at) + 1e-5 * max(1.0, np.abs(w).max())
    bad = np.abs(g - w) > tol
    assert not bad.any(), f"{bad.sum()} elements off by more than {k} bf16 ulp"
    assert np.abs(w).max() > 0


@pytest.mark.parametrize("case", ["random", "flat_channel", "empty"])
def test_quantize_features_matches_jax(case):
    rng = np.random.RandomState(60)
    f = (rng.randn(3000, 13) * 3.0).astype(np.float32)
    f[:, -1] = np.abs(f[:, -1]) * 20.0
    if case == "flat_channel":
        f[:, 2] = 0.75           # hi == lo: scale falls back to 1e-12 / 254
        f[::7, 5] = 0.0          # ties
    elif case == "empty":
        f = f[:0]
    jq = st.quantize_features(jnp.asarray(f))
    tq = stt.quantize_features(torch.from_numpy(f))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == tq.zero.dtype == torch.float32
    for name, a, b in zip(("q", "scale", "zero"), jq, tq):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if case != "empty":
        assert np.abs(tq.q.numpy()).max() == 127


def test_dequantize_ulps():
    """XLA contracts the JAX dequantization into a fused multiply-add
    (equal to the float64 product and sum rounded once); the port rounds
    the product first, so the two differ by at most two ulps of the larger
    of the product and the zero point (the product's rounding and the
    sum's; more ulps of the result where the sum cancels toward 0)."""
    rng = np.random.RandomState(61)
    f = (rng.randn(4000, 28) * 0.5).astype(np.float32)
    f[:, -1] = np.abs(f[:, -1]) * 20.0
    jq, tq = _quantized(f)
    idx = jnp.arange(f.shape[0])
    pf = jrender._pack_features(jq)
    want = np.asarray(jax.jit(lambda i: jrender._gather_features(pf, i))(idx))
    got = tq.dequantize().numpy()
    q, scale, zero = (np.asarray(a) for a in jq)
    np.testing.assert_array_equal(want, (q.astype(np.float64) * scale + zero).astype(np.float32))
    prod = q.astype(np.float32) * scale
    ulp = np.spacing(np.maximum(np.abs(prod), np.abs(zero)))
    assert (np.abs(got - want) <= 2 * ulp).all()
    share = (got != want).mean()
    assert 0.0 < share < 0.3, share
    np.testing.assert_array_equal(got, trender.gather_rows(tq, torch.arange(f.shape[0])).numpy())
    np.testing.assert_array_equal(got, (prod + zero))


@pytest.mark.parametrize("fmt,ddim,interp", [("RGBA", 4, "nearest"), ("SH4", 13, "trilinear"),
                                             ("SH9", 28, "nearest"), ("RGBA", 4, "trilinear")])
def test_int8_forward_matches_jax(fmt, ddim, interp):
    """`forward` and `render_persp` over an int8 pool on both backends
    against the JAX package's tree walk, exact and fast; no gradient."""
    jt, pt, feats, rays, _ = _scene(62 + ddim, fmt, ddim)
    jq, tq = _quantized(feats)
    for fast in (False, True):
        want = np.asarray(st.VolumeRenderer(jt, backend="tree", interp=interp)(
            jq, _jrays(rays), fast=fast))
        for backend in ("tree", "baked"):
            r = stt.VolumeRenderer(pt, backend=backend, interp=interp)
            out = r(tq, _trays(rays), fast=fast)
            assert not out.requires_grad
            if fast and backend == "baked":
                continue  # fast mode differs between the backends (skip boxes), as in JAX
            keep = np.abs(want[:, -1] - (1.0 - 1e-2)) >= 1e-6 if fast else slice(None)
            np.testing.assert_allclose(out.numpy()[keep], want[keep], atol=ATOL, rtol=0)
    c2w = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, 2.2]], np.float32)
    want = np.asarray(st.VolumeRenderer(jt, backend="tree", interp=interp).render_persp(
        jq, c2w, 12, 10, fx=14.0))
    img = stt.VolumeRenderer(pt, interp=interp).render_persp(tq, c2w, 12, 10, fx=14.0)
    np.testing.assert_allclose(img.numpy(), want, atol=ATOL, rtol=0)
    assert want[..., -1].max() > 0.5


@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_int8_aux_passes_match_jax(backend, interp):
    """`opacity_render`, `render_depth`, `motion_render` and
    `motion_feature_render` over an int8 pool; the pool takes no gradient,
    the joint features take JAX's."""
    jt, pt, feats, rays, lbs = _scene(66, "SH4", 13)
    jq, tq = _quantized(feats)
    jr, tr = _renderers(jt, pt, backend, interp)
    trays, jrays = _trays(rays), _jrays(rays)
    alpha = tr.opacity_render(tq, trays)
    assert not alpha.requires_grad
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jr.opacity_render(jq, jrays)), atol=ATOL)

    want = [np.asarray(x) for x in jr.motion_render(jq, jrays)]
    got = [x.numpy() for x in tr.motion_render(tq, trays)]
    np.testing.assert_array_equal(tr.render_depth(tq, trays).numpy(), got[1])
    # Depths where both hit the same row and its sigma dequantizes alike.
    sig_port = tq.dequantize().numpy()[:, -1]
    sig_jax = (np.asarray(jq.q[:, -1]).astype(np.float64) * float(jq.scale[-1])
               + float(jq.zero[-1])).astype(np.float32)
    found_t, found_j = got[1][:, 0] > 0, want[1][:, 0] > 0
    same = (got[3][:, 0] == want[3][:, 0]) & (found_t == found_j)
    rows = np.where(found_j, want[3][:, 0], 0)
    alike = same & (~found_j | (sig_port[rows] == sig_jax[rows]))
    assert same.mean() > 0.9 and found_j[alike].sum() > 10
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[alike], w[alike], atol=ATOL)

    jf = jnp.asarray(lbs["jf"])
    args = (lbs["sw"], lbs["ji"])
    mf_j, g_j = jax.value_and_grad(
        lambda x: jnp.sum(jr.motion_feature_render(jq, x, *args, jrays) ** 2))(jf)
    x = _t(lbs["jf"]).requires_grad_()
    mf = tr.motion_feature_render(tq, x, *(_t(a) for a in args), trays)
    (g,) = torch.autograd.grad((mf ** 2).sum(), x)
    np.testing.assert_allclose(float((mf ** 2).sum()), float(mf_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-5 * max(1.0, np.abs(g_j).max()))
    assert np.abs(np.asarray(g_j)).max() > 0


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13)])
def test_bf16_forward_and_grad_match_jax(fmt, ddim):
    """A bf16 pool (faults F2, F3 of the plain path): the forward within
    ATOL of JAX's, which widens each gathered row to float32 first; the
    gradient comes back bf16, summed in float32 and cast once as JAX does,
    on both backends, nearest and trilinear."""
    jt, pt, feats, rays, _ = _scene(5 if fmt == "RGBA" else 3, fmt, ddim)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    for interp in ("nearest", "trilinear"):
        jr = st.VolumeRenderer(jt, backend="tree", interp=interp)
        out_j, g_j = jax.value_and_grad(lambda f: jnp.sum(jr(f, _jrays(rays)) ** 2))(fb)
        want = np.asarray(jr(fb, _jrays(rays)))
        for backend in ("tree", "baked"):
            f = _t(np.asarray(fb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
            out = stt.VolumeRenderer(pt, backend=backend, interp=interp)(f, _trays(rays))
            assert out.dtype == torch.float32
            np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=0)
            (g,) = torch.autograd.grad((out ** 2).sum(), f)
            _assert_bf16_grad(g, g_j)


def test_bf16_opacity_and_motion_feature_grads_match_jax():
    """bf16 gradients of `opacity_render` (pool) and of
    `motion_feature_render` (bf16 joint features over a bf16 pool)."""
    jt, pt, feats, rays, lbs = _scene(67, "SH4", 13)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    jfb = jnp.asarray(lbs["jf"]).astype(jnp.bfloat16)
    jr, tr = _renderers(jt, pt, "baked", "nearest")
    g_j = jax.grad(lambda f: jnp.sum(jr.opacity_render(f, _jrays(rays)) ** 2))(fb)
    f = _t(np.asarray(fb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    (g,) = torch.autograd.grad((tr.opacity_render(f, _trays(rays)) ** 2).sum(), f)
    _assert_bf16_grad(g, g_j)
    args = (lbs["sw"], lbs["ji"])
    gj_j = jax.grad(lambda x: jnp.sum(jr.motion_feature_render(fb, x, *args, _jrays(rays)) ** 2))(jfb)
    x = _t(np.asarray(jfb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    mf = tr.motion_feature_render(f.detach(), x, *(_t(a) for a in args), _trays(rays))
    assert mf.dtype == torch.float32
    (gx,) = torch.autograd.grad((mf ** 2).sum(), x)
    _assert_bf16_grad(gx, gj_j)


def test_bf16_query_matches_jax():
    """`N3Tree.forward` on a bf16 pool: bf16 values equal to JAX's, and a
    bf16 gradient; rows that k points add into are held to k ulps (JAX
    adds in bf16)."""
    jt, pt, feats, _, _ = _scene(68, "SH4", 13)
    rng = np.random.RandomState(68)
    pts = rng.rand(600, 3).astype(np.float32)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    gv = rng.randn(600, 13).astype(np.float32)
    vals_j, pull = jax.vjp(lambda f: jt(f, jnp.asarray(pts)), fb)
    (g_j,) = pull(jnp.asarray(gv).astype(jnp.bfloat16))
    f = _t(np.asarray(fb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    vals = pt(f, _t(pts))
    assert vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(vals.detach().float().numpy(), np.asarray(vals_j.astype(jnp.float32)))
    (g,) = torch.autograd.grad(vals, f, _t(gv).to(torch.bfloat16))
    rows = pt(f.detach(), _t(pts), want_data_ids=True)[1].numpy()
    hit = rows < feats.shape[0]
    k = np.bincount(rows[hit], minlength=feats.shape[0])
    assert k.max() > 1
    # Each of JAX's k bf16 adds rounds at most half an ulp of its partial
    # sum, which is at most the sum of the terms' magnitudes.
    mag = np.zeros(feats.shape, np.float32)
    np.add.at(mag, rows[hit], np.abs(_t(gv).to(torch.bfloat16).float().numpy()[hit]))
    _assert_bf16_grad(g, g_j, k=np.maximum(k, 1)[:, None], scale=mag)


def test_bf16_dynamic_frames_equal_the_eager_loop():
    """`render_dynamic_frames` over a bf16 pool stack equals the eager loop
    of the public calls on the same bf16 pools, and its gradient comes
    back as bf16."""
    jt, pt, feats, rays, _ = _scene(69, "SH4", 13)
    centers = np.array(jt[:].corners_local + 0.5 * jt[:].lengths_local[:, None], np.float32)
    centers = np.asarray(jt.tree2world(jnp.asarray(centers)))[: feats.shape[0]]
    joints = (0.3 + 0.4 * np.random.RandomState(69).rand(4, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(centers, joints, 2)
    poses = joint_pose_sequence(joints, 2, seed=69)
    src = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    stack = _t(np.stack([feats, feats * 0.9])).to(torch.bfloat16).requires_grad_()
    r = stt.VolumeRenderer(pt, backend="tree")
    out = r.render_dynamic_frames(stack, poses, src, centers, sw, ji, rays=_trays(rays),
                                  update_tree=False)
    (g,) = torch.autograd.grad(out.sum(), stack)
    assert g.dtype == torch.bfloat16 and float(g.float().abs().max()) > 0
    tree = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    eager = stt.VolumeRenderer(tree, backend="tree")
    for k in range(2):
        tk = stt.get_transformation_matrix(_t(src), _t(poses[k]))
        warped, mats = stt.warp_vertices(tk, _t(centers), _t(sw), _t(ji))
        tree.construct_tree(warped)
        want = eager(stack[k].detach(), _trays(rays), transformation_matrices=mats)
        np.testing.assert_array_equal(out[k].detach().numpy(), want.numpy())


def test_every_pool_instance_has_a_compile_unit(tmp_path):
    """Each bf16 and int8 march kernel the wrappers dispatch to is built by
    exactly one compile unit of `_build.units()`: its header with the
    instance's macros, included by a one-line stub; so is each bf16 and
    int8 tape replay kernel (K13c/d, a header with no structure axis)."""
    from svox_t_tpu_torch import _build
    from svox_t_tpu_torch.ops import render_aux as taux
    from svox_t_tpu_torch.ops import tape as ttape

    header = {"render_fwd": "render_fwd", "render_bwd": "render_bwd", "opacity_bwd": "render_bwd",
              "first_hit": "render_aux", "mf_fwd": "render_aux", "mf_bwd": "render_aux"}
    tables = {"render_fwd": trender._FWD_INSTANCES, "render_bwd": trender._BWD_INSTANCES,
              "opacity_bwd": taux._OPACITY_INSTANCES, "first_hit": taux._FIRST_HIT_INSTANCES,
              "mf_fwd": taux._MF_FWD_INSTANCES, "mf_bwd": taux._MF_BWD_INSTANCES}
    want = set()
    for base, table in tables.items():
        for pool in ("bf16", "i8"):
            for kernel in table.get(pool, ()):
                want.add(header[base] + kernel.symbol[len("svox_" + base):])
    for table in (ttape._REPLAY_FWD, ttape._REPLAY_BWD):
        for pool in ("bf16", "i8"):
            if pool in table:
                want.add(table[pool].symbol[len("svox_"):])
    units = {u.name: u for u in _build.units() if u.defines}
    assert set(units) == want and len(want) == 23
    t = units["tape_replay_bwd_bf16"]
    assert set(t.defines) == {"-DSVOX_TAPE_PASS=1", "-DSVOX_SUFFIX=_bf16", "-DSVOX_POOL=svox::PoolBF16"}
    assert t.source == _build.CSRC / "tape_replay.cuh"
    u = units["render_bwd_baked_interp_bf16"]
    assert set(u.defines) == {"-DSVOX_STRUCTURE=svox::Baked", "-DSVOX_SUFFIX=_baked_interp_bf16",
                              "-DSVOX_POOL=svox::PoolBF16", "-DSVOX_INTERP=1"}
    args = _build.source_args(u, tmp_path / "stub.cu")
    assert args[-1] == str(tmp_path / "stub.cu") and f"-I{_build.CSRC}" in args
    assert (tmp_path / "stub.cu").read_text() == '#include "render_bwd.cuh"\n'
    assert (_build.CSRC / "render_bwd.cuh").exists()
