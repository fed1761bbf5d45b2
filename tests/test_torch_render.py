"""svox_t_tpu_torch's forward march and VolumeRenderer against the JAX
package (`backend="tree"` specs, CPU).

Tolerance: outputs agree to atol 1e-5. The JAX march forms the
transmittance L as a per-round cumulative product over its K-sample
rounds, while the port multiplies per sample, so the two round
differently by a few ulps. In fast mode, rays whose L lands within 1e-6
of stop_thresh are left out of the comparison: there that rounding can
move the stop sample by one.

The golden images (tests/fixtures, rendered by the JAX package) are held
at atol 3e-5, not the 1e-5 of tests/test_golden.py. Measured on those
scenes, the JAX package's own sample-at-a-time oracle and its production
march already differ by up to 1.7e-5 (the jitted ray setup rounds
1/|d| differently from IEEE division), and the goldens carry the
production march's rounding; the port's IEEE arithmetic lands within
2.3e-5 of them. On the JAX package's own camera rays each ray of the
port's march is within ATOL of the nearer of the oracle and the
production march (see test_golden_scenes_march_matches_jax_oracle).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from benchmarks import scenes as jscenes
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops.reference_renderer import volume_render_oracle
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera

from helpers import build_tree, make_rays

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed, fmt="RGBA", ddim=4, n_rays=200, toward_center=True, N=2):
    rng = np.random.RandomState(seed)
    jt, feats, _ = build_tree(rng, N=N, data_format=fmt, data_dim=ddim,
                              depth_limit=5, sigma_scale=20.0)
    rays = make_rays(rng, n_rays, toward_center=toward_center)
    return rng, jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu"), np.array(feats), rays


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _compare(got, want, stop_thresh=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(len(got), bool)
    if stop_thresh > 0:
        near = lambda a: np.abs(a[:, -1] - (1.0 - stop_thresh)) < 1e-6
        keep = ~(near(got) | near(want))
        assert keep.mean() > 0.9
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL)


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH4", 13), ("SH9", 28)])
@pytest.mark.parametrize("fast", [False, True])
def test_forward_matches_jax(fmt, ddim, fast):
    rng, jt, pt, feats, rays = _scene(1 + ddim, fmt, ddim)
    want = st.VolumeRenderer(jt, backend="tree")(jnp.asarray(feats), rays, fast=fast)
    got = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays), fast=fast)
    _compare(got, want, 1e-2 if fast else 0.0)
    assert np.asarray(want)[:, -1].max() > 0.5  # rays really composite


@pytest.mark.parametrize("fast", [False, True])
def test_forward_matrices_match_jax(fast):
    rng, jt, pt, feats, rays = _scene(2, "SH4", 13)
    M = len(feats)
    q = rng.randn(M, 3, 3).astype(np.float32)
    rot = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    rot[:, :3, :3] = np.linalg.qr(q)[0]
    want = st.VolumeRenderer(jt, backend="tree")(jnp.asarray(feats), rays, jnp.asarray(rot), fast=fast)
    got = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays), _t(rot), fast=fast)
    _compare(got, want, 1e-2 if fast else 0.0)
    plain = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays), fast=fast)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the rotation matters


def test_forward_window_background_max_steps_match_jax():
    """A [min_comp, max_comp] window, a grey background and a ragged step
    cap (37 is no multiple of the JAX round size)."""
    rng, jt, pt, feats, rays = _scene(3, "SH9", 28)
    kw = dict(min_comp=1, max_comp=5, background_brightness=0.3, max_steps=37)
    want = st.VolumeRenderer(jt, backend="tree", **kw)(jnp.asarray(feats), rays)
    got = stt.VolumeRenderer(pt, **kw, backend="tree")(_t(feats), _trays(rays))
    _compare(got, want)
    full = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays))
    assert np.abs(got.numpy() - full.numpy()).max() > 1e-3


@pytest.mark.parametrize("fmt,width", [("SG", 4), ("ASG", 11)])
def test_forward_sg_asg_plain_match_jax(fmt, width):
    rng = np.random.RandomState(4)
    extra = rng.rand(4, width).astype(np.float32)
    for a in range(1 if width == 4 else 2, width, 3):
        extra[:, a:a + 3] /= np.linalg.norm(extra[:, a:a + 3], axis=1, keepdims=True)
    jt, feats, _ = build_tree(rng, data_format=f"{fmt}4", data_dim=13, extra_data=extra)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    rays = make_rays(rng, 100)
    want = st.VolumeRenderer(jt, backend="tree")(feats, rays)
    got = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays))
    _compare(got, want)


def test_forward_misses_and_empty_pool_match_jax():
    rng, jt, pt, feats, rays = _scene(5, "SH4", 13, toward_center=False)
    jr, tr = st.VolumeRenderer(jt, backend="tree"), stt.VolumeRenderer(pt, backend="tree")
    want = np.asarray(jr(jnp.asarray(feats), rays))
    got = tr(_t(feats), _trays(rays)).numpy()
    _compare(got, want)
    miss = want[:, -1] == 0
    assert miss.any() and (~miss).any()
    np.testing.assert_array_equal(got[miss], want[miss])
    empty = np.zeros((0, 13), np.float32)
    want0 = np.asarray(jr(jnp.asarray(empty), rays))
    got0 = tr(_t(empty), _trays(rays)).numpy()
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got0[:, :-1], 1.0)
    np.testing.assert_array_equal(got0[:, -1], 0.0)


def test_forward_n3_tree_matches_oracle():
    rng, jt, pt, feats, rays = _scene(6, "SH4", 13, N=3)
    opt = st.VolumeRenderer(jt, backend="tree")._get_options(False)
    want = volume_render_oracle(jt._spec(), jnp.asarray(feats), rays.origins, rays.dirs, rays.viewdirs, opt)
    got = stt.VolumeRenderer(pt, backend="tree")(_t(feats), _trays(rays))
    _compare(got, want)


def test_cam2world_rays_and_world2ndc_match_jax():
    c2w = orbit_camera(0.7, 0.3, 2.5)
    jo, jd = jrender.cam2world_rays(jnp.asarray(c2w), 24, 16, 20.0, 22.0)
    to, td = trender.cam2world_rays(_t(c2w), 24, 16, 20.0, 22.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    opt = st.RenderOptions(ndc_width=24, ndc_height=16, ndc_focal=20.0)
    jnd, jno = jrender.world2ndc(opt, jd, jo)
    tnd, tno = trender.world2ndc(stt.RenderOptions(ndc_width=24, ndc_height=16, ndc_focal=20.0), td, to)
    np.testing.assert_allclose(tnd.numpy(), np.asarray(jnd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tno.numpy(), np.asarray(jno), rtol=1e-5, atol=1e-5)
    ro, rd = st.convert_to_ndc(jo, jd, 20.0, 24, 16)
    po, pd = stt.convert_to_ndc(to, td, 20.0, 24, 16)
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)


def test_ndc_render_matches_jax():
    """NDC rays start on the cube's faces and cross cells near their
    corners, where one ulp of ray setup moves a sample across a cell
    boundary. The JAX march rounds delta_scale = 1/|d| through its jitted
    rsqrt (0.99999994 for a unit direction where IEEE division gives 1.0),
    so a few samples land in the neighbouring cell: the comparison uses
    the gates of tests/test_render.py::test_ndc_march_matches_anchored_oracle
    (max < 5e-3, under 5% of elements beyond ATOL)."""
    rng, jt, pt, feats, _ = _scene(7, "SH1", 4)
    ndc = st.NDCConfig(width=20, height=20, focal=10.0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.5, 0.5, 0.2]
    jr = st.VolumeRenderer(jt, backend="tree", ndc=ndc)
    tr = stt.VolumeRenderer(pt, ndc=stt.NDCConfig(*ndc), backend="tree")
    opt = jr._get_options(False)
    o, d = jrender.cam2world_rays(jnp.asarray(c2w), 12, 12, 12.0, 12.0)
    nd, no = jrender.world2ndc(opt, d, o)
    march_j = np.asarray(jrender.volume_render(jt._spec(), jnp.asarray(feats), no, nd, d, opt))
    march_t = trender.volume_render(pt._spec(), _t(feats), _t(no), _t(nd), _t(d), tr._get_options(False)).numpy()
    img_j = np.asarray(jr.render_persp(jnp.asarray(feats), c2w, 12, 12, fx=12.0)).reshape(-1, 2)
    img_t = tr.render_persp(_t(feats), c2w, 12, 12, fx=12.0).numpy().reshape(-1, 2)
    for got, want in ((march_t, march_j), (img_t, img_j)):
        diff = np.abs(got - want)
        assert diff.max() < 5e-3 and (diff > ATOL).mean() < 0.05
        assert got[:, -1].max() > 0.05


def test_render_persp_matches_jax_and_forward():
    rng, jt, pt, feats, _ = _scene(8, "SH4", 13)
    c2w = orbit_camera(0.2, 0.5, 2.0)
    want = np.asarray(st.VolumeRenderer(jt, backend="tree").render_persp(
        jnp.asarray(feats), c2w, 20, 16, fx=24.0, fast=True))
    tr = stt.VolumeRenderer(pt, backend="tree")
    got = tr.render_persp(_t(feats), c2w, 20, 16, fx=24.0, fast=True).numpy()
    assert got.shape == (16, 20, 4)
    # Each package generates its rays in its own program (see the module
    # docstring): held at the golden images' 3e-5.
    np.testing.assert_allclose(got, want, atol=3e-5)
    o, d = trender.cam2world_rays(_t(c2w), 20, 16, 24.0, 24.0)
    per_ray = tr(_t(feats), stt.Rays(o, d, d), fast=True).numpy()
    np.testing.assert_array_equal(got.reshape(-1, 4), per_ray)
    cost = tr.render_persp(_t(feats), c2w, 20, 16, fx=24.0, fast=True, schedule="cost").numpy()
    np.testing.assert_array_equal(cost, got)


@pytest.mark.parametrize("name,depth,fmt,ddim,size", [
    ("golden_config1", 3, "RGBA", 4, 100),
    ("golden_config2", 7, "SH9", 28, 96),
])
def test_golden_images_through_port(name, depth, fmt, ddim, size):
    z = np.load(os.path.join(FIX, f"{name}.npz"))
    state, feats, _ = build_shell_tree(depth=depth, data_format=fmt, data_dim=ddim)
    tree = stt.tree_from_numpy(state, device="cpu")
    img = stt.VolumeRenderer(tree).render_persp(
        torch.from_numpy(feats), orbit_camera(), width=size, height=size, fx=float(size)
    ).numpy()
    np.testing.assert_allclose(img, z["img"], atol=3e-5)


@pytest.mark.parametrize("depth,fmt,ddim,size", [(3, "RGBA", 4, 100), (7, "SH9", 28, 96)])
def test_golden_scenes_march_matches_jax_oracle(depth, fmt, ddim, size):
    """On the golden scenes and the JAX package's own camera rays, every
    ray of the port's march holds ATOL against the nearer of the JAX
    package's two marches: its sample-at-a-time oracle and its production
    march, which themselves disagree beyond ATOL on at most one ray of
    each scene.

    The two JAX marches round differently: the production march forms L
    as a per-round cumulative product (up to 1.68e-5 from the oracle on
    the SH9 scene), and XLA contracts its sample position ``o + t * d``
    into one fused multiply-add where the oracle rounds the product and
    the sum apart (1.04e-5 on the RGBA scene). The port multiplies L per
    sample, as the oracle does, and rounds its sample position once, as
    the production march does (`ops/render.py` `sample_position`): the
    baked backend's fast mode starts rays on the occupied box's faces,
    where that rounding picks the cell."""
    jt, jf = jscenes.build_shell_tree(depth=depth, data_format=fmt, data_dim=ddim)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    o, d = jrender.cam2world_rays(jnp.asarray(orbit_camera()), size, size, float(size), float(size))
    opt = st.VolumeRenderer(jt, backend="tree")._get_options(False)
    oracle = np.asarray(volume_render_oracle(jt._spec(), jf, o, d, d, opt))
    prod = np.asarray(jrender.volume_render(jt._spec(), jf, o, d, d, opt))
    assert (np.abs(prod - oracle).max(axis=1) > ATOL).sum() <= 1
    got = trender.volume_render(pt._spec(), _t(jf), _t(o), _t(d), _t(d),
                                stt.VolumeRenderer(pt, backend="tree")._get_options(False)).numpy()
    nearer_oracle = np.abs(got - oracle).max(axis=1) <= np.abs(got - prod).max(axis=1)
    _compare(got, np.where(nearer_oracle[:, None], oracle, prod))


def test_requires_grad_flows():
    """A pool that requires grad trains: gradients flow through forward
    and render_persp, and no_grad renders stay detached."""
    rng, jt, pt, feats, rays = _scene(9)
    f = _t(feats).requires_grad_()
    r = stt.VolumeRenderer(pt, backend="tree")
    out = r(f, _trays(rays))
    assert out.requires_grad and out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), f)
    assert g.shape == f.shape and bool(torch.isfinite(g).all()) and g.abs().max() > 0
    img = r.render_persp(f, orbit_camera(), 8, 8, fx=8.0)
    (gi,) = torch.autograd.grad(img[..., :3].sum(), f)
    assert gi.abs().max() > 0
    with torch.no_grad():
        out = r(f, _trays(rays))
    assert out.shape == (200, 4) and not out.requires_grad


def test_unported_options_raise():
    """The options that once raised here now render: an int8 quantized
    pool (K5; it raised NotImplementedError before) equals the JAX
    package's render of the same pool within ATOL and takes no gradient;
    weight accumulation collects weights."""
    rng, jt, pt, feats, rays = _scene(10)
    r = stt.VolumeRenderer(pt, backend="tree")
    jq = st.quantize_features(jnp.asarray(feats))
    qf = stt.quantized_from_numpy(*(np.asarray(a) for a in jq), device="cpu")
    out = r(qf, _trays(rays))
    want = jrender.volume_render(jt._spec(), jq, *(jnp.asarray(x) for x in rays),
                                 st.VolumeRenderer(jt, backend="tree")._get_options(False))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not out.requires_grad and float(out[:, -1].max()) > 0.5
    # Weight accumulation, which raised here before, now collects weights.
    with pt.accumulate_weights() as acc:
        out = r(_t(feats), _trays(rays))
    np.testing.assert_array_equal(out.numpy(), r(_t(feats), _trays(rays)).numpy())
    assert acc().shape == (pt.n_leaves,) and float(acc().sum()) > 0


def test_kernel_wrapper_rejects_cpu_and_wide_colors():
    """The kernel wrappers launch or raise; they never run the plain
    version in their place. An SG render needs its lobes (extra_data),
    and more than 16 color channels (here an RGBA pool of 18 columns) are
    past what the kernels hold in registers."""
    rng, jt, pt, feats, rays = _scene(11, "SH4", 13)
    opt = stt.VolumeRenderer(pt, backend="tree")._get_options(False)
    trays = [_t(r) for r in rays]
    with pytest.raises(ValueError, match="CUDA"):
        trender.volume_render_cuda(pt._spec(), _t(feats), *trays, opt)
    sg = stt.RenderOptions(format=stt.utils.spec.FORMAT_SG, basis_dim=4)
    with pytest.raises(ValueError, match="extra_data"):
        trender.volume_render_cuda(pt._spec(), _t(feats), *trays, sg)
    wide = torch.zeros(len(feats), 18)
    rgba = stt.RenderOptions(format=stt.utils.spec.FORMAT_RGBA, basis_dim=-1)
    for call in (trender.volume_render_cuda, trender.volume_render_with_weight_accum_cuda):
        with pytest.raises(NotImplementedError, match="16 color channels"):
            call(pt._spec(), wide, *trays, rgba)
    with pytest.raises(NotImplementedError, match="16 color channels"):
        trender.volume_render_backward_cuda(pt._spec(), wide, *trays, torch.zeros(len(trays[0]), 18), rgba)


@pytest.mark.parametrize("fmt,bd,D,pool_off,elem,extra_offs,want", [
    ("SH", 9, 28, 0, 4, (), 4), ("SH", 9, 28, 0, 2, (), 4), ("SH", 9, 28, 0, 1, (0, 0), 4),
    ("SH", 1, 4, 0, 4, (), 4), ("RGBA", 0, 4, 0, 4, (), 4), ("RGBA", 0, 4, 0, 1, (0, 0), 4),
    ("SH", 4, 13, 0, 4, (), 1), ("SH", 9, 32, 0, 4, (), 1), ("SH", 16, 49, 0, 4, (), 1),
    ("SG", 9, 28, 0, 4, (), 1), ("ASG", 9, 28, 0, 2, (), 1), ("RGBA", 0, 8, 0, 4, (), 1),
    ("SH", 9, 28, 4, 4, (), 1), ("SH", 9, 28, 16, 4, (), 4), ("SH", 9, 28, 4, 2, (), 1),
    ("SH", 9, 28, 8, 2, (), 4), ("SH", 9, 28, 2, 1, (0, 0), 1), ("SH", 9, 28, 4, 1, (0, 0), 4),
    ("SH", 9, 28, 0, 1, (8, 0), 1), ("SH", 9, 28, 0, 4, (64,), 4), ("SH", 9, 28, 0, 4, (4,), 1),
    ("SH", 9, 28, 0, 2, (12,), 1), ("SH", 9, 28, 0, 1, (0, 0, 32), 4)])
def test_render_fwd_width(fmt, bd, D, pool_off, elem, extra_offs, want):
    """K2's vector width from the format, basis and row width and the
    alignment of its pointers (fake ones): 4 for the three-colour RGBA, SH1
    and SH9 rows with no spare column whose pool lies on a 4-value
    boundary and whose float32 pointers (an int8 pool's scale and zero, the
    rotation matrices) lie on 16 bytes, else 1; K13c takes the same."""
    base = 1 << 20
    code = {"RGBA": stt.utils.spec.FORMAT_RGBA, "SH": stt.utils.spec.FORMAT_SH,
            "SG": stt.utils.spec.FORMAT_SG, "ASG": stt.utils.spec.FORMAT_ASG}[fmt]
    ptrs = [base + 4096 * (k + 1) + off for k, off in enumerate(extra_offs)]
    assert trender.render_fwd_width(code, bd, D, base + pool_off, elem, ptrs) == want
