"""svox_t_tpu_torch's cost-ordered ray schedules (K15) and median-cut
quantizer against the JAX package (CPU).

`march_cost` / `ray_costs` on depth-5 shells (`helpers.build_tree`) with
seeded rays, both backends, RGBA and SH9: exact, fast with and without the
density column, under interp and below the step cap. Counts compare exactly
on the rays whose ray setup agrees bit for bit between the packages (the
JAX package's jitted setup rounds 1/|d| through rsqrt, which can move a
sample across a cell face); in fast mode with densities the rays whose
transmittance comes within 1e-6 of stop_thresh are left out too (the two
packages' exp can differ in the last ulp there), and their number is
asserted small. Plans (`plan_rays`, `plan_persp` on a 48x40 camera, the
union plan of `render_dynamic_frames`) equal the JAX package's where all
costs agree; in any case each package's plan is the stable sort of its own
costs over the tile order, and the costs agree on the rays whose setup
does. Planned renders equal the tile
order bit for bit (`render_persp`, `render_persp_frames`,
`render_dynamic_frames`), and the plan cache follows the JAX package's
tests (`tests/test_render.py:872-930`): keyed on the occupancy version,
FIFO past 32. Gradients under a plan agree at ``1e-5 * max(1, max|g|)``.
The quantizer (native and plain) equals the JAX package's (native and
NumPy) exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.native import quantize as jquant
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops import schedule as jsched
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.models import renderer as trenderer
from svox_t_tpu_torch.native import quantize_median_cut, quantize_median_cut_plain
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import schedule as tsched

from helpers import build_tree, make_rays
from test_torch_bake import _same_setup
from test_torch_dynamic import FX, H, W, Scene

FORMATS = {"RGBA": 4, "SH9": 28}
CASES = ("exact", "fast", "fast_sigmas", "interp", "cap")
SIGMA_GAIN = 30.0  # densities that stop rays inside the shell in fast mode
CAM_W, CAM_H, CAM_FX = 48, 40, 60.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _shell(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


@functools.lru_cache(maxsize=None)
def _scene(fmt):
    """(JAX tree, port tree, pool, rays, same-setup mask) of a depth-5 shell."""
    rng = np.random.RandomState(7)
    jt, feats, _ = build_tree(rng, N=2, data_dim=FORMATS[fmt], depth_limit=5, n_random_refines=2,
                              data_format=fmt, occupy=_shell)
    rays = make_rays(rng, 192)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    return jt, pt, np.array(feats), rays, _same_setup(jt, rays)


def _specs(jt, pt, backend):
    if backend == "baked":
        return jt._baked_spec(), pt._baked_spec()
    return jt._spec(), pt._spec()


def _case_options(jt, case):
    opt = st.VolumeRenderer(jt)._get_options(case.startswith("fast"))
    if case == "interp":
        opt = dataclasses.replace(opt, interp=1)
    if case == "cap":
        opt = dataclasses.replace(opt, max_steps=6)
    return opt


def _camera():
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    return c2w


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("case", CASES)
def test_march_cost_matches_jax(fmt, backend, case):
    jt, pt, feats, rays, same = _scene(fmt)
    jspec, tspec = _specs(jt, pt, backend)
    opt = _case_options(jt, case)
    M = feats.shape[0]
    sig = feats[:, -1] * SIGMA_GAIN if case == "fast_sigmas" else None
    want = np.asarray(jsched.ray_costs(jspec, rays.origins, rays.dirs, opt, M,
                                       None if sig is None else jnp.asarray(sig)))
    got = tsched.ray_costs(tspec, _t(rays.origins), _t(rays.dirs), opt, M,
                           None if sig is None else _t(sig))
    assert got.dtype == torch.int32 and got.shape == (len(want),)
    # The plain walk's own view of each ray's stop, and JAX's chunked walk.
    n, margin = tsched.march_cost_plain(
        tspec, _t(rays.origins), _t(rays.dirs), tsched.effective_skip_base(tspec, opt), M,
        opt.step_size, opt.max_steps, opt.interp, opt.box_advance, opt.sigma_thresh,
        opt.stop_thresh, None if sig is None else _t(sig), return_margin=True)
    assert torch.equal(n, got)
    keep = same & (margin.numpy() > 1e-6)
    assert int((~(margin.numpy() > 1e-6)).sum()) <= 4
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    assert same.sum() > len(same) // 2 and want.max() > 0
    chunked = np.asarray(jsched.ray_costs(jspec, rays.origins, rays.dirs, opt, M,
                                          None if sig is None else jnp.asarray(sig), chunk=64))
    np.testing.assert_array_equal(chunked, want)
    if case == "cap":
        assert want.max() == opt.max_steps
    if case == "fast_sigmas":
        free = tsched.ray_costs(tspec, _t(rays.origins), _t(rays.dirs), opt, M)
        assert bool((got < free).any())


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("fast", [False, True])
def test_plan_rays_matches_jax_and_round_trips(backend, fast):
    jt, pt, feats, rays, same = _scene("SH9")
    jr = st.VolumeRenderer(jt, backend=backend)
    tr = stt.VolumeRenderer(pt, backend=backend)
    jp, ji = jr.plan_rays(rays, fast=fast, features=jnp.asarray(feats))
    trays = stt.Rays(*(_t(x) for x in rays))
    tp, ti = tr.plan_rays(trays, fast=fast, features=_t(feats))
    assert tp.dtype == torch.int32 and ti.dtype == torch.int32
    opt = tr._get_options(fast)
    cost = tsched.ray_costs(tr._render_spec(), trays.origins, trays.dirs, opt, feats.shape[0],
                            _t(feats[:, -1])).numpy()
    jcost = np.asarray(jsched.ray_costs(jr._render_spec(), rays.origins, rays.dirs, opt,
                                        feats.shape[0], jnp.asarray(feats[:, -1])))
    if np.array_equal(cost, jcost):
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tp.numpy(), np.argsort(cost, kind="stable"))
    np.testing.assert_array_equal(ti.numpy()[tp.numpy()], np.arange(len(cost)))
    # plan_rays round-trips through forward, bit for bit.
    out0 = tr(_t(feats), trays, fast=fast)
    permuted = stt.Rays(*(x[tp.long()] for x in trays))
    np.testing.assert_array_equal(tr(_t(feats), permuted, fast=fast)[ti.long()].numpy(),
                                  out0.numpy())
    # Gradients under the plan against the JAX package's under its own,
    # on the rays whose setup agrees (a cotangent of 0 elsewhere).
    G = np.random.RandomState(5).randn(len(cost), 4).astype(np.float32) * same[:, None]
    ft = _t(feats).requires_grad_()
    (tr(ft, permuted, fast=fast)[:, -4:] * _t(G)[tp.long()]).sum().backward()
    jperm = st.Rays(*(x[jp] for x in rays))
    gj = np.asarray(jax.grad(lambda f: jnp.sum(jr(f, jperm, fast=fast)[:, -4:] * G[jp]))(
        jnp.asarray(feats)))
    np.testing.assert_allclose(ft.grad.numpy(), gj, atol=_gtol(gj))


def _camera_costs(pkg, spec, opt, n_rows, sigmas, bs):
    """Per-pixel costs of the test camera as a plan costs them, with the
    pixels' rays: JAX ('jax') or port ('port')."""
    c2w = _camera()
    if pkg == "jax":
        o, d = (np.asarray(x) for x in jrender.cam2world_rays(jnp.asarray(c2w), CAM_W, CAM_H,
                                                               CAM_FX, CAM_FX))
    else:
        o, d = (x.numpy() for x in trender.cam2world_rays(torch.as_tensor(c2w), CAM_W, CAM_H,
                                                          CAM_FX, CAM_FX))
    iy, ix = np.meshgrid(np.arange(CAM_H // bs), np.arange(CAM_W // bs), indexing="ij")
    sel = ((iy * bs + bs // 2) * CAM_W + (ix * bs + bs // 2)).ravel()
    if pkg == "jax":
        c = np.asarray(jsched.ray_costs(spec, jnp.asarray(o[sel]), jnp.asarray(d[sel]), opt, n_rows,
                                        None if sigmas is None else jnp.asarray(sigmas)))
    else:
        c = tsched.ray_costs(spec, _t(o[sel]), _t(d[sel]), opt, n_rows,
                             None if sigmas is None else _t(sigmas)).numpy()
    c = np.repeat(np.repeat(c.reshape(CAM_H // bs, CAM_W // bs), bs, 0), bs, 1).ravel()
    return c, o[sel], d[sel]


def _check_plan(tperm, jperm, tcost, jcost, rays_same, opt):
    """A port plan against the JAX package's: equal where every cost
    agrees; else the stable sort of the port's costs over the tile order,
    with the costs equal on the rays whose setup agrees."""
    tperm = tperm.numpy()
    if np.array_equal(tcost, jcost):
        np.testing.assert_array_equal(tperm, np.asarray(jperm))
    tile = trenderer._tile_order(opt, CAM_W, CAM_H, "cpu").numpy()
    np.testing.assert_array_equal(tperm, tile[np.argsort(tcost[tile], kind="stable")])
    np.testing.assert_array_equal(np.asarray(jperm), tile[np.argsort(jcost[tile], kind="stable")])
    np.testing.assert_array_equal(tcost[rays_same], jcost[rays_same])


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("block", [1, 4])
def test_plan_persp_matches_jax(backend, fast, block):
    jt, pt, feats, _, _ = _scene("SH9")
    jr = st.VolumeRenderer(jt, backend=backend)
    tr = stt.VolumeRenderer(pt, backend=backend)
    sig = feats[:, -1] * SIGMA_GAIN
    pool = np.concatenate([feats[:, :-1], sig[:, None]], 1)
    kw = dict(fast=fast, block=block)
    jp, _ = jr.plan_persp(_camera(), CAM_W, CAM_H, CAM_FX, features=jnp.asarray(pool), **kw)
    tp, ti = tr.plan_persp(_camera(), CAM_W, CAM_H, CAM_FX, features=_t(pool), **kw)
    assert tp.dtype == torch.int32 and torch.equal(ti[tp.long()], torch.arange(len(tp), dtype=torch.int32))
    opt = tr._get_options(fast)
    M = feats.shape[0]
    tcost, to, td = _camera_costs("port", tr._render_spec(), opt, M, sig, block)
    jcost, jo, jd = _camera_costs("jax", jr._render_spec(), opt, M, sig, block)
    same = (to == jo).all(1) & (td == jd).all(1) & _same_setup(
        jt, st.Rays(jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(jd)))
    margin = tsched.march_cost_plain(
        tr._render_spec(), _t(to), _t(td), tsched.effective_skip_base(tr._render_spec(), opt), M,
        opt.step_size, opt.max_steps, opt.interp, opt.box_advance, opt.sigma_thresh,
        opt.stop_thresh, _t(sig), return_margin=True)[1].numpy()
    ok = same & (margin > 1e-6)
    bs = block
    ok_px = np.repeat(np.repeat(ok.reshape(CAM_H // bs, CAM_W // bs), bs, 0), bs, 1).ravel()
    _check_plan(tp, jp, tcost, jcost, ok_px, opt)


def _cost_scene(fmt="SH1", ddim=4):
    rng = np.random.RandomState(11)
    jt, feats, centers = build_tree(rng, data_dim=ddim, data_format=fmt)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    return jt, pt, np.array(feats), centers


def test_cost_schedule_bit_exact():
    """render_persp(schedule='cost') renders the tile order's image bit for
    bit, each call's plan cached (one per options)."""
    _, pt, feats, _ = _cost_scene()
    r = stt.VolumeRenderer(pt)
    c2w = _camera()
    for fast in (False, True):
        img0 = r.render_persp(_t(feats), c2w, 48, 40, 60.0, fast=fast)
        img1 = r.render_persp(_t(feats), c2w, 48, 40, 60.0, fast=fast, schedule="cost")
        assert torch.equal(img1, img0)
    assert len(r._plan_cache) == 2
    # The gradient under the plan: the same sums in another order.
    g = torch.from_numpy(np.random.RandomState(3).randn(40, 48, 4).astype(np.float32))
    grads = []
    for schedule in ("tile", "cost"):
        f = _t(feats).requires_grad_()
        (r.render_persp(f, c2w, 48, 40, 60.0, schedule=schedule) * g).sum().backward()
        grads.append(f.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=_gtol(grads[0]))
    assert float(grads[0].abs().max()) > 0


def test_cost_plan_invalidated_by_repointing():
    """construct_tree re-points the tree: the plan cache keys on
    tree._occ_ver, so the next plan is a new one, still bit for bit."""
    _, pt, feats, centers = _cost_scene("RGBA", 4)
    r = stt.VolumeRenderer(pt)
    c2w = _camera()
    r.plan_persp(c2w, 32, 24, 40.0)
    assert len(r._plan_cache) == 1
    pt.construct_tree(_t(centers[: max(4, len(centers) // 2)]))
    r.plan_persp(c2w, 32, 24, 40.0)
    assert len(r._plan_cache) == 2
    img0 = r.render_persp(_t(feats), c2w, 32, 24, 40.0)
    img1 = r.render_persp(_t(feats), c2w, 32, 24, 40.0, schedule="cost")
    assert torch.equal(img1, img0)


def test_cost_plan_cache_fifo_eviction():
    """Past 32 plans the oldest goes first (a 35-pose orbit keeps its
    recent plans)."""
    _, pt, _, _ = _cost_scene("RGBA", 4)
    r = stt.VolumeRenderer(pt)
    keys = []
    for i in range(35):
        c2w = _camera()
        c2w[2, 3] = 2.0 + 0.01 * i
        r.plan_persp(c2w, 16, 12, 20.0)
        keys.append(next(reversed(r._plan_cache)))
    assert len(r._plan_cache) == 33
    assert keys[-1] in r._plan_cache and keys[-2] in r._plan_cache
    assert keys[0] not in r._plan_cache and keys[1] not in r._plan_cache


@pytest.mark.parametrize("cam", ["fixed", "path"])
def test_persp_frames_cost_equals_tile(cam):
    _, pt, feats, _ = _cost_scene()
    r = stt.VolumeRenderer(pt)
    c2w = _camera()
    cams = c2w if cam == "fixed" else np.stack([c2w] * 3)
    if cam == "path":
        cams[1, 0, 3] = 0.1
    stack = _t(np.stack([feats * (1.0 + 0.1 * k) for k in range(3)]))
    a = r.render_persp_frames(stack, cams, 32, 24, 40.0)
    b = r.render_persp_frames(stack, cams, 32, 24, 40.0, schedule="cost")
    assert torch.equal(a, b)
    assert len(r._plan_cache) == (1 if cam == "fixed" else 0)


@pytest.fixture(scope="module")
def dyn():
    return Scene()


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("schedule", ["cost", "union"])
def test_dynamic_schedules_equal_tile(dyn, backend, schedule):
    s = dyn
    r = stt.VolumeRenderer(s.port_tree(), backend=backend)
    kw = dict(c2w=s.c2w, width=W, height=H, fx=FX, update_tree=False, with_depth=True)
    base = r.render_dynamic_frames(_t(s.stack), *s.lbs(), **kw)
    other = r.render_dynamic_frames(_t(s.stack), *s.lbs(), schedule=schedule, **kw)
    assert all(torch.equal(a, b) for a, b in zip(base, other))
    assert len(r._plan_cache) == 1
    # A gradient through the planned loop.
    f = _t(s.stack).requires_grad_()
    g = torch.from_numpy(np.random.RandomState(4).randn(*base[0].shape).astype(np.float32))
    (r.render_dynamic_frames(f, *s.lbs(), schedule=schedule, **kw)[0] * g).sum().backward()
    f0 = _t(s.stack).requires_grad_()
    (r.render_dynamic_frames(f0, *s.lbs(), **kw)[0] * g).sum().backward()
    torch.testing.assert_close(f.grad, f0.grad, rtol=0, atol=_gtol(f0.grad))


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_union_plan_matches_jax(dyn, backend):
    s = dyn
    jr = st.VolumeRenderer(s.jax_tree(), backend=backend)
    tr = stt.VolumeRenderer(s.port_tree(), backend=backend)
    jp, _ = jr._plan_dyn_union(s.c2w, W, H, FX, FX, False, *s.lbs(), jnp.asarray(s.stack))
    tp, ti = tr._plan_dyn_union(s.c2w, W, H, FX, FX, False, *s.lbs(), _t(s.stack))
    assert torch.equal(ti[tp.long()], torch.arange(W * H, dtype=torch.int32))
    opt = tr._get_options(False)
    sig = s.stack[..., -1].max(axis=0)
    jspec, _ = jr._dyn_union(*s.lbs())
    tspec, Q = tr._dyn_union(*s.lbs())
    o, d = (x.numpy() for x in trender.cam2world_rays(_t(s.c2w), W, H, FX, FX))
    jo, jd = (np.asarray(x) for x in jrender.cam2world_rays(jnp.asarray(s.c2w), W, H, FX, FX))
    sel = ((np.arange(H // 4)[:, None] * 4 + 2) * W + (np.arange(W // 4)[None, :] * 4 + 2)).ravel()
    tcost = tsched.ray_costs(tspec, _t(o[sel]), _t(d[sel]), opt, Q, _t(sig)).numpy()
    jcost = np.asarray(jsched.ray_costs(jspec, jnp.asarray(jo[sel]), jnp.asarray(jd[sel]), opt, Q,
                                        jnp.asarray(sig)))
    same = (o[sel] == jo[sel]).all(1) & (d[sel] == jd[sel]).all(1)
    up = lambda c: np.repeat(np.repeat(c.reshape(H // 4, W // 4), 4, 0), 4, 1).ravel()  # noqa: E731
    tile = trenderer._tile_order(opt, W, H, "cpu").numpy()
    np.testing.assert_array_equal(tp.numpy(), tile[np.argsort(up(tcost)[tile], kind="stable")])
    np.testing.assert_array_equal(jp, tile[np.argsort(up(jcost)[tile], kind="stable")])
    np.testing.assert_array_equal(tcost[same], jcost[same])
    if np.array_equal(tcost, jcost):
        np.testing.assert_array_equal(tp.numpy(), jp)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("route", ["native", "plain"])
def test_quantize_median_cut_matches_jax(weighted, route):
    rng = np.random.RandomState(21)
    data = rng.randn(3000, 4).astype(np.float32)
    w = rng.rand(3000).astype(np.float32) if weighted else None
    if route == "native":
        got, want = quantize_median_cut(data, w, 6), jquant.quantize_median_cut(data, w, 6)
    else:
        got, want = quantize_median_cut_plain(data, w, 6), jquant._quantize_numpy(data, w, 6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(got[1])) == 64
    # The two routes split alike; their means sum in another order.
    other = quantize_median_cut_plain(data, w, 6) if route == "native" else quantize_median_cut(
        data, w, 6)
    np.testing.assert_array_equal(other[1], got[1])
    np.testing.assert_allclose(other[0], got[0], atol=1e-6)
