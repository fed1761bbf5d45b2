"""svox_t_tpu_torch's CUDA kernels against their plain PyTorch versions.

Every test needs a CUDA GPU and nvcc and skips elsewhere. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them; there, skip the repository's conftest (which configures
JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The tests of the tree walk pass ``backend="tree"``; the baked backend
(the default) has tests of its own near the end of the file, and so do
the trilinear (``interp="trilinear"``, K4) instances of every march
kernel on both backends, with the same tolerances, and the bf16 and int8
pool instances (K5) of every march, aux and query kernel: each forward
equal bit for bit to the float32 kernel on the pool widened to float32
(an int8 pool dequantized as the kernels dequantize it), each held to
its plain version as above; the motion-feature kernels (K9c, K9d) have
each instance held to plain at each Kd capacity and bone count, on aligned
and unaligned LBS tables (their two instances) and at the joint table's
limit. The recorded-tape kernels (K13) come last:
the one-walk recorder (K13a+K13b: its walk and copy) and the earlier count
and record kernels equal to their plain versions exactly, the
replay forward equal to the forward march kernel bit for bit, the replay
backward (each vector width the row allows, and the one the wrapper
picks) against plain and the backward march kernel at the atomic
tolerance. Minibatch tape training (K14) and the dense-grid weight pass
(K12) close the file: the run gather, the SGD update and K12 equal to
their plain versions bit for bit, the L2 cotangent within 1e-6 (its loss
within ``1e-6 * max(1, |loss|)``: the kernel sums in another order), the
trainers against an eager chain of the public calls; each wrapper raises
when its kernel is missing. The ray schedules' cost walk (K15) ends the
file: its counts equal to the plain version's exactly on both structures,
exact, fast with and without the density column, under interp and below
the step cap (in fast mode with densities leaving out the rays whose
transmittance comes within 1e-6 of the stop, and counting them), and the
planned renders equal to the tile order bit for bit.

Tolerances: construct_tree and the query forward must agree exactly, and
so must the bake's lookup, refresh and skip-box regrowth,
points_leaf_aabb and the tree-editing kernels (assign, unique_leaf_nodes,
calc_corners; the plain calc_corners divides by a tensor, since on CUDA
PyTorch divides by a Python scalar through its reciprocal). The forward march agrees to atol 2e-5: the library is
built without contracted multiply-adds (a sample position is one
explicit fused multiply-add, rounded once on both sides), so sample
positions and descents match the plain version bit for bit, and only the
last ulps of exp and of the color sums can differ. Gradients and accumulated weights agree to
``1e-5 * max(1, max|plain|)``: the kernels add them with float atomics,
in an order that changes from run to run. So does the voxelize forward
(its splat is atomic). The warp forward and the warp's point and weight
gradients follow their plain versions operation for operation (1e-6),
as does the voxelize backward, which sums each point's window in order
(``1e-6 * max(1, max|plain|)``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import bake as tbake
from svox_t_tpu_torch.ops import grid as tgrid
from svox_t_tpu_torch.ops import p2v as tp2v
from svox_t_tpu_torch.ops import query as tquery
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import render_aux as taux
from svox_t_tpu_torch.ops import schedule as tsched
from svox_t_tpu_torch.ops import tape as ttape
from svox_t_tpu_torch.ops import tape_subset as tsub
from svox_t_tpu_torch.ops import traversal as ttrav
from svox_t_tpu_torch.ops import warp as twarp
from svox_t_tpu_torch.utils.scenes import (build_shell_tree, joint_pose_sequence, orbit_camera,
                                           random_lobes, skin_to_nearest_joints)

pytestmark = pytest.mark.requires_cuda

ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def _shell(cuda, depth=5, fmt="SH9", ddim=28, seed=0):
    state, feats, centers = build_shell_tree(depth=depth, data_format=fmt, data_dim=ddim, seed=seed)
    if fmt.startswith(("SG", "ASG")):
        kind = fmt.rstrip("0123456789")
        state["extra_data"] = random_lobes(kind, int(fmt[len(kind):]), seed)
    tree = stt.tree_from_numpy(state, device=cuda)
    return tree, torch.from_numpy(feats).to(cuda), torch.from_numpy(centers).to(cuda)


def _occupancy_tree(cuda, N=3, depth=3, seed=0):
    """N=3 tree from a random occupancy grid, with its occupied cell centres."""
    rng = np.random.RandomState(seed)
    R = N ** depth
    occ = rng.rand(R, R, R) < 0.15
    tree, M = stt.tree_from_occupancy(occ, N=N, data_dim=13, data_format="SH4", device=cuda)
    centers = ((np.argwhere(occ) + 0.5) / R).astype(np.float32)
    return tree, M, torch.from_numpy(centers).to(cuda)


def _rays(cuda, n, seed=0, size=48):
    """Camera rays of a size x size image plus n random rays through the
    cube, some of which miss."""
    o, d = trender.cam2world_rays(torch.as_tensor(orbit_camera(), device=cuda), size, size, 60.0, 60.0)
    rng = np.random.RandomState(seed)
    ro = (0.5 + 2.0 * rng.randn(n, 3) / np.sqrt(3)).astype(np.float32)
    tgt = (0.5 + (rng.rand(n, 3) - 0.5) * 2.0).astype(np.float32)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.cat([o, torch.from_numpy(ro).to(cuda)])
    d = torch.cat([d, torch.from_numpy(rd).to(cuda)])
    return o.contiguous(), d.contiguous()


def test_construct_tree_kernel_matches_plain(cuda):
    tree, feats, centers = _shell(cuda)
    spec = tree._spec()
    g = torch.Generator().manual_seed(1)
    # Every leaf twice plus a few more: duplicates exercise the
    # largest-id-wins rule.
    idx = torch.cat([torch.randperm(len(centers), generator=g),
                     torch.randperm(len(centers), generator=g)[:500]]).to(cuda)
    pts = centers[idx]
    before = tquery.CONSTRUCT_TREE.launches
    got = tquery.construct_tree(spec, pts)
    torch.cuda.synchronize()
    assert tquery.CONSTRUCT_TREE.launches == before + 1
    assert torch.equal(got, tquery.construct_tree_plain(spec, pts))
    assert not torch.equal(got, spec.data_flat)


def test_construct_tree_kernel_n3_and_entry_point(cuda):
    tree, M, centers = _occupancy_tree(cuda)
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(2)).to(cuda)
    want = tquery.construct_tree_plain(tree._spec(), centers[perm])
    tree.construct_tree(centers[perm])
    assert torch.equal(tree._spec().data_flat, want)
    assert np.array_equal(tree.data.reshape(-1), want.cpu().numpy())


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("RGBA", 8), ("SH1", 4), ("SH4", 13),
                                      ("SH9", 28), ("SH16", 49), ("SH25", 76)])
@pytest.mark.parametrize("fast", [False, True])
def test_render_kernel_matches_plain(cuda, fmt, ddim, fast):
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=ddim)
    o, d = _rays(cuda, 2048)
    r = stt.VolumeRenderer(tree, backend="tree")
    before = trender.RENDER_FWD.launches
    got = r(feats, stt.Rays(o, d, d), fast=fast)
    torch.cuda.synchronize()
    assert trender.RENDER_FWD.launches == before + 1
    want = trender.volume_render_plain(tree._spec(), feats, o, d, d, r._get_options(fast))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    alpha = got[:, -1]
    assert bool((alpha == 0).any()) and bool((alpha > 0.5).any())


@pytest.mark.parametrize("fast", [False, True])
def test_render_kernel_rotation_window_and_options(cuda, fast):
    tree, feats, _ = _shell(cuda, fmt="SH9", ddim=28, seed=3)
    M = feats.shape[0]
    q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(3))
    rot = torch.eye(4).repeat(M, 1, 1)
    rot[:, :3, :3] = torch.linalg.qr(q)[0]
    rot = rot.to(cuda)
    o, d = _rays(cuda, 1024, seed=1)
    vd = torch.roll(d, 1, dims=1).contiguous()  # view dirs apart from march dirs
    for kw in (dict(), dict(min_comp=2, max_comp=6, background_brightness=0.25, max_steps=37)):
        r = stt.VolumeRenderer(tree, backend="tree", **kw)
        r.sigma_thresh = 0.5 if fast else 0.0
        got = r(feats, stt.Rays(o, d, vd), rot, fast=fast)
        opt = r._get_options(fast)
        want = trender.volume_render_plain(tree._spec(rot), feats, o, d, vd, opt)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_render_kernel_n3_tree_and_empty_pool(cuda):
    tree, M, _ = _occupancy_tree(cuda, seed=4)
    feats = torch.randn(M, 13, generator=torch.Generator().manual_seed(4)).to(cuda)
    feats[:, -1] = feats[:, -1].abs() * 20
    o, d = _rays(cuda, 1024, seed=2)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(False)
    got = r(feats, stt.Rays(o, d, d))
    want = trender.volume_render_plain(tree._spec(), feats, o, d, d, opt)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    empty = torch.zeros(0, 13, device=cuda)
    got0 = r(empty, stt.Rays(o, d, d))
    assert torch.equal(got0[:, :-1], torch.ones_like(got0[:, :-1]))
    assert torch.equal(got0[:, -1], torch.zeros_like(got0[:, -1]))


def test_render_persp_on_cuda_uses_kernel(cuda):
    tree, feats, _ = _shell(cuda, depth=6)
    r = stt.VolumeRenderer(tree, backend="tree")
    before = trender.RENDER_FWD.launches
    img = r.render_persp(feats, orbit_camera(), 64, 48, fx=70.0, fast=True)
    torch.cuda.synchronize()
    assert trender.RENDER_FWD.launches == before + 1
    assert img.shape == (48, 64, 4) and img.is_cuda
    o, d = trender.cam2world_rays(torch.as_tensor(orbit_camera(), device=cuda), 64, 48, 70.0, 70.0)
    want = trender.volume_render_plain(tree._spec(), feats, o, d, d, r._get_options(True))
    torch.testing.assert_close(img.reshape(-1, 4), want, atol=ATOL, rtol=0)


def _assert_atomic_close(got, want):
    atol = 1e-5 * max(1.0, float(want.abs().max()) if want.numel() else 1.0)
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("fmt,ddim", [("SG9", 28), ("ASG9", 28), ("SG4", 13), ("ASG7", 22),
                                      ("SG20", 61)])
@pytest.mark.parametrize("fast", [False, True])
def test_render_kernel_sg_asg_matches_plain(cuda, fmt, ddim, fast):
    """SG and ASG in both march kernels; bases 7 and 20 run on the
    instances that hold 9 and 25 terms, below their capacity."""
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=5)
    o, d = _rays(cuda, 1024, seed=3)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(fast)
    f = feats.clone().requires_grad_()
    got = r(f, stt.Rays(o, d, d), fast=fast)
    want = trender.volume_render_plain(tree._spec(), feats, o, d, d, opt)
    torch.testing.assert_close(got.detach(), want, atol=ATOL, rtol=0)
    g_out = torch.randn(got.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    (g,) = torch.autograd.grad((got * g_out).sum(), f)
    g_plain = trender.volume_render_backward_plain(tree._spec(), feats, o, d, d, g_out, opt,
                                                   out_res=want)
    _assert_atomic_close(g, g_plain)
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH1", 4), ("SH9", 28), ("SH25", 76)])
@pytest.mark.parametrize("fast", [False, True])
def test_backward_kernel_matches_plain(cuda, fmt, ddim, fast):
    """Single pass in exact mode, two passes in fast mode and without
    out_res."""
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=ddim + 1)
    o, d = _rays(cuda, 2048, seed=4)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(fast)
    out = trender.volume_render_cuda(tree._spec(), feats, o, d, d, opt)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    for out_res in (out, None):
        before = trender.RENDER_BWD.launches
        got = trender.volume_render_backward(tree._spec(), feats, o, d, d, g_out, opt, out_res=out_res)
        torch.cuda.synchronize()
        assert trender.RENDER_BWD.launches == before + 1
        want = trender.volume_render_backward_plain(tree._spec(), feats, o, d, d, g_out, opt,
                                                    out_res=out_res)
        _assert_atomic_close(got, want)
        assert float(got[:, -1].abs().max()) > 0 and float(got[:, :-1].abs().max()) > 0


def test_backward_kernel_rotation_window_and_options(cuda):
    tree, feats, _ = _shell(cuda, fmt="SH9", ddim=28, seed=8)
    M = feats.shape[0]
    q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(8))
    rot = torch.eye(4).repeat(M, 1, 1)
    rot[:, :3, :3] = torch.linalg.qr(q)[0]
    rot = rot.to(cuda)
    o, d = _rays(cuda, 1024, seed=5)
    vd = torch.roll(d, 1, dims=1).contiguous()
    for kw in (dict(), dict(min_comp=2, max_comp=6, background_brightness=0.25, max_steps=37)):
        r = stt.VolumeRenderer(tree, backend="tree", **kw)
        for fast in (False, True):
            opt = r._get_options(fast)
            spec = tree._spec(rot)
            f = feats.clone().requires_grad_()
            out = r(f, stt.Rays(o, d, vd), rot, fast=fast)
            g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
            (g,) = torch.autograd.grad((out * g_out).sum(), f)
            want = trender.volume_render_backward_plain(spec, feats, o, d, vd, g_out, opt,
                                                        out_res=out.detach())
            _assert_atomic_close(g, want)


@pytest.mark.parametrize("fast", [False, True])
def test_weight_accum_kernel_matches_plain(cuda, fast):
    tree, feats, _ = _shell(cuda, fmt="SH9", ddim=28, seed=10)
    o, d = _rays(cuda, 2048, seed=6)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(fast)
    out, w = trender.volume_render_with_weight_accum_cuda(tree._spec(), feats, o, d, d, opt)
    out_p, w_p = trender.volume_render_with_weight_accum_plain(tree._spec(), feats, o, d, d, opt)
    torch.testing.assert_close(out, out_p, atol=ATOL, rtol=0)
    _assert_atomic_close(w, w_p)
    if not fast:
        torch.testing.assert_close(w.sum(), out[:, -1].sum(), rtol=1e-4, atol=0)
    with tree.accumulate_weights() as acc:
        r(feats, stt.Rays(o, d, d), fast=fast)
    _assert_atomic_close(acc.value.reshape(-1), w_p)
    assert acc().shape == (tree.n_leaves,) and float(acc().sum()) > 0


def test_query_kernels_match_plain(cuda):
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=11)
    spec = tree._spec()
    g = torch.Generator().manual_seed(11)
    pts = torch.cat([centers[torch.randperm(len(centers), generator=g).to(cuda)],
                     centers[:300], torch.rand(500, 3, generator=g).to(cuda)])
    f = feats[: int(len(feats) * 0.9)].contiguous()
    for world in (True, False):
        p = pts if world else tree.world2tree(pts).contiguous()
        before = (tquery.QUERY_FWD.launches, tquery.QUERY_BWD.launches)
        x = f.clone().requires_grad_()
        v, n, di = tquery.query(spec, x, p, world)
        gv = torch.randn(v.shape, generator=g).to(cuda)
        (gx,) = torch.autograd.grad((v * gv).sum(), x)
        torch.cuda.synchronize()
        assert (tquery.QUERY_FWD.launches, tquery.QUERY_BWD.launches) == (before[0] + 1, before[1] + 1)
        vp, np_, dp = tquery.query_forward_plain(spec, f, p, world)
        assert torch.equal(v.detach(), vp) and torch.equal(n, np_) and torch.equal(di, dp)
        _assert_atomic_close(gx, tquery.query_backward_plain(dp, gv, f.shape[0]))
        assert float(gx.abs().max()) > 0
        vt = tree(f, p, world=world)
        assert torch.equal(vt, vp)


def test_training_steps_use_the_kernels(cuda):
    """A few Adam steps through render_persp: each backward launches the
    backward kernel once, and the loss falls."""
    tree, feats, centers = _shell(cuda, depth=6, fmt="SH4", ddim=13, seed=12)
    r = stt.VolumeRenderer(tree, backend="tree")
    with torch.no_grad():
        target = r.render_persp(feats, orbit_camera(), 64, 64, fx=80.0)
    g = torch.Generator().manual_seed(12)
    pool = (feats + 0.3 * torch.randn(feats.shape, generator=g).to(cuda)).requires_grad_()
    opt = torch.optim.Adam([pool], lr=1e-2)
    before = trender.RENDER_BWD.launches
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = ((r.render_persp(pool, orbit_camera(), 64, 64, fx=80.0) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert trender.RENDER_BWD.launches == before + 5
    assert losses[-1] < losses[0] and bool(torch.isfinite(pool.grad).all())


def test_cuda_paths_raise_instead_of_falling_back(cuda):
    tree, feats, _ = _shell(cuda, depth=4)
    o, d = _rays(cuda, 16)
    r = stt.VolumeRenderer(tree, backend="tree")
    wide = torch.zeros(feats.shape[0], 18, device=cuda)
    rgba = stt.RenderOptions(format=stt.utils.spec.FORMAT_RGBA, basis_dim=-1)
    with pytest.raises(NotImplementedError, match="16 color channels"):
        trender.volume_render(tree._spec(), wide, o, d, d, rgba)
    with pytest.raises(NotImplementedError, match="16 color channels"):
        trender.volume_render_backward(tree._spec(), wide, o, d, d,
                                       torch.zeros(o.shape[0], 18, device=cuda), rgba)
    with pytest.raises(ValueError, match="device"):
        trender.volume_render_cuda(tree._spec(), feats.cpu(), o.cpu(), d.cpu(), d.cpu(), r._get_options())
    with pytest.raises(ValueError, match="several devices"):
        trender.volume_render(tree._spec(), feats, o.cpu(), d, d, r._get_options())
    with pytest.raises(ValueError, match="features on cpu"):
        tquery.query_forward_cuda(tree._spec(), feats.cpu(), o[:4])
    with pytest.raises(ValueError, match="float32"):
        tquery.query_backward_cuda(torch.zeros(4, dtype=torch.int32, device=cuda),
                                   torch.zeros(4, 3, dtype=torch.float64, device=cuda), 5)


def _lbs(cuda, M, J, kd, nb, seed):
    """Seeded joint features (J, kd), skinning weights (M, nb) with some
    zero or negative bones, and joint indices (M, nb)."""
    rng = np.random.RandomState(seed)
    jf = torch.from_numpy(rng.randn(J, kd).astype(np.float32)).to(cuda)
    sw = torch.from_numpy((rng.rand(M, nb) - 0.2).astype(np.float32)).to(cuda)
    ji = torch.from_numpy(rng.randint(0, J, (M, nb)).astype(np.int32)).to(cuda)
    return jf, sw, ji


@pytest.mark.parametrize("fast", [False, True])
def test_opacity_kernels_match_plain(cuda, fast):
    """Forward: the render's alpha bit for bit. VJP (single pass exact, two
    passes fast) against its plain version; a pool with large color
    columns shows that nothing but column D - 1 is written."""
    tree, feats, _ = _shell(cuda, seed=21)
    feats = feats.clone()
    feats[:, :-1] *= 100.0
    o, d = _rays(cuda, 2048)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(fast)
    spec = tree._spec()
    f = feats.clone().requires_grad_()
    g = torch.randn(o.shape[0], 1, generator=torch.Generator().manual_seed(21)).to(cuda)
    before = taux.OPACITY_BWD.launches
    alpha = r.opacity_render(f, stt.Rays(o, d, d), fast=fast)
    (gf,) = torch.autograd.grad((alpha * g).sum(), f)
    torch.cuda.synchronize()
    assert taux.OPACITY_BWD.launches == before + 1
    assert torch.equal(alpha.detach(), trender.volume_render_cuda(spec, feats, o, d, d, opt)[:, -1:])
    want = taux.opacity_backward_plain(spec, feats, o, d, g, opt, out_res=alpha.detach())
    _assert_atomic_close(gf, want)
    assert not gf[:, :-1].any() and float(gf[:, -1].abs().max()) > 0


@pytest.mark.parametrize("sigma_thresh", [0.0, 1e-2, -1.0])
def test_first_hit_kernel_matches_plain(cuda, sigma_thresh):
    tree, feats, _ = _shell(cuda, seed=22)
    o, d = _rays(cuda, 2048)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = dataclasses.replace(r._get_options(), sigma_thresh=sigma_thresh)
    spec = tree._spec()
    before = taux.FIRST_HIT.launches
    got = taux.first_hit(spec, feats, o, d, opt)
    torch.cuda.synchronize()
    assert taux.FIRST_HIT.launches == before + 1
    want = taux.first_hit_plain(spec, feats, o, d, opt)
    for name, g, w in zip(("found", "t_hit", "row"), got[:3], want[:3]):
        assert torch.equal(g, w), name
    torch.testing.assert_close(got[3], want[3], atol=ATOL, rtol=0)
    assert bool(got[0].any()) and not bool(got[0].all())


@pytest.mark.parametrize("kd", [3, 8, 13, 32])
@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("fast", [False, True])
def test_motion_feature_kernels_match_plain(cuda, kd, nb, fast):
    """Each Kd capacity (4, 8, 16, 32), below and at it, with one and four
    bones: the forward at ATOL, the VJP at the atomic tolerance."""
    tree, feats, _ = _shell(cuda, seed=23)
    o, d = _rays(cuda, 2048)
    r = stt.VolumeRenderer(tree, backend="tree")
    opt = r._get_options(fast)
    jf, sw, ji = _lbs(cuda, feats.shape[0], 7, kd, nb, seed=kd + nb)
    spec = tree._spec(joint_features=jf, skinning_weights=sw, joint_index=ji)
    before = (taux.MF_FWD.launches, taux.MF_BWD.launches)
    x = jf.clone().requires_grad_()
    out = r.motion_feature_render(feats, x, sw, ji, stt.Rays(o, d, d), fast=fast)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(kd)).to(cuda)
    (gx,) = torch.autograd.grad((out * g).sum(), x)
    torch.cuda.synchronize()
    assert (taux.MF_FWD.launches, taux.MF_BWD.launches) == (before[0] + 1, before[1] + 1)
    want = taux.motion_feature_render_plain(spec, jf, feats, o, d, opt)
    torch.testing.assert_close(out.detach(), want, atol=ATOL, rtol=0)
    _assert_atomic_close(gx, taux.motion_feature_backward_plain(spec, jf, feats, o, d, g, opt))
    assert float(gx.abs().max()) > 0


def test_motion_feature_backward_at_the_shared_table_limit(cuda):
    """J * (Kd | 1) just under KERNEL_MAX_JOINT_TABLE: the padded joint
    table fills 48 KB of shared memory."""
    tree, feats, _ = _shell(cuda, seed=25)
    o, d = _rays(cuda, 2048)
    opt = stt.VolumeRenderer(tree, backend="tree")._get_options()
    J = taux.KERNEL_MAX_JOINT_TABLE // 33
    jf, sw, ji = _lbs(cuda, feats.shape[0], J, 32, 4, seed=25)
    spec = tree._spec(joint_features=jf, skinning_weights=sw, joint_index=ji)
    g = torch.randn(o.shape[0], 32, generator=torch.Generator().manual_seed(25)).to(cuda)
    got = taux.motion_feature_backward_cuda(spec, jf, feats, o, d, g, opt)
    want = taux.motion_feature_backward_plain(spec, jf, feats, o, d, g, opt)
    _assert_atomic_close(got, want)
    assert int((got != 0).any(dim=1).sum()) > J // 2


def test_aux_entry_points_use_the_kernels(cuda):
    """The four VolumeRenderer aux methods launch their kernels; misses
    give depth 0 and motion features 0."""
    tree, feats, _ = _shell(cuda, seed=24)
    state = stt.tree_state(tree)
    state["extra_data"] = np.random.RandomState(24).rand(6, 3).astype(np.float32)
    tree = stt.tree_from_numpy(state, device=cuda)
    o, d = _rays(cuda, 256)
    rays = stt.Rays(o, d, d)
    r = stt.VolumeRenderer(tree, backend="tree")
    jf, sw, ji = _lbs(cuda, feats.shape[0], 6, 16, 4, seed=24)
    counts = lambda: (trender.RENDER_FWD.launches, taux.FIRST_HIT.launches, taux.MF_FWD.launches)
    before = counts()
    alpha = r.opacity_render(feats, rays)
    depth = r.render_depth(feats, rays)
    motion, depth_m, hit, didx = r.motion_render(feats, rays)
    mf = r.motion_feature_render(feats, jf, sw, ji, rays)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert torch.equal(depth, depth_m)
    miss = alpha[:, 0] == 0
    assert bool(miss.any()) and bool((depth[:, 0] > 0).any())
    assert not depth[miss].any() and not motion[miss].any()
    cube_miss = ~trender._ray_setup(tree._spec(), o, d)[-1]
    assert bool(cube_miss.any()) and not mf[cube_miss].any()
    assert bool((didx[depth[:, 0] > 0] < feats.shape[0]).all())


def _warp_rig(cuda, Q, J, nb, seed):
    """Transforms near the identity, points, weights with zero and
    negative bones, and ids with some outside [0, J) (-1, J + 3)."""
    rng = np.random.RandomState(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1)) + rng.randn(J, 4, 4).astype(np.float32) * 0.1
    x = rng.rand(Q, 3).astype(np.float32)
    w = rng.uniform(-0.3, 1.0, (Q, nb)).astype(np.float32)
    w[::7, 0] = 0.0
    ji = rng.randint(0, J, (Q, nb)).astype(np.int32)
    ji[1::11, -1] = -1
    ji[2::13, 0] = J + 3
    return tuple(torch.from_numpy(a).to(cuda) for a in (T, x, w, ji))


@pytest.mark.parametrize("J", [1, 2, 32])
@pytest.mark.parametrize("nb", [1, 2, 4])
def test_warp_kernels_match_plain(cuda, J, nb):
    T, x, w, ji = _warp_rig(cuda, 20000, J, nb, seed=30 + J + nb)
    before = (twarp.WARP_FWD.launches, twarp.WARP_BWD.launches)
    got = twarp.warp_forward_cuda(T, x, w, ji)
    want = twarp.warp_forward_plain(T, x, w, ji)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-6, rtol=0)
    gen = torch.Generator().manual_seed(J * nb)
    g_x = torch.randn(x.shape, generator=gen).to(cuda)
    g_M = torch.randn(x.shape[0], 4, 4, generator=gen).to(cuda)
    for gx, gm in ((g_x, g_M), (g_x, None), (None, g_M)):
        dT, dx, dw = twarp.warp_backward_cuda(T, x, w, ji, gx, gm)
        pT, px, pw = twarp.warp_backward_plain(T, x, w, ji, gx, gm)
        _assert_atomic_close(dT, pT)
        torch.testing.assert_close(dx, px, atol=1e-6 * max(1.0, float(px.abs().max())), rtol=0)
        torch.testing.assert_close(dw, pw, atol=1e-6 * max(1.0, float(pw.abs().max())), rtol=0)
        assert float(dT.abs().max()) > 0 and not dT[:, 3].any()
    torch.cuda.synchronize()
    assert (twarp.WARP_FWD.launches, twarp.WARP_BWD.launches) == (before[0] + 1, before[1] + 3)


def test_warp_entry_point_uses_the_kernels_and_only_wanted_grads(cuda):
    T, x, w, ji = _warp_rig(cuda, 5000, 4, 2, seed=41)
    Tg = T.clone().requires_grad_()
    before = (twarp.WARP_FWD.launches, twarp.WARP_BWD.launches)
    warped, mats = stt.warp_vertices(Tg, x, w, ji.long())
    (warped.sum() + (mats ** 2).sum()).backward()
    torch.cuda.synchronize()
    assert (twarp.WARP_FWD.launches, twarp.WARP_BWD.launches) == (before[0] + 1, before[1] + 1)
    pT, _, _ = twarp.warp_backward_plain(T, x, w, ji, torch.ones_like(x), 2 * mats.detach(),
                                        True, False, False)
    _assert_atomic_close(Tg.grad, pT)
    blend = stt.blend_transformation_matrix(T, w, ji)
    torch.testing.assert_close(blend, mats.detach(), atol=0, rtol=0)


def test_warp_backward_at_the_shared_table_limit(cuda):
    J = twarp.kernel_max_joints()
    T, x, w, ji = _warp_rig(cuda, 50000, J, 4, seed=42)
    g_x = torch.randn(x.shape, generator=torch.Generator().manual_seed(42)).to(cuda)
    dT, _, _ = twarp.warp_backward_cuda(T, x, w, ji, g_x, None, True, False, False)
    _assert_atomic_close(dT, twarp.warp_backward_plain(T, x, w, ji, g_x, None, True, False, False)[0])
    with pytest.raises(NotImplementedError, match="joints"):
        T2 = torch.eye(4, device=cuda).repeat(J + 1, 1, 1)
        twarp.warp_backward_cuda(T2, x, w, ji, g_x, None)


def _morton_cloud(Q, seed, bits=7):
    """Q random points in the unit cube in Morton order of a 2^bits grid,
    as the shell's rows go within a level."""
    pts = np.random.RandomState(seed).rand(Q, 3).astype(np.float32)
    g = (pts * (1 << bits)).astype(np.int64)
    code = np.zeros(Q, np.int64)
    for b in range(bits):
        for a in range(3):
            code |= ((g[:, a] >> b) & 1) << (3 * b + a)
    return pts[np.argsort(code, kind="stable")]


def _skinned_rig(cuda, Q, J, nb, seed):
    """A Morton-ordered cloud skinned to its nb nearest of J seeded joints,
    transforms near the identity: the rows of neighbouring points share
    their joints, as the deep dynamic rig's do."""
    pts = _morton_cloud(Q, seed)
    joints = (0.3 + 0.4 * np.random.RandomState(seed + 1).rand(J, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(pts, joints, nb)
    rng = np.random.RandomState(seed + 2)
    T = (np.eye(4) + 0.1 * rng.randn(J, 4, 4)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(cuda) for a in (T, pts, sw, ji))


# The warp backward's callers (PERF.md §6): (a) phase 6, J 32, nb 4, both
# output gradients, all three input gradients; (b) the pose fit, g_x only,
# dT only; (c) bench.py's rig, J 2, nb 2, both output gradients, dT only.
WARP_CALLERS = {"a": (32, 4, True, True, (True, True, True)),
                "b": (32, 4, True, False, (True, False, False)),
                "c": (2, 2, True, True, (True, False, False))}


@pytest.mark.parametrize("shape", sorted(WARP_CALLERS))
def test_warp_backward_at_its_callers_shapes(cuda, shape):
    J, nb, with_gx, with_gm, want = WARP_CALLERS[shape]
    T, x, w, ji = _skinned_rig(cuda, 200000, J, nb, seed=50 + J)
    if shape == "c":
        w = torch.stack([1.0 - x[:, 2], x[:, 2]], dim=1).contiguous()
        ji = torch.tensor([0, 1], dtype=torch.int32, device=cuda).repeat(x.shape[0], 1)
    gen = torch.Generator().manual_seed(J)
    g_x = torch.randn(x.shape, generator=gen).to(cuda) if with_gx else None
    g_M = torch.randn(x.shape[0], 4, 4, generator=gen).to(cuda) if with_gm else None
    before = twarp.WARP_BWD.launches
    got = twarp.warp_backward_cuda(T, x, w, ji, g_x, g_M, *want)
    ref = twarp.warp_backward_plain(T, x, w, ji, g_x, g_M, *want)
    _assert_atomic_close(got[0], ref[0])
    for g_, r_ in zip(got[1:], ref[1:]):
        assert (g_ is None) == (r_ is None) and (g_ is None or torch.equal(g_, r_))
    runs = twarp.warp_dT_runs_plain(T, x, w, ji, g_x, g_M)[0]
    _assert_atomic_close(runs, ref[0])
    torch.cuda.synchronize()
    assert twarp.WARP_BWD.launches == before + 1


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_warp_backward_unaligned_rows(cuda, nb):
    """Weights, ids and g_M off their 16-byte alignment (the scalar
    instance), beside the aligned call, at the rows' tolerances."""
    T, x, w, ji = _skinned_rig(cuda, 30000, 8, nb, seed=60 + nb)
    gen = torch.Generator().manual_seed(nb)
    g_x = torch.randn(x.shape, generator=gen).to(cuda)
    g_M = torch.randn(x.shape[0], 4, 4, generator=gen).to(cuda)
    w_off = torch.empty(w.numel() + 1, device=cuda)[1:].view_as(w).copy_(w)
    ji_off = torch.empty(ji.numel() + 1, dtype=torch.int32, device=cuda)[1:].view_as(ji).copy_(ji)
    gm_off = torch.empty(g_M.numel() + 1, device=cuda)[1:].view_as(g_M).copy_(g_M)
    T_off = torch.empty(T.numel() + 1, device=cuda)[1:].view_as(T).copy_(T)
    ref = twarp.warp_backward_plain(T, x, w, ji, g_x, g_M)
    for args in ((T, x, w, ji, g_x, g_M), (T_off, x, w_off, ji_off, g_x, gm_off)):
        dT, dx, dw = twarp.warp_backward_cuda(*args)
        _assert_atomic_close(dT, ref[0])
        assert torch.equal(dx, ref[1]) and torch.equal(dw, ref[2])


def _voxelize_order(cloud, order):
    """The Morton-ordered cloud in ``order``: as it is, shuffled, or its
    first half as it is and its second half shuffled."""
    Q = cloud.shape[0]
    perm = torch.from_numpy(np.random.RandomState(70).permutation(Q)).to(cloud.device)
    if order == "morton":
        return cloud
    if order == "shuffled":
        return cloud[perm].contiguous()
    tail = perm[perm >= Q // 2]
    return torch.cat([cloud[: Q // 2], cloud[tail]])


@pytest.mark.parametrize("order", ["morton", "shuffled", "half"])
def test_voxelize_forward_tiles_match_plain(cuda, order):
    """The tile path (Morton order), the direct splat (shuffled) and both
    in one launch (half and half), each against plain, and the blocks that
    took the tile counted as the plain mirror counts them."""
    # Dense enough (in the cube [0.4, 0.6]^3) for most Morton blocks' boxes to fit the tile.
    cloud = torch.from_numpy(0.4 + 0.2 * _morton_cloud(300000, 71)).to(cuda)
    pts = _voxelize_order(cloud, order)
    feats = (torch.rand(pts.shape[0], 2, generator=torch.Generator().manual_seed(72)) + 0.1).to(cuda)
    c = tp2v.grid_consts([0, 0, 0], [1, 1, 1], 257, 0.00363, 0.00727)
    want = tp2v.voxelize_forward_plain(pts, feats, c)
    before = tp2v.VOXELIZE_FWD.launches
    got = tp2v.voxelize_forward_cuda(pts, feats, c)
    _assert_atomic_close(got, want)
    counted, tiled = tp2v.voxelize_tiles_cuda(pts, feats, c)
    _assert_atomic_close(counted, want)
    mirror, census = tp2v.voxelize_forward_tiled_plain(pts, feats, c)
    _assert_atomic_close(mirror, want)
    assert tiled == census["tiled"] == int(tp2v.tile_boxes(pts, c)[2].sum())
    blocks = census["blocks"]
    if order == "morton":
        assert tiled > blocks // 2
    elif order == "shuffled":
        assert tiled == 0
    else:
        assert 0 < tiled < blocks
    torch.cuda.synchronize()
    assert tp2v.VOXELIZE_FWD.launches == before + 1


def _p2v_cloud(cuda, Q, F, seed):
    rng = np.random.RandomState(seed)
    pts = rng.rand(Q, 3).astype(np.float32)
    pts[0] = [10.0, 10.0, 10.0]    # outside: deposits nothing
    pts[1] = [-0.03, 0.5, 1.01]    # just outside two faces: a clipped window
    feats = (np.abs(rng.rand(Q, F)) + 0.1).astype(np.float32)
    return torch.from_numpy(pts).to(cuda), torch.from_numpy(feats).to(cuda)


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("n,kr,cr", [(33, 0.04, 0.0625), (17, 0.1, 0.2), (64, 0.02, 0.05)])
def test_voxelize_kernels_match_plain(cuda, F, n, kr, cr):
    """cr = 0.0625 is exactly one voxel of the 33-grid."""
    pts, feats = _p2v_cloud(cuda, 30000, F, seed=n + F)
    c = tp2v.grid_consts([0, 0, 0], [1, 1, 1], n, kr, cr)
    before = (tp2v.VOXELIZE_FWD.launches, tp2v.VOXELIZE_BWD.launches)
    vol = tp2v.voxelize_forward_cuda(pts, feats, c)
    want = tp2v.voxelize_forward_plain(pts, feats, c)
    _assert_atomic_close(vol, want)
    assert float(vol.max()) > 0
    g = torch.randn(vol.shape, generator=torch.Generator().manual_seed(n)).to(cuda)
    dp, df = tp2v.voxelize_backward_cuda(pts, feats, c, g)
    pp, pf = tp2v.voxelize_backward_plain(pts, feats, c, g)
    for got, ref in ((dp, pp), (df, pf)):
        torch.testing.assert_close(got, ref, atol=1e-6 * max(1.0, float(ref.abs().max())), rtol=0)
    assert not df[:, :-1].any() and not dp[0].any() and float(dp.abs().max()) > 0
    torch.cuda.synchronize()
    assert (tp2v.VOXELIZE_FWD.launches, tp2v.VOXELIZE_BWD.launches) == (before[0] + 1, before[1] + 1)


def test_voxelize_entry_point_uses_the_kernels(cuda):
    pts, feats = _p2v_cloud(cuda, 4000, 2, seed=7)
    p, f = pts.clone().requires_grad_(), feats.clone().requires_grad_()
    before = (tp2v.VOXELIZE_FWD.launches, tp2v.VOXELIZE_BWD.launches)
    vol = stt.voxelize(p, f, [0, 0, 0], [1, 1, 1], 24, 0.05, 0.1)
    (vol ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (tp2v.VOXELIZE_FWD.launches, tp2v.VOXELIZE_BWD.launches) == (before[0] + 1, before[1] + 1)
    assert vol.shape == (24, 24, 24, 1) and float(p.grad.abs().max()) > 0


def test_trees_default_to_the_card(cuda, tmp_path):
    tree = stt.N3Tree(N=2, data_dim=4, depth_limit=3)
    assert tree.device.type == "cuda" and tree._spec().child_flat.is_cuda
    path = str(tmp_path / "t.npz")
    tree.save(path)
    assert stt.N3Tree.load(path).device.type == "cuda"
    assert stt.tree_from_numpy(stt.tree_state(tree)).device.type == "cuda"
    occ = np.zeros((4, 4, 4), bool)
    occ[1, 2, 3] = True
    assert stt.tree_from_occupancy(occ)[0].device.type == "cuda"


@pytest.mark.parametrize("fast", [False, True])
def test_dynamic_frames_use_the_kernels_and_equal_the_eager_loop(cuda, fast):
    """render_dynamic_frames on the shell scene with a 6-joint rig: one
    warp, construct_tree, forward march and first hit per frame, and the
    same images and index table as the eager loop of the public calls."""
    state, feats_np, centers_np = build_shell_tree(depth=6, data_format="SH4", data_dim=13, seed=5)
    joints = np.random.RandomState(5).uniform(0.3, 0.7, (6, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(centers_np, joints, 4)
    poses = joint_pose_sequence(joints, 3, seed=5)
    src = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    feats = torch.from_numpy(feats_np).to(cuda)
    tree = stt.tree_from_numpy(state, device=cuda)
    r = stt.VolumeRenderer(tree, backend="tree")
    counters = (twarp.WARP_FWD, tquery.CONSTRUCT_TREE, trender.RENDER_FWD, taux.FIRST_HIT)
    before = [k.launches for k in counters]
    cols, deps = r.render_dynamic_frames(feats, poses, src, centers_np, sw, ji, c2w=orbit_camera(),
                                         width=64, height=48, fx=70.0, fast=fast, with_depth=True)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [3, 3, 3, 3]
    eager = stt.tree_from_numpy(state, device=cuda)
    re = stt.VolumeRenderer(eager, backend="tree")
    o, d = trender.cam2world_rays(torch.as_tensor(orbit_camera(), device=cuda), 64, 48, 70.0, 70.0)
    rays = stt.Rays(o.contiguous(), d.contiguous(), d.contiguous())
    for k in range(3):
        tk = stt.get_transformation_matrix(torch.from_numpy(src).to(cuda), torch.from_numpy(poses[k]).to(cuda))
        warped, mats = stt.warp_vertices(tk, torch.from_numpy(centers_np).to(cuda),
                                         torch.from_numpy(sw).to(cuda), torch.from_numpy(ji).to(cuda))
        eager.construct_tree(warped)
        img = re(feats, rays, transformation_matrices=mats, fast=fast).reshape(48, 64, -1)
        assert torch.equal(cols[k], img)
        assert torch.equal(deps[k], re.render_depth(feats, rays, fast=fast).reshape(48, 64, 1))
    assert torch.equal(tree._spec().data_flat, eager._spec().data_flat)


# ---------------------------------------------------------------------------
# The baked backend: K6 lookup, K7 refresh and regrowth, points_leaf_aabb,
# and the baked instances of the march kernels.


def _has_boxes(top):
    """Whether a top table packs any skip box (a row in the code space)."""
    code = (top & tbake.ROW_MASK) - tbake.SKIP_BASE
    return bool(((top >= 0) & (code >= 0) & (code < tbake._SKIP_BITS_SPAN)).any())


def _bakes(tree):
    """The tree's default bake, a three-stage bake (mid_levels=1) and a
    bake without skip boxes, with a label each."""
    spec = tree._spec()
    return [("default", tree._baked_spec()),
            ("three-stage", tbake.bake(spec, top_levels=1, mid_levels=1)),
            ("no skip boxes", tbake.bake(spec, top_levels=2, skip_boxes=False))]


def _lookup_points(cuda, tree, n, seed):
    """Leaf centres, random points and points on cell boundaries and
    outside the cube, in tree space."""
    g = torch.Generator().manual_seed(seed)
    R = tree.N ** 3
    pts = [torch.rand(n, 3, generator=g),
           torch.randint(0, R + 1, (n, 3), generator=g).float() / R,
           torch.rand(64, 3, generator=g) * 1.4 - 0.2]
    return torch.cat(pts).to(cuda).contiguous()


@pytest.mark.parametrize("scene", ["shell", "n3"])
def test_bake_lookup_kernel_matches_plain(cuda, scene):
    """Row, cube size, fraction and baked cell bit for bit, on two- and
    three-stage bakes, for N 2 and 3; the rows and fractions are the
    descent's."""
    tree = _shell(cuda, depth=5)[0] if scene == "shell" else _occupancy_tree(cuda, seed=6)[0]
    pts = _lookup_points(cuda, tree, 20000, seed=7)
    for label, baked in _bakes(tree):
        before = tbake.LOOKUP.launches
        got = tbake.lookup(baked, pts)
        torch.cuda.synchronize()
        assert tbake.LOOKUP.launches == before + 1, label
        want = tbake.lookup_plain(baked, pts)
        for name, g, w in zip(("row", "cube", "frac", "cell"), got, want):
            assert torch.equal(g, w), (label, name)
        leaf = ttrav.descend(tree._spec(), pts)
        occ = (leaf.data_idx >= 0) & (leaf.data_idx < tbake.SKIP_BASE)
        assert torch.equal(got[0][occ], leaf.data_idx[occ]), label
        assert bool((got[0][~occ] >= tbake.SKIP_BASE).all()), label
        assert torch.equal(got[1], leaf.cube_sz) and torch.equal(got[2], leaf.frac), label
        assert torch.equal(baked.src_map[got[3].long()], leaf.node_flat), label


def test_refresh_and_grow_kernels_match_plain(cuda):
    """After a re-point (a permutation of the leaf centres, some leaves
    left empty), refresh and the skip-box regrowth equal their plain
    versions exactly, and the box union follows construct_tree."""
    tree, feats, centers = _shell(cuda, depth=5, seed=31)
    for label, baked in _bakes(tree):
        perm = torch.randperm(len(centers), generator=torch.Generator().manual_seed(31))
        new_flat = tquery.construct_tree(tree._spec(), centers[perm[: len(perm) // 2].to(cuda)])
        before = (tbake.REFRESH.launches, tbake.GROW_BOXES.launches)
        lo, hi = torch.zeros(3, device=cuda), torch.ones(3, device=cuda)
        got = tbake.refresh(baked, new_flat, lo, hi)
        grown = tbake.grow_boxes_device(got)
        torch.cuda.synchronize()
        assert tbake.REFRESH.launches == before[0] + 1, label
        assert tbake.GROW_BOXES.launches == before[1] + (1 if baked.skip_base else 0), label
        want = tbake.refresh_plain(baked, new_flat, lo, hi)
        for name in ("top", "mid", "brick"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None and b is None) or torch.equal(a, b), (label, name)
        if baked.skip_base:
            assert torch.equal(grown.top, tbake.grow_boxes_plain(want).top), label
        if label == "default":  # a top grid with empty leaves: boxes regrow
            assert _has_boxes(grown.top)


@pytest.mark.parametrize("world", [True, False])
def test_points_aabb_kernel_matches_plain(cuda, world):
    for tree in (_shell(cuda, depth=5)[0], _occupancy_tree(cuda, seed=8)[0]):
        pts = _lookup_points(cuda, tree, 30000, seed=9)[:-64]
        p = tree.tree2world(pts).contiguous() if world else pts
        before = tquery.POINTS_AABB.launches
        got = tquery.points_leaf_aabb(tree._spec(), p, world)
        torch.cuda.synchronize()
        assert tquery.POINTS_AABB.launches == before + 1
        want = tquery.points_leaf_aabb_plain(tree._spec(), p, world)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        sub = tquery.points_leaf_aabb(tree._spec(), p[:5], world)
        assert bool((sub[0] >= got[0]).all()) and bool((sub[1] <= got[1]).all())
        box = (torch.full((3,), 0.3, device=cuda), torch.full((3,), 0.6, device=cuda))
        u = tquery.points_leaf_aabb(tree._spec(), p[:5], world, union=box)
        u_p = tquery.points_leaf_aabb_plain(tree._spec(), p[:5], world, union=box)
        assert torch.equal(u[0], u_p[0]) and torch.equal(u[1], u_p[1])
        assert torch.equal(u[0], torch.minimum(sub[0], box[0]))


@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH9", 28), ("SG9", 28)])
@pytest.mark.parametrize("fast", [False, True])
def test_baked_render_kernels_match_plain(cuda, fmt, ddim, fast):
    """The default renderer launches the baked forward and backward
    instances; forward, gradient and weights against the plain march on
    the same bake, on all three bakes."""
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=32)
    o, d = _rays(cuda, 2048, seed=32)
    r = stt.VolumeRenderer(tree)
    opt = r._get_options(fast)
    before = (trender.RENDER_FWD_BAKED.launches, trender.RENDER_BWD_BAKED.launches)
    f = feats.clone().requires_grad_()
    out = r(f, stt.Rays(o, d, d), fast=fast)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(32)).to(cuda)
    (g,) = torch.autograd.grad((out * g_out).sum(), f)
    torch.cuda.synchronize()
    assert (trender.RENDER_FWD_BAKED.launches, trender.RENDER_BWD_BAKED.launches) == (
        before[0] + 1, before[1] + 1)
    for label, baked in _bakes(tree):
        got = trender.volume_render_cuda(baked, feats, o, d, d, opt)
        want = trender.volume_render_plain(baked, feats, o, d, d, opt)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0, msg=label)
        gk = trender.volume_render_backward_cuda(baked, feats, o, d, d, g_out, opt, out_res=got)
        gp = trender.volume_render_backward_plain(baked, feats, o, d, d, g_out, opt, out_res=want)
        _assert_atomic_close(gk, gp)
        ok, wk = trender.volume_render_with_weight_accum_cuda(baked, feats, o, d, d, opt)
        op, wp = trender.volume_render_with_weight_accum_plain(baked, feats, o, d, d, opt)
        torch.testing.assert_close(ok, op, atol=ATOL, rtol=0, msg=label)
        _assert_atomic_close(wk, wp)
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("scene", ["shell", "n3"])
def test_baked_kernels_equal_tree_kernels_in_exact_mode(cuda, scene):
    """Exact mode: the baked instances give the tree walk's outputs bit
    for bit (colors, alpha, depths), for N 2 and 3 and a three-stage
    bake."""
    if scene == "shell":
        tree, feats, _ = _shell(cuda, depth=6, fmt="SH4", ddim=13, seed=33)
    else:
        tree, M, _ = _occupancy_tree(cuda, seed=33)
        feats = torch.randn(M, 13, generator=torch.Generator().manual_seed(33)).to(cuda)
        feats[:, -1] = feats[:, -1].abs() * 20
    o, d = _rays(cuda, 4096, seed=33)
    opt = stt.VolumeRenderer(tree)._get_options(False)
    want = trender.volume_render_cuda(tree._spec(), feats, o, d, d, opt)
    want_depth = taux.render_depth(tree._spec(), feats, o, d, opt)
    for label, baked in _bakes(tree):
        assert torch.equal(trender.volume_render_cuda(baked, feats, o, d, d, opt), want), label
        assert torch.equal(taux.render_depth(baked, feats, o, d, opt), want_depth), label
    assert float(want[:, -1].max()) > 0.5


@pytest.mark.parametrize("fast", [False, True])
def test_baked_aux_kernels_match_plain(cuda, fast):
    """The aux instances on the bake: opacity VJP, first hit, and the
    motion-feature forward and VJP, each launched once through the
    renderer and held against its plain version."""
    tree, feats, _ = _shell(cuda, seed=34)
    o, d = _rays(cuda, 2048, seed=34)
    rays = stt.Rays(o, d, d)
    r = stt.VolumeRenderer(tree)
    opt = r._get_options(fast)
    jf, sw, ji = _lbs(cuda, feats.shape[0], 7, 16, 4, seed=34)
    counts = lambda: (taux.OPACITY_BWD_BAKED.launches, taux.FIRST_HIT_BAKED.launches,  # noqa: E731
                      taux.MF_FWD_BAKED.launches, taux.MF_BWD_BAKED.launches)
    before = counts()
    f = feats.clone().requires_grad_()
    alpha = r.opacity_render(f, rays, fast=fast)
    g = torch.randn(alpha.shape, generator=torch.Generator().manual_seed(34)).to(cuda)
    (gf,) = torch.autograd.grad((alpha * g).sum(), f)
    depth = r.render_depth(feats, rays, fast=fast)
    x = jf.clone().requires_grad_()
    mf = r.motion_feature_render(feats, x, sw, ji, rays, fast=fast)
    gm = torch.randn(mf.shape, generator=torch.Generator().manual_seed(35)).to(cuda)
    (gx,) = torch.autograd.grad((mf * gm).sum(), x)
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before)
    spec = tree._baked_spec(skinning_weights=sw, joint_index=ji)
    _assert_atomic_close(gf, taux.opacity_backward_plain(spec, feats, o, d, g, opt,
                                                         out_res=alpha.detach()))
    hit = taux.first_hit(spec, feats, o, d, opt)
    want_hit = taux.first_hit_plain(spec, feats, o, d, opt)
    for name, a, b in zip(("found", "t_hit", "row"), hit[:3], want_hit[:3]):
        assert torch.equal(a, b), name
    torch.testing.assert_close(hit[3], want_hit[3], atol=ATOL, rtol=0)
    assert torch.equal(depth, taux.render_depth(spec, feats, o, d, opt))
    torch.testing.assert_close(mf.detach(), taux.motion_feature_render_plain(spec, jf, feats, o, d, opt),
                               atol=ATOL, rtol=0)
    _assert_atomic_close(gx, taux.motion_feature_backward_plain(spec, jf, feats, o, d, gm, opt))
    assert float(gf.abs().max()) > 0 and float(gx.abs().max()) > 0


@pytest.mark.parametrize("fast", [False, True])
def test_baked_dynamic_frames_use_the_kernels_and_equal_the_eager_loop(cuda, fast):
    """render_dynamic_frames on the default backend: per frame one
    construct_tree_aabb (the table and the points' leaf box in one descent)
    and one refresh (and in fast mode one skip-box
    regrowth, the depth-5 shell bakes with boxes), and the images, the
    table and the bake's box of the eager loop."""
    state, feats_np, centers_np = build_shell_tree(depth=5, data_format="SH4", data_dim=13, seed=5)
    joints = np.random.RandomState(5).uniform(0.3, 0.7, (6, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(centers_np, joints, 4)
    poses = joint_pose_sequence(joints, 3, seed=5)
    src = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    feats = torch.from_numpy(feats_np).to(cuda)
    tree = stt.tree_from_numpy(state, device=cuda)
    r = stt.VolumeRenderer(tree)
    assert tree._baked_spec().skip_base
    counters = (tquery.CONSTRUCT_TREE_AABB, tbake.REFRESH, tbake.GROW_BOXES, trender.RENDER_FWD_BAKED,
                tquery.CONSTRUCT_TREE, tquery.POINTS_AABB)
    before = [k.launches for k in counters]
    cols = r.render_dynamic_frames(feats, poses, src, centers_np, sw, ji, c2w=orbit_camera(),
                                   width=64, height=48, fx=70.0, fast=fast)
    torch.cuda.synchronize()
    grows = 3 + 1 if fast else 1  # the tree adopts the last table: one more regrowth
    # Each frame's re-point and leaf box: one fused call, no separate box.
    assert [k.launches - b for k, b in zip(counters, before)] == [3, 4, grows, 3, 0, 0]
    eager = stt.tree_from_numpy(state, device=cuda)
    re = stt.VolumeRenderer(eager)
    eager._baked_spec()
    o, d = trender.cam2world_rays(torch.as_tensor(orbit_camera(), device=cuda), 64, 48, 70.0, 70.0)
    rays = stt.Rays(o.contiguous(), d.contiguous(), d.contiguous())
    for k in range(3):
        tk = stt.get_transformation_matrix(torch.from_numpy(src).to(cuda), torch.from_numpy(poses[k]).to(cuda))
        warped, mats = stt.warp_vertices(tk, torch.from_numpy(centers_np).to(cuda),
                                         torch.from_numpy(sw).to(cuda), torch.from_numpy(ji).to(cuda))
        eager.construct_tree(warped)
        img = re(feats, rays, transformation_matrices=mats, fast=fast).reshape(48, 64, -1)
        assert torch.equal(cols[k], img)
    assert torch.equal(tree._spec().data_flat, eager._spec().data_flat)
    for name in ("aabb_lo", "aabb_hi", "top"):
        assert torch.equal(getattr(tree._baked_spec(), name), getattr(eager._baked_spec(), name))


def test_bake_wrappers_raise_on_cpu_tensors(cuda):
    """The bake's kernel wrappers launch or raise; given CPU tensors they
    raise instead of running the plain version."""
    tree, _, centers = _shell(cuda, depth=4)
    baked = tree._baked_spec()
    cpu_baked = tbake.bake(stt.tree_from_numpy(stt.tree_state(tree), device="cpu")._spec())
    with pytest.raises(ValueError, match="CUDA"):
        tbake.lookup_cuda(baked, centers.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        tbake.lookup_cuda(cpu_baked, centers.cpu().cuda())
    with pytest.raises(ValueError, match="CUDA"):
        tbake.refresh_cuda(cpu_baked, cpu_baked.src_map.new_zeros(cpu_baked.n_tree_cells))
    with pytest.raises(ValueError, match="CUDA"):
        tbake.grow_boxes_cuda(cpu_baked)
    with pytest.raises(ValueError, match="on cpu"):
        tquery.points_leaf_aabb_cuda(tree._spec(), centers.cpu())


# ---------------------------------------------------------------------
# Tree editing: K8b assign, unique_leaf_nodes and calc_corners, exactly.


@pytest.mark.parametrize("scene", ["shell", "n3"])
def test_calc_corners_kernel_matches_plain(cuda, scene):
    tree = _shell(cuda)[0] if scene == "shell" else _occupancy_tree(cuda)[0]
    spec = tree._spec()
    leaves = torch.as_tensor(tree._all_leaves(), dtype=torch.int32, device=cuda)
    before = tquery.CALC_CORNERS.launches
    got = tquery.calc_corners(spec, leaves)
    torch.cuda.synchronize()
    assert tquery.CALC_CORNERS.launches == before + 1
    assert torch.equal(got, tquery.calc_corners_plain(spec, leaves))
    # through the view: every leaf centre descends to its own leaf again
    cen = tree.corners_local + 0.5 * tree.lengths_local[:, None]
    flat = ttrav.descend(spec, cen).node_flat.cpu().numpy()
    assert np.array_equal(flat, tree._pack_index_np(tree._all_leaves()))


def test_calc_corners_kernel_walks_freed_nodes(cuda):
    """Until shrink_to_fit a merged node's cells stay leaves, with parent
    link -1: the kernel unpacks it with floor division, as the plain version."""
    tree, feats, _ = _shell(cuda, depth=4)
    tree.features = feats
    tree.merge(np.arange(0, len(tree._frontier), 7))
    spec = tree._spec()
    leaves = torch.as_tensor(tree._all_leaves(), dtype=torch.int32, device=cuda)
    assert bool((spec.parent_depth[:, 0] == -1).any())
    assert torch.equal(tquery.calc_corners_cuda(spec, leaves), tquery.calc_corners_plain(spec, leaves))


@pytest.mark.parametrize("world", [True, False])
def test_assign_kernel_matches_plain(cuda, world):
    tree, feats, centers = _shell(cuda)
    spec = tree._spec()
    g = torch.Generator().manual_seed(3)
    L = len(centers)
    # every leaf once, 700 twice (duplicates: the largest point id wins),
    # points in empty space, and rows >= M (the pool is cut short)
    idx = torch.cat([torch.randperm(L, generator=g), torch.randperm(L, generator=g)[:700]]).to(cuda)
    rand = torch.rand(500, 3, generator=g).to(cuda)
    pts = torch.cat([centers[idx], rand]).contiguous()
    if not world:
        pts = ttrav.world2tree(pts, spec.offset, spec.scaling).contiguous()
    vals = torch.randn(len(pts), feats.shape[1], generator=g).to(cuda)
    pool = feats[: feats.shape[0] * 3 // 4].contiguous()
    before = tquery.ASSIGN.launches
    got = tquery.assign(spec, pool, pts, vals, world)
    torch.cuda.synchronize()
    assert tquery.ASSIGN.launches == before + 1
    assert torch.equal(got, tquery.assign_plain(spec, pool, pts, vals, world))
    # the second point of each duplicated leaf wrote its row, where the
    # row is < M and no later (random) point hit it
    rows = tquery.query_forward_cuda(spec, pool, centers[idx[L:]])[2].long()
    late = tquery.query_forward_cuda(spec, pool, rand)[2].long()
    kept = (rows < pool.shape[0]) & ~torch.isin(rows, late)
    assert bool(kept.any()) and torch.equal(got[rows[kept]], vals[L:L + 700][kept])
    assert not torch.equal(got, pool) and torch.equal(pool, feats[: pool.shape[0]])


def test_assign_kernel_n3_and_entry_point(cuda):
    tree, M, centers = _occupancy_tree(cuda)
    g = torch.Generator().manual_seed(4)
    tree.features = torch.randn(M, 13, generator=g).to(cuda)
    pts = centers[torch.randperm(M, generator=g)[: M // 2].to(cuda)]
    vals = torch.randn(len(pts), 13, generator=g).to(cuda)
    want = tquery.assign_plain(tree._spec(), tree.features, pts, vals)
    tree.set(pts, vals)
    assert torch.equal(tree.features, want)
    assert torch.equal(tree(tree.features, pts), vals)


def _query_ids(cuda, tree, feats, centers, seed):
    g = torch.Generator().manual_seed(seed)
    L = len(centers)
    idx = torch.cat([torch.randperm(L, generator=g), torch.randperm(L, generator=g)[: L // 3]])
    pts = torch.cat([centers[idx.to(cuda)], torch.rand(2000, 3, generator=g).to(cuda)]).contiguous()
    return tquery.query_forward_cuda(tree._spec(), feats, pts)[1], pts


@pytest.mark.parametrize("pad", [None, 0, 37, -100])
def test_unique_leaf_kernel_matches_plain(cuda, pad):
    tree, feats, centers = _shell(cuda)
    ids, _ = _query_ids(cuda, tree, feats, centers, 5)
    n_cells = tree._spec().data_flat.numel()
    n_uniq = int(torch.unique(ids).numel())
    size = None if pad is None else n_uniq + pad
    before = tquery.UNIQUE_LEAF.launches
    leaf_k, count_k = tquery.unique_leaf_nodes(ids, 2, size=size, n_cells=n_cells)
    torch.cuda.synchronize()
    assert tquery.UNIQUE_LEAF.launches == before + 1
    leaf_p, count_p = tquery.unique_leaf_nodes_plain(ids, 2, size=size, n_cells=n_cells)
    assert torch.equal(leaf_k, leaf_p) and int(count_k) == int(count_p)
    assert int(count_k) == min(n_uniq, size if size is not None else len(ids))


def test_unique_leaf_kernel_many_tiles_and_n3(cuda):
    """Over 1024 tiles (the offsets scan runs in two chunks), a range that
    is not a multiple of 4, ids out of range, and an N = 3 tree."""
    g = torch.Generator().manual_seed(6)
    n_cells = 5_000_003
    ids = torch.randint(-5, n_cells + 5, (300_000,), generator=g, dtype=torch.int32).to(cuda)
    ids[:3] = torch.tensor([0, n_cells - 1, n_cells - 1], dtype=torch.int32)
    got = tquery.unique_leaf_nodes_cuda(ids, 2, n_cells=n_cells)
    want = tquery.unique_leaf_nodes_plain(ids, 2, n_cells=n_cells)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    tree, M, centers = _occupancy_tree(cuda)
    tree.features = torch.zeros(M, 13, device=cuda)
    ids, pts = _query_ids(cuda, tree, tree.features, centers, 7)
    n3 = tree._spec().data_flat.numel()
    got = tquery.unique_leaf_nodes_cuda(ids, 3, n_cells=n3)
    want = tquery.unique_leaf_nodes_plain(ids, 3, n_cells=n3)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    before = tquery.UNIQUE_LEAF.launches
    _, leaf = tree(tree.features, pts, want_leaf_node=True)
    assert tquery.UNIQUE_LEAF.launches == before + 1
    assert torch.equal(leaf, want[0][: int(want[1])])


def test_edit_wrappers_raise_on_cpu_tensors(cuda):
    tree, feats, centers = _shell(cuda, depth=3)
    spec = tree._spec()
    with pytest.raises(ValueError):
        tquery.assign_cuda(spec, feats, centers.cpu(), torch.zeros(len(centers), feats.shape[1]))
    with pytest.raises(ValueError, match="CUDA"):
        tquery.unique_leaf_nodes_cuda(torch.zeros(4, dtype=torch.int32), 2, n_cells=8)
    with pytest.raises(ValueError):
        tquery.calc_corners_cuda(spec, torch.zeros(4, 4, dtype=torch.int32))


def test_tree_editing_entry_points_use_the_kernels(cuda):
    """The smoke's tree-editing path at a small size: corners, set, the
    unique-leaf view, merge + shrink_to_fit and refine, each followed by
    exact renders on both backends that agree bit for bit."""
    tree, feats, centers = _shell(cuda, depth=5)
    tree.features = feats
    counts = {k: k.launches for k in (tquery.CALC_CORNERS, tquery.ASSIGN, tquery.UNIQUE_LEAF)}
    cen = tree.tree2world(tree.corners_local + 0.5 * tree.lengths_local[:, None])
    tree.set(cen, feats[torch.arange(len(cen), device=cuda) % feats.shape[0]])
    view = tree[cen[::3]]
    assert len(view) == len(cen[::3])
    for k, n in counts.items():
        assert k.launches > n
    o, d = _rays(cuda, 512)
    rays = stt.Rays(o, d, d)

    def renders_agree():
        a = stt.VolumeRenderer(tree)(tree.features, rays)
        b = stt.VolumeRenderer(tree, backend="tree")(tree.features, rays)
        assert torch.equal(a, b) and bool((a[:, -1] > 0).any())

    renders_agree()
    assert tree.merge(np.arange(0, len(tree._frontier), 5))
    assert tree.shrink_to_fit()
    renders_agree()
    tree[: tree.n_leaves // 50].refine()
    renders_agree()
    cen = tree.tree2world(tree.corners_local + 0.5 * tree.lengths_local[:, None])
    _, leaf = tree(tree.features, cen, want_leaf_node=True)
    assert np.array_equal(leaf.cpu().numpy(), tree._all_leaves())


# ---------------------------------------------------------------------------
# Trilinear interpolation (K4): the interp instances of every march kernel.


def _interp_kernels(backend):
    """The interp instances a renderer of ``backend`` launches: forward,
    backward, opacity VJP, first hit, motion features forward and VJP."""
    sfx = "_BAKED_INTERP" if backend == "baked" else "_INTERP"
    return ([getattr(trender, k + sfx) for k in ("RENDER_FWD", "RENDER_BWD")]
            + [getattr(taux, k + sfx) for k in ("OPACITY_BWD", "FIRST_HIT", "MF_FWD", "MF_BWD")])


def _launches(kernels):
    return [k.launches for k in kernels]


@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH9", 28), ("ASG9", 28)])
@pytest.mark.parametrize("fast", [False, True])
def test_interp_render_kernels_match_plain(cuda, backend, fmt, ddim, fast):
    """VolumeRenderer(interp="trilinear") launches the interp forward and
    backward instances; forward, gradient and weights against the plain
    march, on a pool cut to 70% of the leaves (empty corners)."""
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=40)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    o, d = _rays(cuda, 2048, seed=40)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear")
    kernels = _interp_kernels(backend)[:2]
    before = _launches(kernels)
    f = feats.clone().requires_grad_()
    out = r(f, stt.Rays(o, d, d), fast=fast)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(40)).to(cuda)
    (g,) = torch.autograd.grad((out * g_out).sum(), f)
    torch.cuda.synchronize()
    assert _launches(kernels) == [b + 1 for b in before]
    spec, opt = r._render_spec(), r._get_options(fast)
    want = trender.volume_render_plain(spec, feats, o, d, d, opt)
    torch.testing.assert_close(out.detach(), want, atol=ATOL, rtol=0)
    _assert_atomic_close(g, trender.volume_render_backward_plain(spec, feats, o, d, d, g_out, opt,
                                                                 out_res=want))
    ok, wk = trender.volume_render_with_weight_accum_cuda(spec, feats, o, d, d, opt)
    op, wp = trender.volume_render_with_weight_accum_plain(spec, feats, o, d, d, opt)
    torch.testing.assert_close(ok, op, atol=ATOL, rtol=0)
    _assert_atomic_close(wk, wp)
    assert float(g.abs().max()) > 0 and float(want[:, -1].max()) > 0.5


@pytest.mark.parametrize("backend", ["tree", "baked"])
def test_interp_rotations_match_plain(cuda, backend):
    """Per-voxel rotations under interp: an empty-leaf sample rotates by
    row 0's matrix, as the plain version (and the JAX package) does."""
    tree, feats, _ = _shell(cuda, fmt="SH9", ddim=28, seed=41)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    M = feats.shape[0]
    q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(41))
    rot = torch.eye(4).repeat(M, 1, 1)
    rot[:, :3, :3] = torch.linalg.qr(q)[0]
    rot = rot.to(cuda)
    o, d = _rays(cuda, 2048, seed=41)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear")
    spec, opt = r._render_spec(rot), r._get_options(False)
    got = trender.volume_render_cuda(spec, feats, o, d, d, opt)
    torch.testing.assert_close(got, trender.volume_render_plain(spec, feats, o, d, d, opt),
                               atol=ATOL, rtol=0)
    g_out = torch.randn(got.shape, generator=torch.Generator().manual_seed(41)).to(cuda)
    _assert_atomic_close(trender.volume_render_backward_cuda(spec, feats, o, d, d, g_out, opt, got),
                         trender.volume_render_backward_plain(spec, feats, o, d, d, g_out, opt, got))


@pytest.mark.parametrize("scene", ["shell", "n3"])
def test_interp_baked_kernels_equal_tree_kernels_in_exact_mode(cuda, scene):
    """Under interp neither backend culls, and every corner lookup finds the
    same row on both: exact colors, alpha and depths bit for bit."""
    if scene == "shell":
        tree, feats, _ = _shell(cuda, depth=6, fmt="SH4", ddim=13, seed=42)
        feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    else:
        tree, M, _ = _occupancy_tree(cuda, seed=42)
        feats = torch.randn(M, 13, generator=torch.Generator().manual_seed(42)).to(cuda)
        feats[:, -1] = feats[:, -1].abs() * 20
    o, d = _rays(cuda, 4096, seed=42)
    opt = stt.VolumeRenderer(tree, interp="trilinear")._get_options(False)
    want = trender.volume_render_cuda(tree._spec(), feats, o, d, d, opt)
    want_depth = taux.render_depth(tree._spec(), feats, o, d, opt)
    torch.testing.assert_close(want, trender.volume_render_plain(tree._spec(), feats, o, d, d, opt),
                               atol=ATOL, rtol=0)
    for label, baked in _bakes(tree):
        assert torch.equal(trender.volume_render_cuda(baked, feats, o, d, d, opt), want), label
        assert torch.equal(taux.render_depth(baked, feats, o, d, opt), want_depth), label
    assert float(want[:, -1].max()) > 0.5


@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("fast", [False, True])
def test_interp_aux_kernels_match_plain(cuda, backend, fast):
    """The aux interp instances, each launched once through the renderer:
    opacity VJP, first hit, motion-feature forward and VJP."""
    tree, feats, _ = _shell(cuda, seed=43)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    o, d = _rays(cuda, 2048, seed=43)
    rays = stt.Rays(o, d, d)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear")
    opt = r._get_options(fast)
    jf, sw, ji = _lbs(cuda, feats.shape[0], 7, 16, 4, seed=43)
    kernels = _interp_kernels(backend)[2:]
    before = _launches(kernels)
    f = feats.clone().requires_grad_()
    alpha = r.opacity_render(f, rays, fast=fast)
    g = torch.randn(alpha.shape, generator=torch.Generator().manual_seed(43)).to(cuda)
    (gf,) = torch.autograd.grad((alpha * g).sum(), f)
    depth = r.render_depth(feats, rays, fast=fast)
    x = jf.clone().requires_grad_()
    mf = r.motion_feature_render(feats, x, sw, ji, rays, fast=fast)
    gm = torch.randn(mf.shape, generator=torch.Generator().manual_seed(44)).to(cuda)
    (gx,) = torch.autograd.grad((mf * gm).sum(), x)
    torch.cuda.synchronize()
    assert _launches(kernels) == [b + 1 for b in before]
    spec = (tree._baked_spec if backend == "baked" else tree._spec)(skinning_weights=sw, joint_index=ji)
    _assert_atomic_close(gf, taux.opacity_backward_plain(spec, feats, o, d, g, opt,
                                                         out_res=alpha.detach()))
    hit = taux.first_hit(spec, feats, o, d, opt)
    want_hit = taux.first_hit_plain(spec, feats, o, d, opt)
    for name, a, b in zip(("found", "t_hit", "row"), hit[:3], want_hit[:3]):
        assert torch.equal(a, b), name
    torch.testing.assert_close(hit[3], want_hit[3], atol=ATOL, rtol=0)
    assert torch.equal(depth, taux.render_depth(spec, feats, o, d, opt))
    torch.testing.assert_close(mf.detach(), taux.motion_feature_render_plain(spec, jf, feats, o, d, opt),
                               atol=ATOL, rtol=0)
    _assert_atomic_close(gx, taux.motion_feature_backward_plain(spec, jf, feats, o, d, gm, opt))
    assert float(gf.abs().max()) > 0 and float(gx.abs().max()) > 0


# ---------------------------------------------------------------------------
# K5: bf16 and int8 feature pools


def _pool_of(kind, feats):
    """The float32 pool ``feats`` in pool type ``kind``, and the float32
    pool the kernels read from it (bf16 widened, int8 dequantized)."""
    if kind == "bf16":
        p = feats.to(torch.bfloat16)
        return p, p.float()
    q = stt.quantize_features(feats)
    return q, q.dequantize()


def _pool_kernels(names, backend, interp, kind):
    sfx = ("_BAKED" if backend == "baked" else "") + ("_INTERP" if interp else "") + "_" + kind.upper()
    return [getattr(trender if k.startswith("RENDER") else taux, k + sfx) for k in names]


@pytest.mark.parametrize("kind", ["bf16", "i8"])
@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("fmt,ddim", [("RGBA", 4), ("SH9", 28), ("SG9", 28)])
def test_pool_render_kernels_equal_f32_kernel(cuda, kind, backend, interp, fmt, ddim):
    """The bf16 and int8 instances of the forward march (and the bf16
    backward) through the renderer: the forward equal bit for bit to the
    float32 kernel on the widened pool, exact and fast, with and without
    weights; against the plain version at ATOL; the bf16 gradient's float32
    sum against the plain version's, and its bf16 cast within one ulp of
    the cast of that sum."""
    tree, feats, _ = _shell(cuda, fmt=fmt, ddim=ddim, seed=50)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    pool, wide = _pool_of(kind, feats)
    o, d = _rays(cuda, 2048, seed=50)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
    spec = r._render_spec()
    fwd = _pool_kernels(["RENDER_FWD"], backend, interp, kind)
    for fast in (False, True):
        opt = r._get_options(fast)
        before = _launches(fwd)
        out = trender.volume_render_cuda(spec, pool, o, d, d, opt)
        ok, wk = trender.volume_render_with_weight_accum_cuda(spec, pool, o, d, d, opt)
        torch.cuda.synchronize()
        assert _launches(fwd) == [before[0] + 2]
        assert torch.equal(out, trender.volume_render_cuda(spec, wide, o, d, d, opt))
        ow, ww = trender.volume_render_with_weight_accum_cuda(spec, wide, o, d, d, opt)
        assert torch.equal(ok, ow) and torch.equal(ok, out)
        _assert_atomic_close(wk, ww)
        torch.testing.assert_close(out, trender.volume_render_plain(spec, pool, o, d, d, opt),
                                   atol=ATOL, rtol=0)
    if kind == "bf16":
        opt = r._get_options(False)
        (bwd,) = _pool_kernels(["RENDER_BWD"], backend, interp, kind)
        before = bwd.launches
        f = pool.clone().requires_grad_()
        out = r(f, stt.Rays(o, d, d))
        g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(50)).to(cuda)
        (g,) = torch.autograd.grad((out * g_out).sum(), f)
        torch.cuda.synchronize()
        assert bwd.launches == before + 1 and g.dtype == torch.bfloat16
        buf = trender.volume_render_backward_cuda(spec, pool, o, d, d, g_out, opt, out.detach())
        want = trender.volume_render_backward_plain(spec, pool, o, d, d, g_out, opt, out.detach())
        assert buf.dtype == torch.float32 and want.dtype == torch.float32
        _assert_atomic_close(buf, want)
        _assert_atomic_close(buf, trender.volume_render_backward_cuda(spec, wide, o, d, d, g_out, opt,
                                                                      out.detach()))
        _assert_bf16_ulp(g, want)
        assert float(g.float().abs().max()) > 0
    else:
        with pytest.raises(ValueError, match="no kernel instance for a i8"):
            trender.volume_render_backward_cuda(spec, pool, o, d, d, torch.zeros_like(out), opt)


def _assert_bf16_ulp(got, want32):
    """A bf16 cast of float32 sums that differ from ``want32`` by atomic
    order: each element within one bf16 ulp of ``want32`` plus the float32
    tolerance of `_assert_atomic_close`."""
    w = want32.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs().clamp_min(1e-30)).exponent - 8)
    tol = ulp + 1e-5 * max(1.0, float(w.abs().max()))
    assert bool(((got.float() - w).abs() <= tol).all())


@pytest.mark.parametrize("kind", ["bf16", "i8"])
@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("interp", [False, True])
def test_pool_aux_kernels_equal_f32_kernel(cuda, kind, backend, interp):
    """The aux passes' pool instances through the renderer: first hit and
    the motion-feature forward equal bit for bit to the float32 kernels on
    the widened pool and to their plain versions as in the float32 tests;
    the motion-feature VJP (bf16 joint features too) and, for bf16, the
    opacity VJP against their plain versions."""
    tree, feats, _ = _shell(cuda, seed=51)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    pool, wide = _pool_of(kind, feats)
    o, d = _rays(cuda, 2048, seed=51)
    rays = stt.Rays(o, d, d)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
    jf, sw, ji = _lbs(cuda, feats.shape[0], 7, 16, 4, seed=51)
    spec = (tree._baked_spec if backend == "baked" else tree._spec)(skinning_weights=sw, joint_index=ji)
    kernels = _pool_kernels(["FIRST_HIT", "MF_FWD", "MF_BWD"], backend, interp, kind)
    for fast in (False, True):
        opt = r._get_options(fast)
        before = _launches(kernels)
        depth = r.render_depth(pool, rays, fast=fast)
        x = jf.to(torch.bfloat16).requires_grad_() if kind == "bf16" else jf.clone().requires_grad_()
        mf = r.motion_feature_render(pool, x, sw, ji, rays, fast=fast)
        gm = torch.randn(mf.shape, generator=torch.Generator().manual_seed(52)).to(cuda)
        (gx,) = torch.autograd.grad((mf * gm).sum(), x)
        torch.cuda.synchronize()
        assert _launches(kernels) == [b + 1 for b in before] and gx.dtype == x.dtype
        assert torch.equal(depth, taux.render_depth(spec, wide, o, d, opt))
        hit, want_hit = taux.first_hit(spec, pool, o, d, opt), taux.first_hit_plain(spec, pool, o, d, opt)
        for a, b in zip(hit[:3], want_hit[:3]):
            assert torch.equal(a, b)
        torch.testing.assert_close(hit[3], want_hit[3], atol=ATOL, rtol=0)
        x32 = x.detach().float()
        assert torch.equal(mf.detach(), taux.motion_feature_forward_cuda(spec, x32, wide, o, d, opt))
        torch.testing.assert_close(mf.detach(), taux.motion_feature_render_plain(spec, x32, pool, o, d, opt),
                                   atol=ATOL, rtol=0)
        want = taux.motion_feature_backward_plain(spec, x32, pool, o, d, gm, opt)
        _assert_atomic_close(taux.motion_feature_backward_cuda(spec, x, pool, o, d, gm, opt), want)
        if kind == "bf16":
            _assert_bf16_ulp(gx, want)
            (op,) = _pool_kernels(["OPACITY_BWD"], backend, interp, kind)
            before = op.launches
            f = pool.clone().requires_grad_()
            alpha = r.opacity_render(f, rays, fast=fast)
            ga = torch.randn(alpha.shape, generator=torch.Generator().manual_seed(53)).to(cuda)
            (gf,) = torch.autograd.grad((alpha * ga).sum(), f)
            torch.cuda.synchronize()
            assert op.launches == before + 1 and gf.dtype == torch.bfloat16
            want_a = taux.opacity_backward_plain(spec, pool, o, d, ga, opt, out_res=alpha.detach())
            _assert_atomic_close(taux.opacity_backward_cuda(spec, pool, o, d, ga, opt,
                                                            out_res=alpha.detach()), want_a)
            _assert_bf16_ulp(gf, want_a)
        else:
            alpha = r.opacity_render(pool, rays, fast=fast)
            assert not alpha.requires_grad
            with pytest.raises(ValueError, match="no kernel instance for a i8"):
                taux.opacity_backward_cuda(spec, pool, o, d, torch.zeros_like(alpha), opt)
        assert float(gx.float().abs().max()) > 0


def test_query_bf16_kernels_match_plain(cuda):
    """The bf16 query instances through N3Tree.forward: bf16 values equal
    to the plain version's, a bf16 gradient whose float32 sum matches."""
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=54)
    spec = tree._spec()
    g = torch.Generator().manual_seed(54)
    pts = torch.cat([centers[torch.randperm(len(centers), generator=g).to(cuda)],
                     centers[:300], torch.rand(500, 3, generator=g).to(cuda)])
    f = feats[: int(len(feats) * 0.9)].to(torch.bfloat16).contiguous()
    before = (tquery.QUERY_FWD_BF16.launches, tquery.QUERY_BWD_BF16.launches)
    x = f.clone().requires_grad_()
    v = tree(x, pts)
    gv = torch.randn(v.shape, generator=g).to(cuda).to(torch.bfloat16)
    (gx,) = torch.autograd.grad((v * gv).sum(), x)
    torch.cuda.synchronize()
    assert (tquery.QUERY_FWD_BF16.launches, tquery.QUERY_BWD_BF16.launches) == (before[0] + 1, before[1] + 1)
    vp, _, dp = tquery.query_forward_plain(spec, f, pts)
    assert v.dtype == torch.bfloat16 and torch.equal(v.detach(), vp)
    want = tquery.query_backward_plain(dp, gv, f.shape[0])
    got = tquery.query_backward_cuda(dp, gv.contiguous(), f.shape[0])
    assert got.dtype == torch.float32 and gx.dtype == torch.bfloat16
    _assert_atomic_close(got, want)
    _assert_bf16_ulp(gx, want)


def _query_points(cuda, centers, n_tail, seed):
    """Every centre in a seeded order, a duplicated few and random points
    (some in empty space), n_tail more so that the last warp is partial."""
    g = torch.Generator().manual_seed(seed)
    return torch.cat([centers[torch.randperm(len(centers), generator=g).to(cuda)], centers[:300],
                      torch.rand(500 + n_tail, 3, generator=g).to(cuda)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [28, 4, 5, 8])
def test_query_forward_units_match_plain(cuda, dtype, D):
    """Every copy unit the row and pointers allow (K8b, `query_fwd.cuh`:
    the D = 28 and 4 instances and the generic one), bit for bit against
    the plain version, each launch counted under its unit; the wrapper picks
    the widest."""
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=57)
    spec = tree._spec()
    g = torch.Generator().manual_seed(57)
    f = torch.randn(int(feats.shape[0] * 0.9), D, generator=g).to(cuda).to(dtype)
    pts = _query_points(cuda, centers, 13, 57)
    want = tquery.query_forward_plain(spec, f, pts)
    rule = tquery.query_unit(D, dtype, (f.data_ptr(),))
    kind = "f32" if dtype == torch.float32 else "bf16"
    for unit in [u for u in tquery.QUERY_UNITS[dtype] if u <= rule and (D * f.element_size()) % u == 0]:
        before = dict(tquery.QUERY_FWD_UNIT_LAUNCHES)
        got = tquery.query_forward_cuda(spec, f, pts, unit=unit)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (unit, D)
        after = dict(tquery.QUERY_FWD_UNIT_LAUNCHES)
        assert after[f"{kind} {unit}"] == before[f"{kind} {unit}"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
    before = tquery.QUERY_FWD_UNIT_LAUNCHES[f"{kind} {rule}"]
    got = tquery.query_forward_cuda(spec, f, pts)
    assert tquery.QUERY_FWD_UNIT_LAUNCHES[f"{kind} {rule}"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("points", ["every", "twelfth"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [28, 4, 6, 3])
def test_query_backward_units_match_plain(cuda, dtype, D, points):
    """Every unit of the query backward the row and pointers allow (K8b,
    `query_bwd.cuh`: the D = 28 and 4 instances and the generic one), on
    every leaf centre with duplicated points and points in empty space, and
    on a twelfth of them, within the atomic tolerance of the plain version
    with a partial last warp, each launch counted under its unit; the
    wrapper picks the widest unit; a wider forced unit raises."""
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=59)
    spec = tree._spec()
    M = int(feats.shape[0] * 0.9)
    pts = _query_points(cuda, centers, 11, 59)
    if points == "twelfth":
        pts = pts[: len(pts) // 12 + 5]
    didx = tquery.query_forward_plain(spec, feats[:M], pts)[2]
    g = torch.Generator().manual_seed(59)
    gv = torch.randn(pts.shape[0], D, generator=g).to(cuda).to(dtype)
    want = tquery.query_backward_plain(didx, gv, M)
    kind = "f32" if dtype == torch.float32 else "bf16"
    rule = tquery.query_bwd_unit(D, dtype, (gv.data_ptr(), 256))
    assert rule == {(4, 28): 16, (4, 4): 16, (4, 6): 8, (4, 3): 4, (2, 28): 8, (2, 4): 8, (2, 6): 4,
                    (2, 3): 2}[gv.element_size(), D]
    for unit in [u for u in tquery.QUERY_BWD_UNITS[dtype] if u <= rule]:
        before = dict(tquery.QUERY_BWD_UNIT_LAUNCHES)
        got = tquery.query_backward_cuda(didx, gv, M, unit=unit)
        torch.cuda.synchronize()
        _assert_atomic_close(got, want)
        after = dict(tquery.QUERY_BWD_UNIT_LAUNCHES)
        assert after[f"{kind} {unit}"] == before[f"{kind} {unit}"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
    before = tquery.QUERY_BWD_UNIT_LAUNCHES[f"{kind} {rule}"]
    _assert_atomic_close(tquery.query_backward_cuda(didx, gv, M), want)
    assert tquery.QUERY_BWD_UNIT_LAUNCHES[f"{kind} {rule}"] == before + 1
    wider = [u for u in tquery.QUERY_BWD_UNITS[dtype] if u > rule]
    if wider:
        with pytest.raises(ValueError, match="at most"):
            tquery.query_backward_cuda(didx, gv, M, unit=wider[-1])


def test_query_backward_misaligned_gradients_take_a_narrower_unit(cuda):
    """Value gradients 4 bytes past a 16-byte boundary take the 4-byte unit
    (one value), within the atomic tolerance of plain."""
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=60)
    spec = tree._spec()
    M, D = feats.shape
    pts = _query_points(cuda, centers, 5, 60)
    didx = tquery.query_forward_plain(spec, feats, pts)[2]
    flat = torch.randn(pts.shape[0] * D + 1, generator=torch.Generator().manual_seed(60)).to(cuda)
    gv = flat[1:].view(-1, D)
    before = tquery.QUERY_BWD_UNIT_LAUNCHES["f32 4"]
    _assert_atomic_close(tquery.query_backward_cuda(didx, gv, M), tquery.query_backward_plain(didx, gv, M))
    assert tquery.QUERY_BWD_UNIT_LAUNCHES["f32 4"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_query_forward_misaligned_pool_takes_a_narrower_unit(cuda, dtype):
    """A pool that starts 4 bytes (bf16: 2) past a 16-byte boundary takes
    the 4-byte (2-byte) instance, named and counted; a forced wider unit
    raises."""
    tree, feats, centers = _shell(cuda, fmt="SH9", ddim=28, seed=58)
    spec = tree._spec()
    M, D = feats.shape
    flat = torch.empty(M * D + 1, dtype=dtype, device=cuda)
    f = flat[1:].view(M, D)
    f.copy_(feats.to(dtype))
    pts = _query_points(cuda, centers, 7, 58)
    kind, narrow = ("f32", 4) if dtype == torch.float32 else ("bf16", 2)
    assert tquery.query_unit(D, dtype, (f.data_ptr(),)) == narrow
    before = tquery.QUERY_FWD_UNIT_LAUNCHES[f"{kind} {narrow}"]
    got = tquery.query_forward_cuda(spec, f, pts)
    torch.cuda.synchronize()
    assert tquery.QUERY_FWD_UNIT_LAUNCHES[f"{kind} {narrow}"] == before + 1
    want = tquery.query_forward_plain(spec, f, pts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="this launch takes at most"):
        tquery.query_forward_cuda(spec, f, pts, unit=8)
    with pytest.raises(ValueError, match="must be one of"):
        tquery.query_forward_cuda(spec, feats.to(dtype), pts, unit=3)


@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("pool", ["f32", "bf16"])
@pytest.mark.parametrize("fast", [False, True])
def test_opacity_instances_match_plain(cuda, backend, interp, pool, fast):
    """Every K9a instance (structure, nearest or trilinear, float32 or
    bf16) against its plain version within ATOMIC_RTOL, single pass and two
    passes, on a cotangent that is 0 on a third of the rays (the rays that
    return before their march) and with opaque rays."""
    tree, feats, _ = _shell(cuda, seed=59)
    feats = feats.clone()
    feats[::2, -1] = feats[::2, -1].abs() * 1e4  # opaque rays: alpha 1.0 exactly
    o, d = _rays(cuda, 2048, seed=59)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
    opt = r._get_options(fast)
    spec = tree._spec() if backend == "tree" else tree._baked_spec()
    f = feats if pool == "f32" else feats.to(torch.bfloat16)
    g = torch.randn(o.shape[0], 1, generator=torch.Generator().manual_seed(59)).to(cuda)
    g[::3] = 0.0
    alpha = trender.volume_render_cuda(spec, f, o, d, d, opt)[:, -1:].contiguous()
    assert bool((alpha == 1.0).any())
    counter = taux._kernel_for(spec, opt, taux._OPACITY_INSTANCES, f)
    before = counter.launches
    got = taux.opacity_backward_cuda(spec, f, o, d, g, opt, out_res=alpha)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = taux.opacity_backward_plain(spec, f, o, d, g, opt, out_res=alpha)
    _assert_atomic_close(got, want)
    assert not bool(got[:, :-1].any()) and float(got[:, -1].abs().max()) > 0


def test_pool_types_without_an_instance_raise(cuda):
    """A pool type with no kernel instance raises; it is never converted
    to run another instance."""
    tree, feats, _ = _shell(cuda, depth=4)
    o, d = _rays(cuda, 16)
    r = stt.VolumeRenderer(tree)
    half = feats.to(torch.float16)
    with pytest.raises(ValueError, match="no kernel instance for a float16"):
        r(half, stt.Rays(o, d, d))
    with pytest.raises(ValueError, match="no kernel instance for a float16"):
        r.render_depth(half, stt.Rays(o, d, d))
    with pytest.raises(ValueError, match="no kernel instance for a float16"):
        r.render_frames(half[None], stt.Rays(o, d, d))
    with pytest.raises(ValueError, match="float16 pool"):
        tree(half, o[:4])
    q = stt.quantize_features(feats)
    with pytest.raises(TypeError, match="no gradient"):
        trender.volume_render_backward(r._render_spec(), q, o, d, d,
                                       torch.zeros(o.shape[0], 4, device=cuda), r._get_options())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tree(q, o[:4])


# ---------------------------------------------------------------------------
# K2's vector widths: width 4 (the three-colour rows in 16-, 8- or 4-byte
# loads; on the bake with a float32 pool a sample's loads, then the next
# sample's lookup, before it composites) equal to width 1 bit for bit.

# (format, data_dim, the width `render_fwd_width` picks): 4 only for the
# three-colour rows with no spare column; SH9 at D = 32 leaves columns 27-30
# unread; SG7 runs on the 9-term instance.
FWD_CASES = {"sh9": ("SH9", 28, 4), "sh9_rot": ("SH9", 28, 4), "rgba": ("RGBA", 4, 4),
             "sh1": ("SH1", 4, 4), "sh4": ("SH4", 13, 1), "sg7": ("SG7", 22, 1),
             "sh9_d32": ("SH9", 32, 1)}


def _qr_rotations(M, seed):
    """(M, 4, 4) float32 rotations from the QR of seeded normal matrices."""
    q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(seed))
    rot = torch.eye(4).repeat(M, 1, 1)
    rot[:, :3, :3] = torch.linalg.qr(q)[0]
    return rot


def _march(spec, pool, o, d, opt, weights, width=None):
    """(out, waccum or None) of K2 through its wrappers."""
    if weights:
        return trender.volume_render_with_weight_accum_cuda(spec, pool, o, d, d, opt, width=width)
    return trender.volume_render_cuda(spec, pool, o, d, d, opt, width=width), None


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_render_fwd_widths_match(cuda, backend, case):
    """K2's width 4 equals its width 1 (the earlier loop) bit for bit on
    every FWD_CASES row, float32, bf16 and int8 pools, with and without
    weights (the weights at the atomic tolerance), exact, fast, thresholded
    with stop_thresh > 0 (the break after a lookup made ahead) and with a
    small max_steps that cuts rays mid-march; the launch picks
    `render_fwd_width`'s width and counts it, and width 4 on any other row
    raises. Float32 outputs also against plain."""
    fmt, ddim, width = FWD_CASES[case]
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, fmt=fmt, ddim=ddim, seed=70)
    if case == "sh9_rot":
        spec = spec.with_(transformation_matrices=_qr_rotations(feats.shape[0], 70).to(cuda))
    r = stt.VolumeRenderer(tree, backend=backend)
    base = r._get_options(False)
    opts = {"exact": base, "fast": r._get_options(True),
            "stop": dataclasses.replace(base, sigma_thresh=0.01, stop_thresh=0.01),
            "max_steps": dataclasses.replace(base, max_steps=5)}
    for name, o_ in opts.items():
        for kind, p in _fwd_pools(feats):
            label = f"{case} {backend} {kind} {name}"
            for weights in (False, True):
                before = trender.FWD_WIDTH_LAUNCHES[width]
                out, w = _march(spec, p, o, d, o_, weights)
                torch.cuda.synchronize()
                assert trender.FWD_WIDTH_LAUNCHES[width] == before + 1, label
                out1, w1 = _march(spec, p, o, d, o_, weights, width=1)
                assert torch.equal(out, out1), label
                if weights:
                    _assert_atomic_close(w, w1)
                if width == 1:
                    with pytest.raises(RuntimeError, match="CUDA error"):
                        _march(spec, p, o, d, o_, weights, width=4)
                else:
                    assert torch.equal(out, _march(spec, p, o, d, o_, weights, width=4)[0]), label
            if kind == "f32":
                torch.testing.assert_close(out, trender.volume_render_plain(spec, p, o, d, d, o_),
                                           atol=ATOL, rtol=0)
        if name == "stop":
            assert bool((out[:, -1] >= 1.0 - o_.stop_thresh).any()), "no ray stopped"


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_render_bwd_widths_match(cuda, backend, interp, case):
    """K3's and K3+K4's width 4 (the row in vectors, vector atomics; under
    interp the corners from the own lookup) and width 1 (the earlier loop)
    against plain on every FWD_CASES row, float32 and bf16 pools, exact
    (single pass), fast (two passes) and with a small max_steps, within the
    atomic tolerance, with a gradient in the plain version's rows and no
    other; the launch takes `render_fwd_width`'s width and counts it in
    MARCH_BWD_WIDTH_LAUNCHES, and width 4 on any other row raises in
    Python."""
    fmt, ddim, width = FWD_CASES[case]
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, fmt=fmt, ddim=ddim, seed=72)
    if case == "sh9_rot":
        spec = spec.with_(transformation_matrices=_qr_rotations(feats.shape[0], 72).to(cuda))
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
    base = r._get_options(False)
    opts = {"exact": base, "fast": r._get_options(True),
            "max_steps": dataclasses.replace(base, max_steps=5)}
    g_out = torch.randn(o.shape[0], 4, generator=torch.Generator().manual_seed(72)).to(cuda)
    for name, o_ in opts.items():
        for kind, p in _fwd_pools(feats)[:2]:
            label = f"{case} {backend} interp={interp} {kind} {name}"
            out = trender.volume_render_cuda(spec, p, o, d, d, o_)
            g = g_out[:, :out.shape[1]].contiguous()
            want = trender.volume_render_backward_plain(spec, p, o, d, d, g, o_, out_res=out)
            rows = (want != 0).any(dim=1)
            assert bool(rows.any()), label
            before = trender.MARCH_BWD_WIDTH_LAUNCHES[width]
            got = trender.volume_render_backward_cuda(spec, p, o, d, d, g, o_, out_res=out)
            torch.cuda.synchronize()
            assert trender.MARCH_BWD_WIDTH_LAUNCHES[width] == before + 1, label
            for w in sorted({1, width}):
                g_w = got if w == width else trender.volume_render_backward_cuda(
                    spec, p, o, d, d, g, o_, out_res=out, width=w)
                _assert_atomic_close(g_w, want)
                assert torch.equal((g_w != 0).any(dim=1), rows), label
            if width == 1:
                with pytest.raises(ValueError, match="width 4 takes only"):
                    trender.volume_render_backward_cuda(spec, p, o, d, d, g, o_, out_res=out, width=4)


def test_render_fwd_misaligned_pointers_take_width_1(cuda):
    """A pool view off its 16-byte alignment, an int8 pool whose scale is
    off it, or rotation matrices off it take width 1 (and width 4 on them
    raises), with the aligned launch's output bit for bit, nearest and
    interp (K2+K4 has both widths since its redesign)."""
    tree, spec, feats, _, o, d = _tape_scene(cuda, "baked", seed=71)
    opt = stt.VolumeRenderer(tree)._get_options(False)
    M, D = feats.shape
    rot = _qr_rotations(M, 71).to(cuda)
    shifted = torch.empty(M * D + 1, device=cuda)[1:].view(M, D)
    shifted.copy_(feats)
    q = stt.quantize_features(feats)
    q_off = stt.QuantizedFeatures(q.q, torch.empty(D + 1, device=cuda)[1:].copy_(q.scale), q.zero)
    rot_off = torch.empty(M * 16 + 1, device=cuda)[1:].view(M, 4, 4)
    rot_off.copy_(rot)
    # (spec, pool, their aligned counterparts)
    cases = ((spec, shifted, spec, feats), (spec, q_off, spec, q),
             (spec.with_(transformation_matrices=rot_off), feats, spec.with_(transformation_matrices=rot), feats))
    for sp, pool, sp_a, pool_a in cases:
        assert trender._fwd_width(sp, pool, opt) == 1 and trender._fwd_width(sp_a, pool_a, opt) == 4
        want = trender.volume_render_cuda(sp_a, pool_a, o, d, d, opt)
        before = trender.FWD_WIDTH_LAUNCHES[1]
        assert torch.equal(trender.volume_render_cuda(sp, pool, o, d, d, opt), want)
        assert trender.FWD_WIDTH_LAUNCHES[1] == before + 1
        with pytest.raises(RuntimeError, match="CUDA error"):
            trender.volume_render_cuda(sp, pool, o, d, d, opt, width=4)
    interp = dataclasses.replace(opt, interp=1)
    assert trender._fwd_width(spec, shifted, interp) == 1 and trender._fwd_width(spec, feats, interp) == 4
    want = trender.volume_render_cuda(spec, feats, o, d, d, interp)
    assert torch.equal(trender.volume_render_cuda(spec, shifted, o, d, d, interp), want)
    with pytest.raises(RuntimeError, match="CUDA error"):
        trender.volume_render_cuda(spec, shifted, o, d, d, interp, width=4)


# K2+K4's widths (the redesigned trilinear march: the own corner's row and
# the own lookup's loads reused, the corner rows in 16-byte vectors at width
# 4), each against width 1 and the plain version: (format, data_dim, width,
# rotations).
INTERP_FWD_CASES = {"sh9": ("SH9", 28, 4, False), "sh9_rot": ("SH9", 28, 4, True),
                    "rgba": ("RGBA", 4, 4, False), "sh1_rot": ("SH1", 4, 4, True),
                    "sh4_rot": ("SH4", 13, 1, True), "sg9": ("SG9", 28, 1, False),
                    "sg9_rot": ("SG9", 28, 1, True)}


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("case", list(INTERP_FWD_CASES))
def test_render_fwd_interp_widths_match(cuda, backend, case):
    """K2+K4 on a pool cut to 70% of the leaves (empty corners), float32,
    bf16 and int8, exact, fast and with a small max_steps, with and without
    weights: width 4 equals width 1 bit for bit where the row has it (the
    weights at the atomic tolerance), the launch takes `render_fwd_width`'s
    width and counts it, width 4 on any other row raises, and each pool's
    width-1 output equals the float32 kernel's on the widened or dequantized
    pool; float32 against the plain version."""
    fmt, ddim, width, rot = INTERP_FWD_CASES[case]
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, fmt=fmt, ddim=ddim, seed=72)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    if rot:
        spec = spec.with_(transformation_matrices=_qr_rotations(feats.shape[0], 72).to(cuda))
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear")
    base = r._get_options(False)
    opts = {"exact": base, "fast": r._get_options(True), "max_steps": dataclasses.replace(base, max_steps=5)}
    for name, o_ in opts.items():
        for kind, p in _fwd_pools(feats):
            label = f"{case} {backend} {kind} {name}"
            for weights in (False, True):
                before = trender.FWD_WIDTH_LAUNCHES[width]
                out, w = _march(spec, p, o, d, o_, weights)
                torch.cuda.synchronize()
                assert trender.FWD_WIDTH_LAUNCHES[width] == before + 1, label
                out1, w1 = _march(spec, p, o, d, o_, weights, width=1)
                assert torch.equal(out, out1), label
                if weights:
                    _assert_atomic_close(w, w1)
                if width == 1:
                    with pytest.raises(RuntimeError, match="CUDA error"):
                        _march(spec, p, o, d, o_, weights, width=4)
            wide = p.float() if kind != "i8" else p.q.float() * p.scale + p.zero
            assert torch.equal(out, _march(spec, wide.contiguous(), o, d, o_, False)[0]), label
            if kind == "f32":
                torch.testing.assert_close(out, trender.volume_render_plain(spec, p, o, d, d, o_),
                                           atol=ATOL, rtol=0)
    assert float(out[:, -1].max()) > 0.5


@pytest.mark.parametrize("case", ["sh9_rot", "sg9_rot", "rgba"])
def test_render_fwd_interp_tree_equals_bake(cuda, case):
    """K2+K4's tree walk (its corners' descents from the own path) and bake
    (its corners reusing the own lookup's entries) give the same exact
    outputs bit for bit, float32, bf16 and int8, with and without weights
    (the weights, summed per tree cell, at the atomic tolerance)."""
    fmt, ddim, _, rot = INTERP_FWD_CASES[case]
    tree, spec, feats, _, o, d = _tape_scene(cuda, "tree", fmt=fmt, ddim=ddim, seed=73)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    baked = tree._baked_spec()
    if rot:
        tm = _qr_rotations(feats.shape[0], 73).to(cuda)
        spec, baked = spec.with_(transformation_matrices=tm), baked.with_(transformation_matrices=tm)
    opt = stt.VolumeRenderer(tree, interp="trilinear")._get_options(False)
    for kind, p in _fwd_pools(feats):
        for weights in (False, True):
            got_t, w_t = _march(spec, p, o, d, opt, weights)
            got_b, w_b = _march(baked, p, o, d, opt, weights)
            assert torch.equal(got_t, got_b), f"{case} {kind} weights={weights}"
            if weights:
                _assert_atomic_close(w_b, w_t)
    assert float(got_t[:, -1].max()) > 0.5


# ---------------------------------------------------------------------------
# K9c and K9d, the motion-feature march, redesigned for Hopper: every
# instance (both structures, nearest and interp, float32, bf16 and int8
# pools) at each Kd capacity and bone count, at both widths: 4 (one float4
# and one int4 load an LBS row at nb 4, the joint table from shared memory
# in float4s), which the wrappers take where `mf_width` allows it, and 1
# (scalar loads), forced and on LBS tables off their alignment; and K9d's
# joint table at its limit (width 1 with more than 40 KB of shared memory:
# the launch raises its dynamic shared-memory attribute, beside the tree
# walk's interp path slots). (Kd, nb, J) of each case:
MF_CASES = ((3, 1, 7), (16, 4, 32), (32, 5, 7), (16, 4, 200))


def _mf_widths(counts, call):
    """``call()``'s result and the width its one launch took (``counts``:
    a width-launch counter of `ops/render_aux.py`)."""
    before = dict(counts)
    got = call()
    launched = [w for w in counts if counts[w] != before[w]]
    assert len(launched) == 1 and counts[launched[0]] == before[launched[0]] + 1, launched
    return got, launched[0]


def _mf_case(cuda, backend, interp, kind, seed):
    """(renderer options by fast, pool, rays, feats): the shell's pool cut
    to 70% of its rows, so that interp samples meet empty leaves, and rays
    of which some miss the cube."""
    tree, feats, _ = _shell(cuda, seed=seed)
    feats = feats[: int(feats.shape[0] * 0.7)].contiguous()
    pool = feats if kind == "f32" else _pool_of(kind, feats)[0]
    o, d = _rays(cuda, 2048, seed=seed)
    r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
    return tree, r, pool, feats, o, d


def _off16(t):
    """A copy of t 4 bytes off its 16-byte alignment (a sliced tensor)."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


def _mf_spec(tree, backend, jf, sw, ji):
    if backend == "baked":
        return tree._baked_spec(skinning_weights=sw, joint_index=ji)
    return tree._spec(joint_features=jf, skinning_weights=sw, joint_index=ji)


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("kind", ["f32", "bf16", "i8"])
def test_mf_fwd_instances_match_plain(cuda, backend, interp, kind):
    """K9c on every MF_CASES row, exact and fast: within ATOL of plain,
    zero on exactly the rays the plain version gives zero (the misses), at
    `mf_width`'s width (4 on the aligned 4-bone rows); width 1, forced and
    on LBS tables off their alignment, equal bit for bit to that launch,
    where width 4 raises; a pool instance equal to the float32 kernel on
    the widened pool."""
    tree, r, pool, feats, o, d = _mf_case(cuda, backend, interp, kind, seed=81)
    wide = feats if kind == "f32" else _pool_of(kind, feats)[1]
    for kd, nb, J in MF_CASES:
        jf, sw, ji = _lbs(cuda, feats.shape[0], J, kd, nb, seed=kd + nb + J)
        spec = _mf_spec(tree, backend, jf, sw, ji)
        spec_off = _mf_spec(tree, backend, jf, _off16(sw), _off16(ji))
        for fast in (False, True):
            opt = r._get_options(fast)
            label = f"{backend} interp={interp} {kind} kd={kd} nb={nb} J={J} fast={fast}"
            got, width = _mf_widths(taux.MF_FWD_WIDTH_LAUNCHES,
                                    lambda: taux.motion_feature_forward_cuda(spec, jf, pool, o, d, opt))
            assert width == (4 if (kd, nb, J) in ((16, 4, 32), (16, 4, 200)) else 1), label
            want = taux.motion_feature_render_plain(spec, jf, pool, o, d, opt)
            torch.testing.assert_close(got, want, atol=ATOL, rtol=0, msg=label)
            assert torch.equal((got == 0).all(1), (want == 0).all(1)), label
            assert bool((want == 0).all(1).any()) and bool((want != 0).any(1).any()), label
            assert torch.equal(taux.motion_feature_forward_cuda(spec, jf, pool, o, d, opt, width=1), got), label
            got_off, width = _mf_widths(taux.MF_FWD_WIDTH_LAUNCHES,
                                        lambda: taux.motion_feature_forward_cuda(spec_off, jf, pool, o, d, opt))
            assert width == 1 and torch.equal(got_off, got), label
            with pytest.raises(ValueError, match="width 4 takes"):
                taux.motion_feature_forward_cuda(spec_off, jf, pool, o, d, opt, width=4)
            if kind != "f32":
                assert torch.equal(taux.motion_feature_forward_cuda(spec, jf, wide, o, d, opt), got), label


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("kind", ["f32", "bf16", "i8"])
def test_mf_bwd_instances_match_plain(cuda, backend, interp, kind):
    """K9d on every MF_CASES row, on aligned LBS tables and grad_out at
    `mf_width`'s width (4 on the 4-bone rows whose tables fit in
    KERNEL_MF_VECTOR_SMEM) and at width 1, on unaligned ones (width 1), and
    at the joint-table limit (J * (Kd | 1) at KERNEL_MAX_JOINT_TABLE: width
    1, more than 40 KB of shared memory, which the launch sets as its
    dynamic shared-memory size; beside the tree walk's interp path slots),
    within the atomic tolerance of plain, with a gradient in the plain
    version's joint rows and no other."""
    tree, r, pool, feats, o, d = _mf_case(cuda, backend, interp, kind, seed=82)
    limit = (32, 4, taux.KERNEL_MAX_JOINT_TABLE // 33)
    for kd, nb, J in MF_CASES + (limit,):
        jf, sw, ji = _lbs(cuda, feats.shape[0], J, kd, nb, seed=kd + nb + J)
        g = torch.randn(o.shape[0], kd, generator=torch.Generator().manual_seed(kd)).to(cuda)
        for aligned in (True, False):
            spec = _mf_spec(tree, backend, jf, *((sw, ji) if aligned else (_off16(sw), _off16(ji))))
            g_in = g if aligned else _off16(g)
            opt = r._get_options(False)
            label = f"{backend} interp={interp} {kind} kd={kd} nb={nb} J={J} aligned={aligned}"
            want = taux.motion_feature_backward_plain(spec, jf, pool, o, d, g, opt)
            got, width = _mf_widths(taux.MF_BWD_WIDTH_LAUNCHES,
                                    lambda: taux.motion_feature_backward_cuda(spec, jf, pool, o, d, g_in, opt))
            assert width == (4 if aligned and (kd, nb, J) in ((16, 4, 32), (16, 4, 200)) else 1), label
            runs = [got] + ([taux.motion_feature_backward_cuda(spec, jf, pool, o, d, g_in, opt, width=1)]
                            if width == 4 else [])
            for g_k in runs:
                _assert_atomic_close(g_k, want)
                assert torch.equal((g_k != 0).any(1), (want != 0).any(1)), label
            assert float(want.abs().max()) > 0, label


# ---------------------------------------------------------------------------
# Recorded sample tapes (K13): the count and record kernels equal to their
# plain versions exactly; the replay forward equal to the forward march
# kernel bit for bit (exact and thresholded, compacted or not), its weights
# and the replay backward atomic sums; pool instances equal to the float32
# kernel on the widened pool.


def _tape_scene(cuda, backend, fmt="SH9", ddim=28, seed=61, depth=6):
    tree, feats, centers = _shell(cuda, depth=depth, fmt=fmt, ddim=ddim, seed=seed)
    spec = tree._baked_spec() if backend == "baked" else tree._spec()
    o, d = _rays(cuda, 2048, seed=seed)
    return tree, spec, feats, centers, o, d


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_tape_record_kernels_match_plain(cuda, backend, fast, compact):
    """record_tape launches the one-walk kernels (K13a+K13b) once each (the
    walk once more where its arena ran short) and not the earlier pair; its
    tape equals the plain versions and the earlier pair (count_samples_cuda,
    then K13b at its offsets) bit for bit."""
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend)
    opt = stt.VolumeRenderer(tree, backend=backend)._get_options(fast)
    M = feats.shape[0]
    sfx = "_BAKED" if backend == "baked" else ""
    stage, copy = getattr(ttape, "TAPE_STAGE" + sfx), getattr(ttape, "TAPE_COPY" + sfx)
    count, record = getattr(ttape, "TAPE_COUNT" + sfx), getattr(ttape, "TAPE_RECORD" + sfx)
    before = [k.launches for k in (stage, copy, count, record)] + [ttape.ARENA_RERUNS["reruns"]]
    tp = ttape.record_tape(spec, M, o, d, d, opt, compact=compact, record_t=True)
    torch.cuda.synchronize()
    after = [k.launches for k in (stage, copy, count, record)] + [ttape.ARENA_RERUNS["reruns"]]
    stage_n, copy_n, count_n, record_n, reruns = [a - b for a, b in zip(after, before)]
    assert (stage_n, copy_n, count_n, record_n) == (1 + reruns, 1, 0, 0) and reruns in (0, 1)
    n_occ, n_tot = ttape.count_samples_plain(spec, M, o, d, opt)
    assert torch.equal(tp.counts, n_occ if compact else n_tot)
    want = ttape.record_samples_plain(spec, M, o, d, opt, tp.offsets, compact, True, True, True)
    k_occ, k_tot = ttape.count_samples_cuda(spec, M, o, d, opt)
    assert torch.equal(k_occ, n_occ) and torch.equal(k_tot, n_tot)
    pair = ttape.record_samples_cuda(spec, M, o, d, opt, tp.offsets, compact, True, True, True)
    for got, w, p in zip((tp.idx, tp.dt, tp.cell, tp.tval, tp.dscale), want, pair):
        assert torch.equal(got, w) and torch.equal(got, p)
    assert tp.n_samples > 0 and tp.S == int(tp.counts.max())


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("case", ["overflow", "one_ray", "indirect", "no_cells", "fast_full"])
def test_tape_stage_and_copy_kernels(cuda, backend, case):
    """The one-walk kernels on the cases the recorder meets: an arena of one
    chunk (the walk counts what it lacked, and the rerun with that capacity
    gives the same tape), one ray, an indirect tape with t (cells, no
    rows), the row stream alone, fast mode uncompacted; each stream equal
    to the plain versions and to the earlier pair bit for bit."""
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, seed=64)
    opt = stt.VolumeRenderer(tree, backend=backend)._get_options(case == "fast_full")
    M = feats.shape[0]
    compact = case != "fast_full"
    want_idx, want_cell, want_t = case != "indirect", case != "no_cells", case in ("indirect", "fast_full")
    capacity = 1 if case == "overflow" else None
    if case == "one_ray":
        o, d = o[5:6].contiguous(), d[5:6].contiguous()
    before = ttape.ARENA_RERUNS["reruns"]
    got = ttape.record_streams(spec, M, o, d, opt, compact, want_idx, want_cell, want_t, capacity=capacity)
    torch.cuda.synchronize()
    assert ttape.ARENA_RERUNS["reruns"] - before == (1 if case == "overflow" else 0)
    counts, offsets, S = got[:3]
    n_occ, n_tot = ttape.count_samples_plain(spec, M, o, d, opt)
    assert torch.equal(counts, n_occ if compact else n_tot) and S == int(counts.max())
    assert torch.equal(offsets[1:], torch.cumsum(counts, 0).to(torch.int32))
    plain = ttape.record_samples_plain(spec, M, o, d, opt, offsets, compact, want_idx, want_cell, want_t)
    pair = ttape.record_samples_cuda(spec, M, o, d, opt, offsets, compact, want_idx, want_cell, want_t)
    for g, p, q in zip(got[3:], plain, pair):
        assert (g is None) == (p is None) == (q is None)
        assert g is None or (torch.equal(g, p) and torch.equal(g, q))


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_tape_replay_kernel_equals_march_kernel(cuda, backend, fast, compact):
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, seed=62)
    M = feats.shape[0]
    q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(62))
    rot = torch.eye(4).repeat(M, 1, 1)
    rot[:, :3, :3] = torch.linalg.qr(q)[0]
    r = stt.VolumeRenderer(tree, backend=backend)
    opt = r._get_options(fast)
    tp = ttape.record_tape(spec, M, o, d, d, opt, compact=compact)
    for rspec in (spec, spec.with_(transformation_matrices=rot.to(cuda))):
        before = ttape.TAPE_REPLAY_FWD.launches
        out, w = ttape.replay_render_weighted(tp, feats, opt, rspec)
        torch.cuda.synchronize()
        assert ttape.TAPE_REPLAY_FWD.launches == before + 1
        want, w_want = trender.volume_render_with_weight_accum_cuda(rspec, feats, o, d, d, opt)
        assert torch.equal(out, want)
        _assert_atomic_close(w, w_want)
        plain, w_plain = ttape.replay_forward_plain(tp, feats, opt, rspec, True)
        torch.testing.assert_close(out, plain, atol=ATOL, rtol=0)
        _assert_atomic_close(w, w_plain)


@pytest.mark.parametrize("kind", ["bf16", "i8"])
def test_tape_replay_pool_instances(cuda, kind):
    tree, spec, feats, _, o, d = _tape_scene(cuda, "baked", seed=63)
    opt = stt.VolumeRenderer(tree)._get_options(False)
    tp = ttape.record_tape(spec, feats.shape[0], o, d, d, opt)
    pool = feats.to(torch.bfloat16) if kind == "bf16" else stt.quantize_features(feats)
    wide = pool.float() if kind == "bf16" else pool.dequantize()
    k = ttape.TAPE_REPLAY_FWD_BF16 if kind == "bf16" else ttape.TAPE_REPLAY_FWD_I8
    before = k.launches
    got = ttape.replay_render(tp, pool, opt, spec)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert torch.equal(got, ttape.replay_render(tp, wide, opt, spec))
    torch.testing.assert_close(got, ttape.replay_forward_plain(tp, pool, opt, spec)[0], atol=ATOL,
                               rtol=0)


# The replay backward's cases: (format, data_dim, the vector width the
# wrapper picks: 4 only for the three-colour rows with no spare column).
# SH9 at D = 32 leaves columns 27-30 between the colors and sigma without
# gradient; SG7 runs on the 9-term instance.
BWD_CASES = {"sh9": ("SH9", 28, 4), "sh9_bf16": ("SH9", 28, 4), "sh9_rot": ("SH9", 28, 4),
             "rgba": ("RGBA", 4, 4), "sh4": ("SH4", 13, 1), "sg7": ("SG7", 22, 1),
             "sh9_d32": ("SH9", 32, 1), "indirect": ("SH9", 28, 4)}
# Every case on both structures, but the indirect tape (a tree walk's cells).
BWD_COMBOS = [(b, c) for c in BWD_CASES for b in ("baked", "tree") if c != "indirect" or b == "tree"]


def _bwd_case(cuda, backend, case, seed, compact=True):
    """(spec, pool, tape, index table or None, rays, options, width) of a
    BWD_CASES case: the tape recorded on ``backend``'s structure, exact;
    the indirect tape replayed after a re-point, through its table."""
    fmt, ddim, width = BWD_CASES[case]
    tree, spec, feats, centers, o, d = _tape_scene(cuda, backend, fmt=fmt, ddim=ddim, seed=seed)
    opt = stt.VolumeRenderer(tree, backend=backend)._get_options(False)
    M = feats.shape[0]
    if case == "sh9_rot":
        q = torch.randn(M, 3, 3, generator=torch.Generator().manual_seed(seed))
        rot = torch.eye(4).repeat(M, 1, 1)
        rot[:, :3, :3] = torch.linalg.qr(q)[0]
        spec = spec.with_(transformation_matrices=rot.to(cuda))
    tp = ttape.record_tape(spec, M, o, d, d, opt, compact=compact, indirect=case == "indirect")
    table = None
    if case == "indirect":
        tree.construct_tree(centers[torch.randperm(M, generator=torch.Generator().manual_seed(seed)).to(cuda)])
        spec = tree._spec()
        table = ttape.pack_index_table(spec.data_flat)
    pool = feats.to(torch.bfloat16) if case == "sh9_bf16" else feats
    return spec, pool, tp, table, (o, d), opt, width


@pytest.mark.parametrize("backend,case", BWD_COMBOS)
def test_tape_replay_backward_matches_plain(cuda, backend, case):
    """K13d through autograd launches the width `replay_bwd_width` picks
    (4 for RGBA, SH1 and SH9 rows with three colours and no spare column,
    else 1); each width the row allows, launched by hand, against plain and
    K3 at the atomic tolerance; width 4 on any other row raises."""
    spec, pool, tp, table, (o, d), opt, width = _bwd_case(cuda, backend, case, seed=64)
    x = pool.clone().requires_grad_()
    out = ttape.replay_render(tp, x, opt, spec, index_table=table)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(64)).to(cuda)
    k = ttape.TAPE_REPLAY_BWD_BF16 if pool.dtype == torch.bfloat16 else ttape.TAPE_REPLAY_BWD
    before, w_before = k.launches, ttape.BWD_WIDTH_LAUNCHES[width]
    (gx,) = torch.autograd.grad((out * g).sum(), x)
    torch.cuda.synchronize()
    assert k.launches == before + 1 and gx.dtype == pool.dtype
    assert ttape.BWD_WIDTH_LAUNCHES[width] == w_before + 1
    out = out.detach()
    want = ttape.replay_backward_plain(tp, pool, opt, g, out, spec, table)
    k3 = trender.volume_render_backward_cuda(spec, pool, o, d, d, g, opt, out_res=out)
    got = ttape.replay_backward_cuda(tp, pool, opt, g, out, spec, table)
    _assert_atomic_close(got, want)
    _assert_atomic_close(got, k3)
    for w in (1, 4):
        if w > width:
            with pytest.raises(RuntimeError, match="CUDA error"):
                ttape.replay_backward_cuda(tp, pool, opt, g, out, spec, table, width=w)
            continue
        before = ttape.BWD_WIDTH_LAUNCHES[w]
        _assert_atomic_close(ttape.replay_backward_cuda(tp, pool, opt, g, out, spec, table, width=w), want)
        assert ttape.BWD_WIDTH_LAUNCHES[w] == before + 1
    assert float(got.abs().max()) > 0
    if case == "sh9_d32":
        assert not want[:, 27:31].any() and not got[:, 27:31].any()


def _fwd_pools(pool):
    """The case's pool as float32, bf16 and int8 (label, pool)."""
    f = pool.float()
    return (("f32", f), ("bf16", f.to(torch.bfloat16)), ("i8", stt.quantize_features(f)))


@pytest.mark.parametrize("backend,case", BWD_COMBOS)
def test_tape_replay_forward_widths_match(cuda, backend, case):
    """K13c's width 4 (the row in 16-, 8- or 4-byte loads) equals its width
    1 (the scalar row) bit for bit on every BWD_CASES row, float32, bf16
    and int8 pools, with and without weights (the weights too), exact and
    fast (thresholded, stop_thresh > 0: the stream prefetch's guard at the
    break); the launch picks `replay_fwd_width`'s width, and width 4 on
    any other row raises. Exact outputs also equal K2 bit for bit."""
    spec, pool, tp, table, (o, d), opt, width = _bwd_case(cuda, backend, case, seed=68)
    tree_opts = [opt]
    if case != "indirect":  # indirect tapes are recorded in exact geometry
        fast = dataclasses.replace(opt, sigma_thresh=0.01, stop_thresh=0.01)
        tree_opts.append(fast)
    for o_ in tree_opts:
        tp_ = tp if o_ is opt else ttape.record_tape(spec, pool.shape[0], o, d, d, o_)
        assert o_ is opt or o_.stop_thresh > 0
        for kind, p in _fwd_pools(pool):
            label = f"{case} {backend} {kind} stop {o_.stop_thresh}"
            for weights in (False, True):
                before = ttape.FWD_WIDTH_LAUNCHES[width]
                out, w = ttape.replay_forward_cuda(tp_, p, o_, spec, weights, table)
                torch.cuda.synchronize()
                assert ttape.FWD_WIDTH_LAUNCHES[width] == before + 1, label
                out1, w1 = ttape.replay_forward_cuda(tp_, p, o_, spec, weights, table, width=1)
                assert torch.equal(out, out1), label
                if weights:
                    _assert_atomic_close(w, w1)
                if width == 1:
                    with pytest.raises(RuntimeError, match="CUDA error"):
                        ttape.replay_forward_cuda(tp_, p, o_, spec, weights, table, width=4)
                else:
                    assert torch.equal(out, ttape.replay_forward_cuda(tp_, p, o_, spec, weights, table,
                                                                      width=4)[0])
            torch.testing.assert_close(out, ttape.replay_forward_plain(tp_, p, o_, spec, False, table)[0],
                                       atol=ATOL, rtol=0)
            if table is None and o_ is opt:
                assert torch.equal(out, trender.volume_render_cuda(spec, p, o, d, d, o_)), label
        if o_ is not opt:
            assert bool((out[:, -1] >= 1.0 - o_.stop_thresh).any()), "no ray stopped"


@pytest.mark.parametrize("case", ["sh9", "rgba", "sh4", "indirect"])
def test_tape_replay_frames_forward_equals_single_launches(cuda, case):
    """K13c's frame axis (3 frames; a direct tape on the bake, the indirect
    one on the tree walk) equals 3 single K13c launches bit for bit, each
    width the row allows, for float32, bf16 and int8 stacks; through
    `replay_render_frames` it launches once; an empty stack launches
    nothing."""
    backend = "tree" if case == "indirect" else "baked"
    spec, pool, tp, table, _, opt, width = _bwd_case(cuda, backend, case, seed=69)
    scaled = [_fwd_pools(pool.float() * (1.0 + 0.1 * n)) for n in range(3)]
    for i, kind in enumerate(("f32", "bf16", "i8")):
        frames = [s[i][1] for s in scaled]
        if kind == "i8":
            stack = stt.QuantizedFeatures(*(torch.stack(x).contiguous() for x in zip(*frames)))
        else:
            stack = torch.stack(frames)
        k = ttape._REPLAY_FWD_FRAMES[kind]
        before, w_before = k.launches, ttape.FWD_WIDTH_LAUNCHES[width]
        out = ttape.replay_render_frames(tp, stack, opt, spec, index_table=table)
        torch.cuda.synchronize()
        assert k.launches == before + 1 and ttape.FWD_WIDTH_LAUNCHES[width] == w_before + 1
        assert out.shape == (3, tp.n_rays, 4)
        for w in (1, 4):
            if w <= width:
                assert torch.equal(ttape.replay_forward_frames_cuda(tp, stack, opt, spec, table, width=w), out)
        for n in range(3):
            assert torch.equal(out[n], ttape.replay_forward_cuda(tp, frames[n], opt, spec, False, table)[0])
        torch.testing.assert_close(out, ttape.replay_forward_frames_plain(tp, stack, opt, spec, table),
                                   atol=ATOL, rtol=0)
        assert not torch.equal(out[0], out[2])
    before = ttape.TAPE_REPLAY_FWD_FRAMES.launches
    assert ttape.replay_forward_frames_cuda(tp, pool.float()[None][:0], opt, spec, table).shape == (0, tp.n_rays, 4)
    assert ttape.TAPE_REPLAY_FWD_FRAMES.launches == before


def test_tape_indirect_replay_after_repoint(cuda):
    """An indirect tape replayed after construct_tree equals the forward
    march kernel on the re-pointed tree bit for bit (tree walk)."""
    tree, spec, feats, centers, o, d = _tape_scene(cuda, "tree", seed=65)
    opt = stt.VolumeRenderer(tree, backend="tree")._get_options(False)
    M = feats.shape[0]
    tp = ttape.record_tape(spec, M, o, d, d, opt, indirect=True)
    tree.construct_tree(centers[torch.randperm(M, generator=torch.Generator().manual_seed(65)).to(cuda)])
    spec2 = tree._spec()
    assert not torch.equal(spec2.data_flat, spec.data_flat)
    table = ttape.pack_index_table(spec2.data_flat)
    got = ttape.replay_render(tp, feats, opt, spec2, index_table=table)
    assert torch.equal(got, trender.volume_render_cuda(spec2, feats, o, d, d, opt))
    torch.testing.assert_close(got, ttape.replay_forward_plain(tp, feats, opt, spec2, False, table)[0],
                               atol=ATOL, rtol=0)


def test_render_persp_tape_uses_the_kernels(cuda):
    tree, feats, _ = _shell(cuda, depth=6)
    r = stt.VolumeRenderer(tree)
    counters = (ttape.TAPE_COPY_BAKED, ttape.TAPE_RECORD_BAKED, ttape.TAPE_REPLAY_FWD)
    before = [k.launches for k in counters]
    imgs = [r.render_persp_tape(feats * s, orbit_camera(), 64, 48, fx=70.0) for s in (1.0, 0.5)]
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 0, 2]
    for s, img in zip((1.0, 0.5), imgs):
        assert torch.equal(img, r.render_persp(feats * s, orbit_camera(), 64, 48, fx=70.0))


# ---------------------------------------------------------------------------
# The temporal tape path: K13e (the tape backward's frame axis) against its
# plain version and against per-frame K13d at the atomic tolerance; K13f
# (depth replay) equal to its plain version and to the first-hit kernel
# K9b bit for bit; `render_dynamic_tape_frames` equal to
# `render_dynamic_frames` bit for bit.


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("compact", [False, True])
def test_tape_replay_frames_backward_matches_plain(cuda, case, compact):
    """K13e (3 frames; the bake, the indirect tape on the tree walk)
    through autograd launches `replay_bwd_width`'s width; each width the
    row allows against plain and against per-frame K13d at the atomic
    tolerance."""
    backend = "tree" if case == "indirect" else "baked"
    spec, pool, tp, table, _, opt, width = _bwd_case(cuda, backend, case, seed=66, compact=compact)
    stack = torch.stack([pool.float() * (1.0 + 0.1 * n) for n in range(3)]).to(pool.dtype)
    x = stack.clone().requires_grad_()
    out = ttape.replay_render_frames(tp, x, opt, spec, index_table=table)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(66)).to(cuda)
    k = ttape.TAPE_REPLAY_BWD_FRAMES_BF16 if pool.dtype == torch.bfloat16 else ttape.TAPE_REPLAY_BWD_FRAMES
    before, w_before = k.launches, ttape.BWD_WIDTH_LAUNCHES[width]
    (gx,) = torch.autograd.grad((out * g).sum(), x)
    torch.cuda.synchronize()
    assert k.launches == before + 1 and gx.dtype == stack.dtype
    assert ttape.BWD_WIDTH_LAUNCHES[width] == w_before + 1
    out = out.detach()
    want = ttape.replay_backward_frames_plain(tp, stack, opt, g, out, spec, table)
    got = ttape.replay_backward_frames_cuda(tp, stack, opt, g, out, spec, table)
    _assert_atomic_close(got, want)
    for w in (1, 4):
        if w <= width:
            _assert_atomic_close(ttape.replay_backward_frames_cuda(tp, stack, opt, g, out, spec, table, width=w),
                                 want)
    for n in range(3):
        assert torch.equal(out[n], ttape.replay_forward_cuda(tp, stack[n], opt, spec, False, table)[0])
        k13d = ttape.replay_backward_cuda(tp, stack[n], opt, g[n].contiguous(), out[n], spec, table)
        _assert_atomic_close(got[n], k13d)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_tape_depth_kernel_equals_first_hit(cuda, backend, fast, compact):
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, seed=67)
    opt = stt.VolumeRenderer(tree, backend=backend)._get_options(fast)
    tp = ttape.record_tape(spec, feats.shape[0], o, d, d, opt, compact=compact, record_t=True)
    for pool in (feats, feats.to(torch.bfloat16)):
        before = ttape.TAPE_DEPTH.launches
        got = ttape.replay_depth(tp, pool, opt, spec)
        torch.cuda.synchronize()
        assert ttape.TAPE_DEPTH.launches == before + 1
        assert torch.equal(got, ttape.replay_depth_plain(tp, pool, opt.sigma_thresh))
        assert torch.equal(got, taux.render_depth(spec, pool, o, d, opt))
        assert (got > 0).any()


def test_tape_depth_kernel_indirect(cuda):
    """An indirect tape's depth after a re-point: equal to plain and to K9b
    on the re-pointed tree (tree walk)."""
    tree, spec, feats, centers, o, d = _tape_scene(cuda, "tree", seed=68)
    opt = stt.VolumeRenderer(tree, backend="tree")._get_options(False)
    M = feats.shape[0]
    tp = ttape.record_tape(spec, M, o, d, d, opt, indirect=True, record_t=True)
    half = centers[torch.randperm(M, generator=torch.Generator().manual_seed(68)).to(cuda)[: M // 2]]
    tree.construct_tree(half)
    spec2 = tree._spec()
    table = ttape.pack_index_table(spec2.data_flat)
    pool = feats.clone()
    pool[::3, -1] = -1.0
    got = ttape.replay_depth(tp, pool, opt, spec2, index_table=table)
    assert torch.equal(got, ttape.replay_depth_plain(tp, pool, opt.sigma_thresh, table))
    assert torch.equal(got, taux.render_depth(spec2, pool, o, d, opt))


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("compact", [False, True])
def test_render_dynamic_tape_frames_uses_the_kernels(cuda, backend, compact):
    """render_dynamic_tape_frames on the shell with a 6-joint rig: per frame
    one warp, construct_tree, replay and depth replay (no march), equal to
    render_dynamic_frames bit for bit, colors and depths, exact and fast
    (the fused loop with the box advance and skip boxes off)."""
    state, feats_np, centers_np = build_shell_tree(depth=5, data_format="SH4", data_dim=13, seed=5)
    joints = np.random.RandomState(5).uniform(0.3, 0.7, (6, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(centers_np, joints, 4)
    poses = joint_pose_sequence(joints, 3, seed=5)
    src = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    feats = torch.from_numpy(feats_np).to(cuda)
    tree = stt.tree_from_numpy(state, device=cuda)
    r = stt.VolumeRenderer(tree, backend=backend)
    r.box_advance = r.skip_boxes = 0
    kw = dict(c2w=orbit_camera(), width=64, height=48, fx=70.0, update_tree=False, with_depth=True)
    march = trender.RENDER_FWD_BAKED if backend == "baked" else trender.RENDER_FWD
    counters = (twarp.WARP_FWD, tquery.CONSTRUCT_TREE, ttape.TAPE_REPLAY_FWD, ttape.TAPE_DEPTH, march)
    r.record_dynamic_persp(orbit_camera(), poses, src, centers_np, sw, ji, 64, 48, 70.0,
                           compact=compact, record_t=True)
    for fast in (False, True):
        before = [k.launches for k in counters]
        cols, deps = r.render_dynamic_tape_frames(feats, poses, src, centers_np, sw, ji, fast=fast,
                                                  compact=compact, **kw)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(counters, before)] == [3, 3, 3, 3, 0]
        want_c, want_d = r.render_dynamic_frames(feats, poses, src, centers_np, sw, ji, fast=fast, **kw)
        assert torch.equal(cols, want_c) and torch.equal(deps, want_d)
        assert (deps > 0).any()


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_dynamic_tape_cache_key_on_the_card(cuda, backend):
    """The dynamic tape's cache key (D1): the same animation twice with
    update_tree=True records once (the record kernels launch once; the tape
    is re-filed under the adopted table's version), its tape equal to a
    fresh record bit for bit; another animation adopted in between makes
    the next call record again; CUDA tensors key by identity and version,
    so an in-place edit records again, as does an equal tensor of another
    identity, and the same tensor unedited hits."""
    state, feats_np, centers_np = build_shell_tree(depth=5, data_format="SH4", data_dim=13, seed=6)
    joints = np.random.RandomState(6).uniform(0.3, 0.7, (6, 3)).astype(np.float32)
    sw, ji = skin_to_nearest_joints(centers_np, joints, 4)
    poses = joint_pose_sequence(joints, 3, seed=6)
    other = joint_pose_sequence(joints, 3, seed=7)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (poses, np.tile(np.eye(4, dtype=np.float32), (6, 1, 1)), centers_np, sw, ji)]
    feats = torch.from_numpy(feats_np).to(cuda)
    tree = stt.tree_from_numpy(state, device=cuda)
    r = stt.VolumeRenderer(tree, backend=backend)
    kw = dict(c2w=orbit_camera(), width=64, height=48, fx=70.0)
    rec = ttape.TAPE_COPY_BAKED if backend == "baked" else ttape.TAPE_COPY
    before = rec.launches
    r.render_dynamic_tape_frames(feats, *args, **kw)
    r.render_dynamic_tape_frames(feats, *args, **kw)
    torch.cuda.synchronize()
    assert rec.launches == before + 1
    tape = r.record_dynamic_persp(kw["c2w"], *args, 64, 48, 70.0)
    assert rec.launches == before + 1
    fresh = stt.VolumeRenderer(tree, backend=backend).record_dynamic_persp(kw["c2w"], *args, 64, 48, 70.0)
    for f in dataclasses.fields(tape):
        a, b = getattr(tape, f.name), getattr(fresh, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    r.render_dynamic_tape_frames(feats, torch.from_numpy(other).to(cuda), *args[1:], **kw)
    got = r.render_dynamic_tape_frames(feats, *args, update_tree=False, **kw)
    want = stt.VolumeRenderer(tree, backend=backend).render_dynamic_tape_frames(feats, *args, update_tree=False, **kw)
    assert torch.equal(got, want)
    n = rec.launches
    args[2].add_(0.0)
    r.render_dynamic_tape_frames(feats, *args, update_tree=False, **kw)
    torch.cuda.synchronize()
    assert rec.launches == n + 1
    r.render_dynamic_tape_frames(feats, *args, update_tree=False, **kw)
    args[2] = args[2].clone()
    r.render_dynamic_tape_frames(feats, *args, update_tree=False, **kw)
    torch.cuda.synchronize()
    assert rec.launches == n + 2


# ---------------------------------------------------------------------------
# Minibatch tape training (K14a-c) and the dense-grid weight pass (K12).


def _subset_case(cuda, compact=True, record_t=True):
    tree, spec, feats, _, o, d = _tape_scene(cuda, "baked", seed=71)
    opt = stt.VolumeRenderer(tree)._get_options(False)
    tp = ttape.record_tape(spec, feats.shape[0], o, d, d, opt, compact=compact, record_t=record_t)
    return tree, spec, feats, opt, tp


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("with_rays", [False, True])
def test_subset_gather_kernel_matches_plain(cuda, compact, with_rays):
    _, _, _, _, tp = _subset_case(cuda, compact)
    rng = np.random.RandomState(72)
    ids_np = np.concatenate([rng.randint(0, tp.n_rays, 3000), [0, 0, tp.n_rays - 1]])
    src = tsub.TapeRowSource(tp, keep_cells=True)
    offsets_np = tsub._subset_plan(src, ids_np)[1]
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(cuda)
    offsets = torch.from_numpy(offsets_np).to(cuda)
    before = tsub.SUBSET_GATHER.launches
    got = tsub.subset_gather_cuda(tp, ids, offsets, True, True, with_rays)
    torch.cuda.synchronize()
    assert tsub.SUBSET_GATHER.launches == before + 1
    want = tsub.subset_gather_plain(tp, ids, offsets, True, True, with_rays)
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None) == (name in ("origins", "dirs") and not with_rays), name
        assert g is None or torch.equal(g, w), name
    assert got.idx.shape[0] == int(offsets_np[-1]) > 0


def _synthetic_tape(cuda, n_src, max_count, seed):
    """A RayTape of random streams: counts in [0, max_count], a fifth of
    the rays empty."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_count + 1, n_src).astype(np.int32)
    counts[rng.rand(n_src) < 0.2] = 0
    offsets = np.zeros(n_src + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    S = int(offsets[-1])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    f = lambda *shape: t(rng.rand(*shape).astype(np.float32))  # noqa: E731
    return ttape.RayTape(
        idx=t(rng.randint(0, 1 << 30, S).astype(np.int32)), dt=f(S),
        cell=t(rng.randint(0, 1 << 30, S).astype(np.int32)), offsets=t(offsets), counts=t(counts),
        origins=f(n_src, 3), dirs=f(n_src, 3), vdirs=f(n_src, 3), dscale=f(n_src), n_rays=n_src,
        S=int(counts.max()), compact=True, n_features=1 << 30, n_cells=1 << 30, geom=None, tval=f(S),
        indirect=False)


@pytest.mark.parametrize("want_t", [False, True])
@pytest.mark.parametrize("want_cell", [False, True])
@pytest.mark.parametrize("with_rays", [False, True])
def test_subset_gather_streams_and_shapes(cuda, want_t, want_cell, with_rays):
    """K14a's instance for every combination of the t, cell and ray streams,
    bit for bit the plain version: B a multiple of 32 and not (a last warp
    of 1 and of 31 rays), zero-count rays, runs longer than 32 samples (up
    to 90), duplicate ids, a batch of only empty rays."""
    tp = _synthetic_tape(cuda, 700, 90, seed=77)
    rng = np.random.RandomState(78)
    empty = np.flatnonzero(tp.counts.cpu().numpy() == 0)
    for B in (1, 31, 32, 33, 1000, 2047):
        ids_np = rng.randint(0, tp.n_rays, B)
        ids_np[B // 2:B // 2 + 3] = ids_np[:3]
        ids_np[-min(B, 5):] = empty[:min(B, 5)]
        for ids_case in (ids_np, empty[:B]):
            src = tsub.TapeRowSource(tp, keep_cells=True)
            offsets_np = tsub._subset_plan(src, ids_case)[1]
            ids = torch.from_numpy(ids_case.astype(np.int32)).to(cuda)
            offsets = torch.from_numpy(offsets_np).to(cuda)
            before = tsub.SUBSET_GATHER.launches
            got = tsub.subset_gather_cuda(tp, ids, offsets, want_t, want_cell, with_rays)
            torch.cuda.synchronize()
            assert tsub.SUBSET_GATHER.launches == before + 1
            want = tsub.subset_gather_plain(tp, ids, offsets, want_t, want_cell, with_rays)
            for name, g, w in zip(got._fields, got, want):
                assert (g is None) == (w is None), name
                assert g is None or torch.equal(g, w), (name, B)


def test_subset_replay_equals_full_replay_kernel(cuda):
    """K13c over a subset (duplicate ids) equals the full replay's rows bit
    for bit; its gradient equals the masked full gradient."""
    _, spec, feats, opt, tp = _subset_case(cuda)
    ids = np.random.RandomState(73).randint(0, tp.n_rays, 1500)
    full = ttape.replay_render(tp, feats, opt, spec)
    out = tsub.replay_render_rows(tp, ids, feats, opt, spec)
    assert torch.equal(out, full[torch.from_numpy(ids).to(cuda)])
    f = feats.clone().requires_grad_()
    g_sub, = torch.autograd.grad(tsub.replay_render_rows(tp, ids, f, opt, spec).sum(), f)
    mult = torch.bincount(torch.from_numpy(ids), minlength=tp.n_rays).float().to(cuda)
    g_full, = torch.autograd.grad((ttape.replay_render(tp, f, opt, spec) * mult[:, None]).sum(), f)
    tol = 1e-5 * max(1.0, float(g_full.abs().max()))
    assert float((g_sub - g_full).abs().max()) <= tol


@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("W", [3, 4])
def test_l2_cotangent_kernel_matches_plain(cuda, with_ids, W):
    rng = np.random.RandomState(74)
    B = 70000
    out = torch.from_numpy(rng.rand(B, 4).astype(np.float32)).to(cuda)
    targets = torch.from_numpy(rng.rand(B + 99, 5).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.randint(0, B + 99, B).astype(np.int32)).to(cuda) if with_ids else None
    inv_bw = 1.0 / (B * W)
    loss = torch.empty(3, device=cuda)
    before = tsub.L2_COTANGENT.launches
    g, l_ = tsub.l2_cotangent_cuda(out, targets, ids, W, inv_bw, loss[1:2])
    torch.cuda.synchronize()
    assert tsub.L2_COTANGENT.launches == before + 1
    gw, lw = tsub.l2_cotangent_plain(out, targets, ids, W, inv_bw)
    assert torch.equal(g, gw) and bool(gw[:, :W].any()) and not g[:, W:].any()
    assert abs(float(loss[1]) - float(lw)) <= 1e-6 * float(lw)
    assert float(l_) == float(loss[1])


@pytest.mark.parametrize("case", ["numel_mod4_0", "numel_mod4_1", "numel_mod4_2", "numel_mod4_3",
                                  "row_slice", "flat_slice", "both_slices"])
def test_sgd_kernel_matches_plain(cuda, case):
    """K14c equals `sgd_plain` bit for bit on D = 7 pools of each numel % 4
    (the scalar tail), on contiguous slices that start off 16 bytes (the
    scalar head; the gradient aligned or not, as the pool), and leaves the
    elements before a slice as they were."""
    rng = np.random.RandomState(75)
    rows = {"numel_mod4_0": 100000, "numel_mod4_1": 100003, "numel_mod4_2": 100002,
            "numel_mod4_3": 100001}.get(case, 100004)
    base = torch.from_numpy(rng.randn(rows, 7).astype(np.float32)).to(cuda)
    gbase = torch.from_numpy(rng.randn(rows, 7).astype(np.float32) * 0.3).to(cuda)
    if case.startswith("numel"):
        f, g = base, gbase
        assert f.numel() % 4 == int(case[-1])
    elif case == "row_slice":
        f, g = base[1:], gbase[1:].clone()
    elif case == "flat_slice":
        f, g = base.view(-1)[1:], gbase.view(-1)[1:].clone()
    else:
        f, g = base[1:], gbase[1:]
    assert f.is_contiguous() and g.is_contiguous()
    assert case.startswith("numel") or f.data_ptr() % 16 != 0
    f0 = f.clone()
    want = tsub.sgd_plain(f.clone(), g, 0.05)
    first = base.view(-1)[:base.numel() - f.numel()].clone()  # before the slice
    before = tsub.SGD_UPDATE.launches
    got = tsub.sgd_cuda(f, g, 0.05)
    torch.cuda.synchronize()
    assert tsub.SGD_UPDATE.launches == before + 1 and got.data_ptr() == f.data_ptr()
    assert torch.equal(got, want)
    assert not torch.equal(got, f0)
    assert torch.equal(base.view(-1)[:first.numel()], first)
    with pytest.raises(ValueError, match="float32 pool"):
        tsub.sgd_cuda(f.to(torch.bfloat16), g, 0.05)


def _eager_chain(f_start, n_steps, err_fn, n_terms, lr=None):
    """(features, losses) after n_steps of f - lr * g, g the autograd
    gradient of sum(err_fn(f, n)^2) / n_terms; lr None: chosen at the first
    step so that its largest entry is 1e-2 * max|f_start|."""
    f, losses = f_start, []
    for n in range(n_steps):
        ff = f.clone().requires_grad_()
        err = err_fn(ff, n)
        g, = torch.autograd.grad((err * err).sum() / n_terms, ff)
        losses.append(float((err.detach().double() ** 2).sum() / n_terms))
        lr = 1e-2 * float(f_start.abs().max()) / float(g.abs().max()) if lr is None else lr
        f = f - lr * g
    return f, losses, lr


def _assert_update(f_k, f_e, f_start):
    """The chain's update within 1e-3 of the eager chain's, relative to its
    largest entry (a chain that moves nothing fails)."""
    d_e = f_e - f_start
    scale = float(d_e.abs().max())
    assert scale > 0 and float(((f_k - f_start) - d_e).abs().max()) <= 1e-3 * scale


def test_train_minibatches_uses_the_kernels(cuda):
    """Per step one K14a, K13c, K14b, K13d and K14c; the features within
    1e-5 * max(1, max|f|) of an eager chain of the public calls, the losses
    within 1e-6 relative; the caller's pool unchanged."""
    _, spec, feats, opt, tp = _subset_case(cuda)
    tgt = ttape.replay_render(tp, feats, opt, spec)[:, :3]
    src = tsub.TapeRowSource(tp)
    ids_b = np.random.RandomState(76).randint(0, tp.n_rays, (4, 1024))
    f0 = feats * 0.9
    counters = (tsub.SUBSET_GATHER, ttape.TAPE_REPLAY_FWD, tsub.L2_COTANGENT, ttape.TAPE_REPLAY_BWD,
                tsub.SGD_UPDATE)
    before, w4 = [k.launches for k in counters], ttape.BWD_WIDTH_LAUNCHES[4]
    f_out, losses, _ = tsub.train_minibatches(src, tsub.prep_minibatches(src, ids_b), tgt, f0, opt,
                                              lr=0.05, spec=spec)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [4] * 5
    assert ttape.BWD_WIDTH_LAUNCHES[4] - w4 == 4  # SH9: the 16-byte vector instance
    assert torch.equal(f0, feats * 0.9)

    def err_fn(ff, n):
        ids = ids_b[n]
        return tsub.replay_render_rows(src, ids, ff, opt, spec)[:, :3] - tgt[torch.from_numpy(ids).to(cuda)]

    f, want, _ = _eager_chain(f0, 4, err_fn, 1024 * 3, 0.05)
    for n, w in enumerate(want):
        assert abs(w - float(losses[n])) <= 1e-6 * w
    assert float((f_out - f).abs().max()) <= 1e-5 * max(1.0, float(f.abs().max()))
    f, _, lr = _eager_chain(f0, 4, err_fn, 1024 * 3)
    _assert_update(tsub.train_minibatches(src, ids_b, tgt, f0, opt, lr=lr, spec=spec)[0], f, f0)


def test_train_steps_uses_the_kernels(cuda):
    _, spec, feats, opt, tp = _subset_case(cuda)
    tgt = ttape.replay_render(tp, feats, opt, spec)[:, :3]
    counters = (tsub.SUBSET_GATHER, ttape.TAPE_REPLAY_FWD, tsub.L2_COTANGENT, ttape.TAPE_REPLAY_BWD,
                tsub.SGD_UPDATE)
    before, w4 = [k.launches for k in counters], ttape.BWD_WIDTH_LAUNCHES[4]
    f_out, losses, _ = tsub.train_steps(tp, tgt, feats * 0.9, opt, 3, lr=0.05, spec=spec)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [0, 3, 3, 3, 3]
    assert ttape.BWD_WIDTH_LAUNCHES[4] - w4 == 3  # SH9: the 16-byte vector instance

    def err_fn(ff, n):
        return ttape.replay_render(tp, ff, opt, spec)[:, :3] - tgt

    f0 = feats * 0.9
    f, want, _ = _eager_chain(f0, 3, err_fn, tp.n_rays * 3, 0.05)
    for n, w in enumerate(want):
        assert abs(w - float(losses[n])) <= 1e-6 * w
    assert float((f_out - f).abs().max()) <= 1e-5 * max(1.0, float(f.abs().max()))
    assert losses[-1] < losses[0]
    f, _, lr = _eager_chain(f0, 3, err_fn, tp.n_rays * 3)
    _assert_update(tsub.train_steps(tp, tgt, f0, opt, 3, lr=lr, spec=spec)[0], f, f0)


@pytest.mark.parametrize("ndc", [False, True])
def test_grid_weight_kernel_matches_plain(cuda, ndc):
    """K12 equals its plain version bit for bit on both outputs."""
    rng = np.random.RandomState(77)
    reso = 40
    data = torch.from_numpy((rng.rand(reso, reso, reso) * 30).astype(np.float32)).to(cuda)
    data[torch.from_numpy(rng.rand(reso, reso, reso) < 0.7).to(cuda)] = 0.0
    if ndc:
        opt = stt.RenderOptions(step_size=1e-2, sigma_thresh=0.5, max_steps=200, ndc_width=64,
                                ndc_height=48, ndc_focal=60.0)
        cam = stt.CameraSpec(c2w=torch.eye(4, device=cuda), fx=60.0, fy=60.0, width=64, height=48)
        offset = scaling = [0.5, 0.5, 0.5]
    else:
        opt = stt.RenderOptions(step_size=1e-3, sigma_thresh=1e-4, max_steps=256)
        cam = stt.CameraSpec(c2w=torch.as_tensor(orbit_camera(), device=cuda), fx=70.0, fy=70.0,
                             width=64, height=48)
        offset, scaling = [0.0] * 3, [1.0] * 3
    before = tgrid.GRID_WEIGHT.launches, tgrid.GRID_OCCUPANCY.launches
    gw, gh = stt.grid_weight_render(data, cam, opt, offset, scaling)
    torch.cuda.synchronize()
    assert (tgrid.GRID_WEIGHT.launches, tgrid.GRID_OCCUPANCY.launches) == (before[0] + 1, before[1] + 1)
    o, d = trender.cam2world_rays(cam.c2w, cam.width, cam.height, cam.fx, cam.fy)
    if ndc:
        d, o = trender.world2ndc(opt, d, o)
    vec = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda)  # noqa: E731
    pw, ph = tgrid.grid_weight_plain(data, o.contiguous(), d.contiguous(), vec(offset), vec(scaling), opt)
    assert torch.equal(gw, pw) and torch.equal(gh, ph)
    assert float(gh.sum()) > 0 and 0 < float(gw.max()) <= 1.0


@pytest.mark.parametrize("reso,thresh", [(40, 0.5), (37, 0.5), (16, -1.0), (24, float("nan"))])
def test_grid_occupancy_kernel_matches_plain(cuda, reso, thresh):
    """K12's occupancy pass equals its plain version bit for bit: whole
    bricks (16-byte loads) and partial ones (the scalar walk), NaN and -inf
    sigmas, a negative and a NaN threshold; and the march over it equals
    the plain march."""
    rng = np.random.RandomState(reso)
    data = (rng.rand(reso, reso, reso) * 30).astype(np.float32)
    data[rng.rand(reso, reso, reso) < 0.9] = 0.0
    u = rng.rand(reso, reso, reso)
    data[u < 0.01] = np.nan
    data[(u >= 0.01) & (u < 0.02)] = -np.inf
    data = torch.from_numpy(data).to(cuda)
    mask = tgrid.grid_occupancy_cuda(data, thresh)
    assert torch.equal(mask, tgrid.grid_occupancy_plain(data, thresh))
    opt = stt.RenderOptions(step_size=1e-3, sigma_thresh=thresh, max_steps=300)
    o, d = trender.cam2world_rays(torch.as_tensor(orbit_camera(), device=cuda), 40, 32, 50.0, 50.0)
    args = (data, o.contiguous(), d.contiguous(), torch.zeros(3, device=cuda), torch.ones(3, device=cuda), opt)
    gw, gh = tgrid.grid_weight_cuda(*args)
    pw, ph = tgrid.grid_weight_plain(*args)
    assert torch.equal(gw, pw) and torch.equal(gh, ph)


def test_k14_k12_raise_without_their_kernels(cuda, monkeypatch):
    """On CUDA tensors each wrapper launches its kernel or raises: with a
    kernel's entry point missing from the library the call fails, and
    nothing falls back to the plain version."""
    _, spec, feats, opt, tp = _subset_case(cuda)
    tgt = torch.zeros(tp.n_rays, 3, device=cuda)
    calls = {
        tsub.SUBSET_GATHER: lambda: tsub.subset_tape(tp, np.arange(8)),
        tsub.L2_COTANGENT: lambda: tsub.train_steps(tp, tgt, feats, opt, 1, spec=spec),
        tsub.SGD_UPDATE: lambda: tsub.train_steps(tp, tgt, feats, opt, 1, spec=spec),
    }
    for kernel in (tgrid.GRID_OCCUPANCY, tgrid.GRID_WEIGHT):
        calls[kernel] = lambda: stt.grid_weight_render(
            torch.ones(8, 8, 8, device=cuda), stt.CameraSpec(c2w=torch.eye(4, device=cuda), width=4,
                                                             height=4, fx=4.0, fy=4.0),
            stt.RenderOptions(), [0.0] * 3, [1.0] * 3)
    for kernel, call in calls.items():
        with monkeypatch.context() as m:
            m.setattr(kernel, "symbol", kernel.symbol + "_missing")
            m.setattr(kernel, "_fn", None)
            with pytest.raises(AttributeError, match="_missing"):
                call()


# ---------------------------------------------------------------------------
# The ray schedules' cost walk (K15): counts equal to the plain version's on
# both structures; the planned renders equal to the tile order bit for bit.


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("case", ["exact", "fast", "fast_sigmas", "interp", "cap"])
def test_march_cost_kernel_matches_plain(cuda, backend, case):
    tree, spec, feats, _, o, d = _tape_scene(cuda, backend, seed=65)
    opt = stt.VolumeRenderer(tree, backend=backend)._get_options(case.startswith("fast"))
    if case == "interp":
        opt = dataclasses.replace(opt, interp=1)
    if case == "cap":
        opt = dataclasses.replace(opt, max_steps=7)
    M = feats.shape[0]
    sigmas = feats[:, -1].contiguous() * 50.0 if case == "fast_sigmas" else None
    kernel = tsched.MARCH_COST_BAKED if backend == "baked" else tsched.MARCH_COST
    before = kernel.launches
    got = tsched.ray_costs(spec, o, d, opt, M, sigmas)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    args = (spec, o, d, tsched.effective_skip_base(spec, opt), M, opt.step_size, opt.max_steps,
            opt.interp, opt.box_advance, opt.sigma_thresh, opt.stop_thresh, sigmas)
    want, margin = tsched.march_cost_plain(*args, return_margin=True)
    keep = margin > 1e-6
    assert torch.equal(got[keep], want[keep])
    assert int((~keep).sum()) <= 8
    assert int(got.max()) > 0 and int(got.max()) <= opt.max_steps
    if case == "fast_sigmas":
        assert bool((got < tsched.ray_costs(spec, o, d, opt, M)).any())


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_planned_renders_equal_tile_order(cuda, backend):
    tree, feats, _ = _shell(cuda, seed=66)
    r = stt.VolumeRenderer(tree, backend=backend)
    cam = torch.as_tensor(orbit_camera(), device=cuda)
    kernel = tsched.MARCH_COST_BAKED if backend == "baked" else tsched.MARCH_COST
    for fast in (False, True):
        before = kernel.launches
        img = r.render_persp(feats, cam, 64, 48, 70.0, fast=fast, schedule="cost")
        assert kernel.launches == before + 1
        assert torch.equal(img, r.render_persp(feats, cam, 64, 48, 70.0, fast=fast))
    perm, inv = r.plan_persp(cam, 64, 48, 70.0)
    assert perm.is_cuda and perm.dtype == torch.int32
    assert torch.equal(perm[inv.long()], torch.arange(64 * 48, dtype=torch.int32, device=cuda))


def test_march_cost_raises_without_its_kernel(cuda, monkeypatch):
    """On CUDA rays `march_cost` launches K15 or raises."""
    tree, spec, feats, _, o, d = _tape_scene(cuda, "baked", seed=67)
    opt = stt.VolumeRenderer(tree)._get_options(False)
    monkeypatch.setattr(tsched.MARCH_COST_BAKED, "symbol", "svox_march_cost_baked_missing")
    monkeypatch.setattr(tsched.MARCH_COST_BAKED, "_fn", None)
    with pytest.raises(AttributeError, match="_missing"):
        tsched.ray_costs(spec, o, d, opt, feats.shape[0])


# ---------------------------------------------------------------------------
# K9b, the first-hit march, redesigned for Hopper (the tree walk's next
# descent started on the previous sample's path, the lookup ahead on the
# bake, the interp corners from the own lookup), and K8a, construct_tree
# (two points a scatter thread, the merge in vectors, the winner scratch
# kept all -1 between calls).


def _fh_trees(cuda):
    """{N: (tree, pool)} for K9b's instances: the depth-5 SH9 shell (N = 2;
    its pool cut to 70% of the leaves, so some leaves are empty) and trees
    of N = 3 and N = 4 from occupancy grids (their pools seeded, a third of
    the densities 0)."""
    tree, feats, _ = _shell(cuda, seed=70)
    out = {2: (tree, feats[: int(feats.shape[0] * 0.7)].contiguous())}
    for N, depth in ((3, 3), (4, 3)):
        t, M, _ = _occupancy_tree(cuda, N=N, depth=depth, seed=70 + N)
        rng = np.random.RandomState(70 + N)
        f = (rng.randn(M, 13) * 0.3).astype(np.float32)
        f[:, -1] = np.abs(rng.randn(M)).astype(np.float32) * 30.0 * (rng.rand(M) > 0.33)
        out[N] = (t, torch.from_numpy(f).to(cuda))
    return out


def _fh_rays(cuda, seed):
    """Camera and random rays (some miss the cube), the first 64 of the
    random ones starting inside it."""
    o, d = _rays(cuda, 1024, seed=seed)
    rng = np.random.RandomState(seed)
    o[48 * 48:48 * 48 + 64] = torch.from_numpy(rng.rand(64, 3).astype(np.float32)).to(cuda)
    return o.contiguous(), d


def _assert_first_hit(got, want):
    """found, t_hit and row bit for bit, frac within ATOL."""
    for name, g, w in zip(("found", "t_hit", "row"), got[:3], want[:3]):
        assert torch.equal(g, w), name
    torch.testing.assert_close(got[3], want[3], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("backend", ["tree", "baked"])
@pytest.mark.parametrize("interp", [False, True])
def test_first_hit_instances_match_plain(cuda, kind, backend, interp):
    """Every K9b instance against its plain version on N = 2, 3 and 4 trees:
    sigma_thresh 0, 5 and < 0 (the re-lookup at t_hit), a max_steps cut,
    fast mode on the bake (box advance, skip boxes), rays that miss the cube
    and rays that start inside it; one launch a call; an empty pool or ray
    batch returns zeros without a launch."""
    o, d = _fh_rays(cuda, seed=71)
    for N, (tree, feats) in _fh_trees(cuda).items():
        pool = feats if kind == "f32" else _pool_of(kind, feats)[0]
        spec = tree._baked_spec() if backend == "baked" else tree._spec()
        r = stt.VolumeRenderer(tree, backend=backend, interp="trilinear" if interp else "nearest")
        kernel = (getattr(taux, "FIRST_HIT" + ("_BAKED" if backend == "baked" else "")
                          + ("_INTERP" if interp else "")) if kind == "f32"
                  else _pool_kernels(["FIRST_HIT"], backend, interp, kind)[0])
        cases = [(False, 0.0, 1024), (False, 5.0, 1024), (False, -1.0, 1024), (False, 0.0, 9)]
        if backend == "baked" and not interp:
            cases += [(True, 0.0, 1024), (True, 5.0, 1024)]
        for fast, thresh, max_steps in cases:
            opt = dataclasses.replace(r._get_options(fast), sigma_thresh=thresh, max_steps=max_steps)
            before = kernel.launches
            got = taux.first_hit(spec, pool, o, d, opt)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            _assert_first_hit(got, taux.first_hit_plain(spec, pool, o, d, opt))
            assert not bool(got[0].all()) and (max_steps < 1024 or bool(got[0].any())), (N, fast, thresh)
        before = kernel.launches
        empty = pool[:0] if kind != "i8" else stt.quantize_features(feats[:0])
        for args in ((empty, o, d), (pool, o[:0], d[:0])):
            got = taux.first_hit(spec, *args, r._get_options())
            assert all(not bool(g.any()) for g in got) and got[0].shape[0] == args[1].shape[0]
        assert kernel.launches == before


def test_first_hit_path_reuse_on_a_deep_tree(cuda):
    """The tree walk's path-started descents on a depth-7 shell (the march's
    samples cross many leaves whose paths part at the last level or two),
    nearest and interp: bit for bit the plain version."""
    tree, feats, _ = _shell(cuda, depth=7, seed=72)
    o, d = _rays(cuda, 4096, seed=72, size=96)
    spec = tree._spec()
    for interp in (False, True):
        opt = stt.VolumeRenderer(tree, backend="tree", interp="trilinear" if interp else "nearest")._get_options()
        _assert_first_hit(taux.first_hit(spec, feats, o, d, opt), taux.first_hit_plain(spec, feats, o, d, opt))


def test_construct_tree_orders_and_kept_scratch(cuda):
    """K8a equal to its plain version (torch.equal) with points in leaf
    order, permuted, many points to one leaf (the largest id wins), points
    outside the cube (clamped) and Q = 0; on N = 3; two calls in a row and
    two trees of different sizes on one device, each leaving its stream's
    scratch all -1; a call on another stream takes a scratch of its own."""
    tree, _, centers = _shell(cuda, seed=73)
    t3, M3, c3 = _occupancy_tree(cuda, N=3, depth=4, seed=73)
    g = torch.Generator().manual_seed(73)
    perm = torch.randperm(centers.shape[0], generator=g).to(cuda)
    outside = (torch.rand(500, 3, generator=g) * 3 - 1).to(cuda)
    many = centers[:7].repeat(300, 1)
    cases = [(tree, centers), (tree, centers[perm]), (tree, torch.cat([centers[perm], many])),
             (tree, outside), (tree, centers[:0]), (t3, c3), (t3, c3.flip(0)), (tree, centers[perm])]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for t, pts in cases:
        spec = t._spec()
        before = tquery.CONSTRUCT_TREE.launches
        got = tquery.construct_tree(spec, pts.contiguous())
        torch.cuda.synchronize()
        assert tquery.CONSTRUCT_TREE.launches == before + 1
        assert torch.equal(got, tquery.construct_tree_plain(spec, pts.contiguous()))
        scratch = tquery._WINNERS[(cuda.index, stream)]
        assert scratch.numel() >= spec.data_flat.numel() and bool((scratch == -1).all())
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        got = tquery.construct_tree(tree._spec(), centers[perm])
    torch.cuda.synchronize()
    assert torch.equal(got, tquery.construct_tree_plain(tree._spec(), centers[perm]))
    assert (cuda.index, side.cuda_stream) in tquery._WINNERS
    assert bool((tquery._WINNERS[(cuda.index, side.cuda_stream)] == -1).all())


def test_construct_tree_aabb_matches_plain(cuda):
    """The fused re-point (construct_tree_aabb): its table equal to
    construct_tree_plain's and its box to points_leaf_aabb_plain's with the
    union (torch.equal), on N = 2 and N = 3, with and without a union (an
    empty one, lo > hi, too), for points outside the cube, many points to
    one leaf, Q = 0 and Q not a multiple of 512; one launch a call, the
    stream's box scratch left at (+inf, -inf) and its winner all -1 after
    each of the repeated calls; a call on another stream takes a scratch
    of its own."""
    tree, _, centers = _shell(cuda, seed=75)
    t3, _, c3 = _occupancy_tree(cuda, N=3, depth=4, seed=75)
    c3w = t3.tree2world(c3).contiguous()
    g = torch.Generator().manual_seed(75)
    perm = torch.randperm(centers.shape[0], generator=g).to(cuda)
    outside = (torch.rand(777, 3, generator=g) * 3 - 1).to(cuda)
    many = centers[:5].repeat(301, 1)
    unions = (None, (torch.full((3,), 0.3, device=cuda), torch.full((3,), 0.6, device=cuda)),
              (torch.ones(3, device=cuda), torch.zeros(3, device=cuda)))
    cases = [(tree, centers[perm]), (tree, torch.cat([many, outside])), (tree, centers[:0]),
             (tree, centers[:1000]), (t3, c3w), (t3, c3w[:513].flip(0)), (t3, outside)]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    inf = float("inf")
    kept = torch.tensor([inf] * 3 + [-inf] * 3, device=cuda)
    for t, pts in cases:
        spec = t._spec()
        pts = pts.contiguous()
        for union in unions:
            before = (tquery.CONSTRUCT_TREE_AABB.launches, tquery.CONSTRUCT_TREE.launches,
                      tquery.POINTS_AABB.launches)
            table, lo, hi = tquery.construct_tree_aabb(spec, pts, union)
            torch.cuda.synchronize()
            after = (tquery.CONSTRUCT_TREE_AABB.launches, tquery.CONSTRUCT_TREE.launches,
                     tquery.POINTS_AABB.launches)
            assert after == (before[0] + 1, before[1], before[2])
            want, wlo, whi = tquery.construct_tree_aabb_plain(spec, pts, union)
            assert torch.equal(table, want)
            assert torch.equal(lo, wlo) and torch.equal(hi, whi), (lo, hi, wlo, whi)
            assert torch.equal(torch.cat([lo, hi]), torch.cat(
                tquery.points_leaf_aabb_cuda(spec, pts, union=union)))
            assert torch.equal(tquery._BOXES[(cuda.index, stream)], kept)
            assert bool((tquery._WINNERS[(cuda.index, stream)] == -1).all())
    side = torch.cuda.Stream(cuda)
    spec = tree._spec()
    with torch.cuda.stream(side):
        got = tquery.construct_tree_aabb(spec, centers[perm], unions[1])
    torch.cuda.synchronize()
    want = tquery.construct_tree_aabb_plain(spec, centers[perm], unions[1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tquery._BOXES[(cuda.index, side.cuda_stream)], kept)


def test_construct_tree_aabb_entry_points(cuda):
    """N3Tree.construct_tree with a bake launches the fused kernel once and
    nothing else of K8a or K8b; without a bake the box-free construct_tree.
    The fused wrapper raises on CPU points."""
    tree, _, centers = _shell(cuda, seed=76)
    perm = torch.randperm(centers.shape[0], generator=torch.Generator().manual_seed(76)).to(cuda)
    counters = (tquery.CONSTRUCT_TREE_AABB, tquery.CONSTRUCT_TREE, tquery.POINTS_AABB)
    before = [k.launches for k in counters]
    tree.construct_tree(centers[perm])
    assert [k.launches - b for k, b in zip(counters, before)] == [0, 1, 0]
    baked = tree._baked_spec()
    want = tquery.construct_tree_aabb_plain(tree._spec(), centers, (baked.aabb_lo, baked.aabb_hi))
    before = [k.launches for k in counters]
    tree.construct_tree(centers)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 0, 0]
    assert torch.equal(tree._spec().data_flat, want[0])
    assert torch.equal(tree._baked_spec().aabb_lo, want[1]) and torch.equal(tree._baked_spec().aabb_hi, want[2])
    with pytest.raises(ValueError, match="points on cpu"):
        tquery.construct_tree_aabb_cuda(tree._spec(), centers.cpu())


def test_construct_tree_rejects_bad_tables(cuda):
    """The checks that reject bad inputs stay: CPU points, a table of
    another type, tables of different sizes."""
    tree, _, centers = _shell(cuda, seed=74)
    spec = tree._spec()
    with pytest.raises(ValueError, match="points on cpu"):
        tquery.construct_tree_cuda(spec, centers.cpu())
    with pytest.raises(ValueError, match="int32"):
        tquery.construct_tree_cuda(spec.with_(data_flat=spec.data_flat.long()), centers)
    with pytest.raises(ValueError, match="differ in size"):
        tquery.construct_tree_cuda(spec.with_(data_flat=spec.data_flat[:-8]), centers)
