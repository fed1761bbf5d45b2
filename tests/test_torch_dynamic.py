"""svox_t_tpu_torch's frame loops against the JAX package (CPU):
`render_dynamic_frames` (LBS warp -> construct_tree -> render per frame,
the index table carried from frame to frame), `render_frames` and
`render_persp_frames`, outputs, carried index tables and feature
gradients.

The cloud keeps every warped point at least 1e-5 from a cell boundary in
every frame, so that the last ulps of the two packages' warps cannot put a
point in another leaf; index tables then compare exactly. Tolerances:
ray-batch outputs atol 1e-5 (the JAX march forms L per round, the port
per sample); camera images 3e-5 (each package makes its own rays, and the
JAX package's jitted ray setup rounds 1/|d| through rsqrt; ROADMAP.md's
tolerance rule); gradients ``1e-5 * max(1, max|g_jax|)``. The JAX
outputs are computed once per module: every JAX frame loop compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import query as tquery

ATOL = 1e-5
IMG_ATOL = 3e-5
T_FRAMES = 3
DEPTH = 4  # the tree refines to cells of 1 / 2^DEPTH
W, H, FX = 32, 24, 26.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _poses(T):
    """(T, 2, 4, 4): joint 0 still, joint 1 rotating about z and sliding
    along x (points leave their leaves, so stale pointers stay behind)."""
    out = []
    for i in range(T):
        a = 0.5 * np.sin(2 * np.pi * i / max(T, 1))
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0, 0.05 * i], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                       np.float32)
        out.append(np.stack([np.eye(4, dtype=np.float32), rot]))
    return np.stack(out)


def _safe_cloud(rng, Q, poses):
    """Q points whose warped position, in every frame, is at least 1e-5
    from every cell boundary (multiples of 1 / 2^DEPTH)."""
    cand = np.clip(0.5 + 0.15 * rng.randn(3 * Q, 3), 0.2, 0.8).astype(np.float32)
    sw = np.stack([1.0 - cand[:, 2], cand[:, 2]], axis=1).astype(np.float32)
    ok = np.ones(len(cand), bool)
    for pose in poses.astype(np.float64):
        A = sw[:, 0, None, None] * pose[0, :3] + sw[:, 1, None, None] * pose[1, :3]
        warped = np.einsum("qij,qj->qi", A[:, :, :3], cand) + A[:, :, 3]
        scaled = warped * 2 ** DEPTH
        ok &= (np.abs(scaled - np.round(scaled)) > 1e-5 * 2 ** DEPTH).all(axis=1)
    keep = np.flatnonzero(ok)[:Q]
    assert len(keep) == Q
    return cand[keep], sw[keep]


def _rays(rng, B):
    phi = rng.rand(B) * 2 * np.pi
    costh = rng.rand(B) * 2 - 1
    sinth = np.sqrt(1 - costh ** 2)
    o = 0.5 + 2.0 * np.stack([sinth * np.cos(phi), sinth * np.sin(phi), costh], -1)
    d = (0.5 + (rng.rand(B, 3) - 0.5) * 0.8) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _cameras():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.5, 0.5, 2.2]
    path = np.stack([c2w] * T_FRAMES)
    path[1, :3, 3] = [0.42, 0.58, 2.2]
    path[2, :3, 3] = [0.55, 0.47, 2.3]
    return c2w, path


class Scene:
    """Seeded inputs shared by both packages, as NumPy arrays."""

    def __init__(self):
        rng = np.random.RandomState(3)
        self.Q = 500
        self.poses = _poses(T_FRAMES)
        self.src = np.stack([np.eye(4, dtype=np.float32)] * 2)
        self.pts, self.sw = _safe_cloud(rng, self.Q, self.poses)
        self.ji = np.tile(np.array([0, 1], np.int32), (self.Q, 1))
        self.rgba = np.concatenate([rng.rand(self.Q, 3), 6.0 + rng.rand(self.Q, 1)],
                                   axis=1).astype(np.float32)
        sh = (rng.randn(self.Q, 13) * 0.5).astype(np.float32)
        sh[:, -1] = 6.0 + rng.rand(self.Q)
        self.sh4 = sh
        self.stack = np.stack([self.rgba * (1.0 + 0.1 * k) for k in range(T_FRAMES)])
        self.origins, self.dirs = _rays(rng, 48)
        self.c2w, self.path = _cameras()
        self.G = rng.randn(T_FRAMES, 48, 4).astype(np.float32)
        ang = rng.rand(T_FRAMES, self.Q).astype(np.float32) * 0.6
        tms = np.zeros((T_FRAMES, self.Q, 4, 4), np.float32)
        tms[..., 0, 0], tms[..., 0, 1] = np.cos(ang), -np.sin(ang)
        tms[..., 1, 0], tms[..., 1, 1] = np.sin(ang), np.cos(ang)
        tms[..., 2, 2] = tms[..., 3, 3] = 1.0
        self.tms = tms
        self.sh_stack = np.stack([self.sh4 * (1.0 + 0.05 * k) for k in range(T_FRAMES)])

    def jax_tree(self, fmt="RGBA", pointed=False):
        """A JAX tree; ``pointed`` points it at the canonical cloud."""
        ddim = 4 if fmt == "RGBA" else 13
        tree = st.N3Tree(N=2, data_dim=ddim, depth_limit=DEPTH, data_format=fmt)
        tree.refine(repeats=DEPTH - 1)
        if pointed:
            tree.construct_tree(jnp.asarray(self.pts))
        return tree

    def port_tree(self, fmt="RGBA", pointed=False):
        return stt.tree_from_numpy(stt.tree_state(self.jax_tree(fmt, pointed)), device="cpu")

    def jax_rays(self):
        o, d = jnp.asarray(self.origins), jnp.asarray(self.dirs)
        return st.Rays(o, d, d)

    def port_rays(self):
        return stt.Rays(_t(self.origins), _t(self.dirs), _t(self.dirs))

    def lbs(self):
        return self.poses, self.src, self.pts, self.sw, self.ji


@pytest.fixture(scope="module")
def scene():
    return Scene()


@pytest.fixture(scope="module")
def jax_out(scene):
    """Every JAX result the tests compare with, computed once."""
    s = scene
    out = {}
    tree = s.jax_tree()
    r = st.VolumeRenderer(tree, backend="tree")
    out["shared"] = np.asarray(r.render_dynamic_frames(jnp.asarray(s.rgba), *s.lbs(),
                                                       rays=s.jax_rays()))
    out["shared_table"] = np.asarray(jax.device_get(tree._data)).copy()
    r = st.VolumeRenderer(s.jax_tree(), backend="tree")
    cols, deps = r.render_dynamic_frames(jnp.asarray(s.stack), *s.lbs(), rays=s.jax_rays(),
                                         update_tree=False, with_depth=True)
    out["per_frame"], out["depths"] = np.asarray(cols), np.asarray(deps)
    r = st.VolumeRenderer(s.jax_tree("SH4"), backend="tree")
    for rot in (True, False):
        out[f"sh4_rot{rot}"] = np.asarray(r.render_dynamic_frames(
            jnp.asarray(s.sh4), *s.lbs(), rays=s.jax_rays(), viewdir_rotation=rot,
            update_tree=False))
    r = st.VolumeRenderer(s.jax_tree(), backend="tree")
    for name, cam in (("fixed", s.c2w), ("path", s.path)):
        out[f"cam_{name}"] = np.asarray(r.render_dynamic_frames(
            jnp.asarray(s.rgba), *s.lbs(), c2w=cam, width=W, height=H, fx=FX,
            update_tree=False))
    r = st.VolumeRenderer(s.jax_tree("SH4"), backend="tree")
    for name, f in (("shared", s.sh4), ("per_frame", s.sh_stack)):
        out[f"grad_{name}"] = np.asarray(jax.grad(lambda f_: jnp.sum(r.render_dynamic_frames(
            f_, *s.lbs(), rays=s.jax_rays(), update_tree=False)[..., :4] * s.G))(jnp.asarray(f)))
    r = st.VolumeRenderer(s.jax_tree("SH4", pointed=True), backend="tree")
    for tm in (False, True):
        out[f"frames_tm{tm}"] = np.asarray(r.render_frames(
            jnp.asarray(s.sh_stack), s.jax_rays(), jnp.asarray(s.tms) if tm else None))
    out["persp_fixed"] = np.asarray(r.render_persp_frames(
        jnp.asarray(s.sh_stack), s.c2w, W, H, FX))
    out["persp_path_tm"] = np.asarray(r.render_persp_frames(
        jnp.asarray(s.sh_stack), s.path, W, H, FX, transformation_matrices_frames=jnp.asarray(s.tms)))
    return out


def test_dynamic_matches_jax_and_carries_the_table(scene, jax_out):
    s = scene
    tree = s.port_tree()
    table0 = tree._spec().data_flat.clone()
    out = stt.VolumeRenderer(tree, backend="tree").render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays())
    assert out.shape == (T_FRAMES, 48, 4)
    np.testing.assert_allclose(out.detach().numpy(), jax_out["shared"], atol=ATOL)
    assert (out[..., 3] > 0.5).any() and (out[..., 3] == 0).any()
    # update_tree leaves the tree pointed at the last frame, as the JAX one.
    np.testing.assert_array_equal(tree.data, jax_out["shared_table"])
    # The table is carried: a fresh re-pointing at the last frame's cloud
    # would not keep the stale pointers earlier frames left.
    t_last = stt.get_transformation_matrix(_t(s.src), _t(s.poses[-1]))
    warped, _ = stt.warp_vertices(t_last, _t(s.pts), _t(s.sw), _t(s.ji))
    fresh = tquery.construct_tree(tree._spec().with_(data_flat=table0), warped)
    carried = torch.from_numpy(tree.data.reshape(-1))
    assert (fresh != carried).any()
    assert (carried < s.Q).sum() > (fresh < s.Q).sum()


def test_dynamic_equals_the_eager_loop(scene):
    """The fused loop is the eager loop of the port's public calls,
    warp_vertices -> construct_tree -> forward with the blended mats."""
    s = scene
    tree = s.port_tree("SH4")
    fused = stt.VolumeRenderer(tree, backend="tree").render_dynamic_frames(_t(s.sh4), *s.lbs(), rays=s.port_rays())
    eager_tree = s.port_tree("SH4")
    r = stt.VolumeRenderer(eager_tree, backend="tree")
    for k in range(T_FRAMES):
        tk = stt.get_transformation_matrix(_t(s.src), _t(s.poses[k]))
        warped, mats = stt.warp_vertices(tk, _t(s.pts), _t(s.sw), _t(s.ji))
        eager_tree.construct_tree(warped)
        assert torch.equal(fused[k], r(_t(s.sh4), s.port_rays(), transformation_matrices=mats))
    np.testing.assert_array_equal(tree.data, eager_tree.data)


def test_dynamic_per_frame_features_with_depth_and_no_update(scene, jax_out):
    s = scene
    tree = s.port_tree()
    before = tree.data.copy()
    cols, deps = stt.VolumeRenderer(tree, backend="tree").render_dynamic_frames(
        _t(s.stack), *s.lbs(), rays=s.port_rays(), update_tree=False, with_depth=True)
    np.testing.assert_array_equal(tree.data, before)
    assert deps.shape == (T_FRAMES, 48, 1)
    np.testing.assert_allclose(cols.numpy(), jax_out["per_frame"], atol=ATOL)
    np.testing.assert_allclose(deps.numpy(), jax_out["depths"], atol=ATOL)
    assert (deps > 0).any()


@pytest.mark.parametrize("rot", [True, False])
def test_dynamic_viewdir_rotation(scene, jax_out, rot):
    """SH4 (degree-1) colours turn with the blended matrices; without the rotation
    they do not."""
    s = scene
    out = stt.VolumeRenderer(s.port_tree("SH4"), backend="tree").render_dynamic_frames(
        _t(s.sh4), *s.lbs(), rays=s.port_rays(), viewdir_rotation=rot, update_tree=False)
    np.testing.assert_allclose(out.numpy(), jax_out[f"sh4_rot{rot}"], atol=ATOL)
    assert np.abs(jax_out["sh4_rotTrue"] - jax_out["sh4_rotFalse"]).max() > 1e-3


@pytest.mark.parametrize("cam", ["fixed", "path"])
def test_dynamic_cameras(scene, jax_out, cam):
    s = scene
    c2w = s.c2w if cam == "fixed" else s.path
    out = stt.VolumeRenderer(s.port_tree(), backend="tree").render_dynamic_frames(
        _t(s.rgba), *s.lbs(), c2w=c2w, width=W, height=H, fx=FX, update_tree=False)
    assert out.shape == (T_FRAMES, H, W, 4)
    np.testing.assert_allclose(out.numpy(), jax_out[f"cam_{cam}"], atol=IMG_ATOL)
    assert (out[..., 3] > 0.5).any() and (out[..., 3] == 0).any()


@pytest.mark.parametrize("schedule", ["cost", "union"])
def test_dynamic_schedules_render_the_same_images(scene, schedule):
    s = scene
    r = stt.VolumeRenderer(s.port_tree(), backend="tree")
    kw = dict(c2w=s.c2w, width=W, height=H, fx=FX, update_tree=False)
    base = r.render_dynamic_frames(_t(s.rgba), *s.lbs(), **kw)
    other = r.render_dynamic_frames(_t(s.rgba), *s.lbs(), schedule=schedule, **kw)
    assert torch.equal(base, other)


@pytest.mark.parametrize("schedule", ["cost", "union", "bogus"])
def test_dynamic_raw_rays_take_only_tile(scene, schedule):
    s = scene
    r = stt.VolumeRenderer(s.port_tree(), backend="tree")
    with pytest.raises(ValueError, match="schedule"):
        r.render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(), schedule=schedule)


def test_dynamic_argument_errors(scene):
    s = scene
    tree = s.port_tree()
    r = stt.VolumeRenderer(tree, backend="tree")
    with pytest.raises(ValueError, match="exactly one"):
        r.render_dynamic_frames(_t(s.rgba), *s.lbs())
    with pytest.raises(ValueError, match="exactly one"):
        r.render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(), c2w=s.c2w)
    with pytest.raises(ValueError, match="frames"):
        r.render_dynamic_frames(_t(s.stack[:2]), *s.lbs(), rays=s.port_rays())
    with tree.accumulate_weights():
        with pytest.raises(RuntimeError, match="accumulate"):
            r.render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays())
        with pytest.raises(RuntimeError, match="accumulate"):
            r.render_frames(_t(s.stack), s.port_rays())


@pytest.mark.parametrize("which", ["shared", "per_frame"])
def test_dynamic_feature_grads_match_jax(scene, jax_out, which):
    s = scene
    f = _t(s.sh4 if which == "shared" else s.sh_stack).requires_grad_()
    out = stt.VolumeRenderer(s.port_tree("SH4"), backend="tree").render_dynamic_frames(
        f, *s.lbs(), rays=s.port_rays(), update_tree=False)
    (out[..., :4] * _t(s.G)).sum().backward()
    want = jax_out[f"grad_{which}"]
    assert f.grad.shape == want.shape
    np.testing.assert_allclose(f.grad.numpy(), want, atol=_gtol(want))
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("tm", [False, True])
def test_render_frames_matches_jax(scene, jax_out, tm):
    s = scene
    r = stt.VolumeRenderer(s.port_tree("SH4", pointed=True), backend="tree")
    out = r.render_frames(_t(s.sh_stack), s.port_rays(), _t(s.tms) if tm else None)
    np.testing.assert_allclose(out.numpy(), jax_out[f"frames_tm{tm}"], atol=ATOL)
    assert (out[..., 3] > 0.5).any()
    for k in range(T_FRAMES):
        one = r(_t(s.sh_stack[k]), s.port_rays(), transformation_matrices=_t(s.tms[k]) if tm else None)
        assert torch.equal(out[k], one)


def test_render_frames_grads_equal_per_frame(scene):
    s = scene
    r = stt.VolumeRenderer(s.port_tree("SH4", pointed=True), backend="tree")
    stack = _t(s.sh_stack).requires_grad_()
    (r.render_frames(stack, s.port_rays()) ** 2).sum().backward()
    for k in range(T_FRAMES):
        fk = _t(s.sh_stack[k]).requires_grad_()
        (r(fk, s.port_rays()) ** 2).sum().backward()
        np.testing.assert_allclose(stack.grad[k].numpy(), fk.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("cam", ["fixed", "path_tm"])
def test_render_persp_frames_matches_jax(scene, jax_out, cam):
    s = scene
    r = stt.VolumeRenderer(s.port_tree("SH4", pointed=True), backend="tree")
    if cam == "fixed":
        out = r.render_persp_frames(_t(s.sh_stack), s.c2w, W, H, FX)
        want = jax_out["persp_fixed"]
        for k in range(T_FRAMES):
            assert torch.equal(out[k], r.render_persp(_t(s.sh_stack[k]), s.c2w, W, H, FX))
    else:
        out = r.render_persp_frames(_t(s.sh_stack), s.path, W, H, FX,
                                    transformation_matrices_frames=_t(s.tms))
        want = jax_out["persp_path_tm"]
    assert out.shape == (T_FRAMES, H, W, 4)
    np.testing.assert_allclose(out.numpy(), want, atol=IMG_ATOL)
    assert (out[..., 3] > 0.5).any()
