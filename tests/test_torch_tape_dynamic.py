"""svox_t_tpu_torch's data-indirect (dynamic) tapes against the JAX package
(CPU): the union pre-pass, `record_dynamic_rays` / `record_dynamic_persp`
and `render_dynamic_tape_frames` (per frame: LBS warp, `construct_tree`
re-point, `pack_index_table`, the replay through the frame's table, and
the depth replay with ``with_depth``), on both backends, on rays and on a
camera, exact and fast, compacted and not, with a shared pool, a per-frame
stack and rotations; `update_tree`, gradients and the guards.

The cloud keeps every warped point at least 1e-5 from a cell boundary in
every frame (as tests/test_torch_dynamic.py does), so that the last ulps
of the two packages' warps cannot put a point in another leaf: index
tables then compare exactly. Tolerances (ROADMAP.md's north star):
outputs on given rays 1e-5 (the JAX replay forms L per round, the port per
sample); camera images 3e-5 (each package makes its own rays, the JAX
package's jitted ray setup rounding 1/|d| through rsqrt); depth on given
rays ``1e-5 * max(1, |d|)``; gradients ``1e-5 * max(1, max|g_jax|)``; index
tables and bake boxes exact. Within the port, the dynamic tape equals the
port's own `render_dynamic_frames` bit for bit, compacted or not
(compaction drops only samples empty in the union, which every frame's
march skips), and fast mode does so against `render_dynamic_frames` with
``box_advance = skip_boxes = 0``, as JAX's test holds it
(tests/test_tape_dynamic.py). The JAX results are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import query as tquery
from svox_t_tpu_torch.ops import tape as tape_ops

ATOL = 1e-5
IMG_ATOL = 3e-5
T_FRAMES = 3
DEPTH = 4  # the tree refines to cells of 1 / 2^DEPTH
W, H, FX = 20, 16, 26.0
N_RAYS = 48


def _t(x):
    return torch.from_numpy(np.array(x))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _poses(T):
    """(T, 2, 4, 4): joint 0 still, joint 1 rotating about z and sliding
    along x (points leave their leaves, so stale pointers stay behind)."""
    out = []
    for i in range(T):
        a = 0.45 * np.sin(2 * np.pi * i / max(T, 1))
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0, 0.04 * i], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
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


class Scene:
    """Seeded inputs shared by both packages, as NumPy arrays."""

    def __init__(self):
        rng = np.random.RandomState(7)
        self.Q = 400
        self.poses = _poses(T_FRAMES)
        self.src = np.stack([np.eye(4, dtype=np.float32)] * 2)
        self.pts, self.sw = _safe_cloud(rng, self.Q, self.poses)
        self.ji = np.tile(np.array([0, 1], np.int32), (self.Q, 1))
        self.rgba = np.concatenate([rng.rand(self.Q, 3), 6.0 + rng.rand(self.Q, 1)],
                                   axis=1).astype(np.float32)
        sh = (rng.randn(self.Q, 13) * 0.4).astype(np.float32)
        sh[:, -1] = 6.0 + rng.rand(self.Q)
        self.sh4 = sh
        self.sh_stack = np.stack([sh * (1.0 + 0.07 * k) for k in range(T_FRAMES)])
        self.stack2 = np.stack([self.rgba, self.rgba * 1.05])
        self.origins, self.dirs = _rays(rng, N_RAYS)
        self.c2w = np.eye(4, dtype=np.float32)
        self.c2w[:3, 3] = [0.5, 0.5, 2.2]
        self.G = rng.randn(2, N_RAYS, 4).astype(np.float32)

    def jax_tree(self, fmt="RGBA"):
        tree = st.N3Tree(N=2, data_dim=4 if fmt == "RGBA" else 13, depth_limit=DEPTH,
                         data_format=fmt)
        tree.refine(repeats=DEPTH - 1)
        return tree

    def port_tree(self, fmt="RGBA"):
        return stt.tree_from_numpy(stt.tree_state(self.jax_tree(fmt)), device="cpu")

    def jax_rays(self):
        o, d = jnp.asarray(self.origins), jnp.asarray(self.dirs)
        return st.Rays(o, d, d)

    def port_rays(self):
        return stt.Rays(_t(self.origins), _t(self.dirs), _t(self.dirs))

    def lbs(self, T=T_FRAMES):
        return self.poses[:T], self.src, self.pts, self.sw, self.ji


@pytest.fixture(scope="module")
def scene():
    return Scene()


def _nofast_box(r):
    r.box_advance = 0
    r.skip_boxes = 0
    return r


@pytest.fixture(scope="module")
def jax_out(scene):
    """Every JAX result the tests compare with, computed once."""
    s = scene
    out = {}
    f = jnp.asarray(s.rgba)
    for backend in ("baked", "tree"):
        tree = s.jax_tree()
        r = st.VolumeRenderer(tree, backend=backend)
        spec_u, _ = r._dyn_union(*s.lbs())
        out["union", backend] = ((np.asarray(spec_u.top), np.asarray(spec_u.aabb_lo),
                                  np.asarray(spec_u.aabb_hi)) if backend == "baked"
                                 else (np.asarray(spec_u.data_flat),))
        for compact in (False, True):
            cols, deps = r.render_dynamic_tape_frames(f, *s.lbs(), rays=s.jax_rays(),
                                                      update_tree=False, compact=compact,
                                                      with_depth=True)
            out["rays", backend, compact] = (np.asarray(cols), np.asarray(deps))
    r = _nofast_box(st.VolumeRenderer(s.jax_tree()))
    out["fast"] = np.asarray(r.render_dynamic_tape_frames(f, *s.lbs(), rays=s.jax_rays(),
                                                          update_tree=False, fast=True,
                                                          compact=False))
    r = st.VolumeRenderer(s.jax_tree("SH4"))
    cols, deps = r.render_dynamic_tape_frames(jnp.asarray(s.sh_stack), *s.lbs(), c2w=s.c2w,
                                              width=W, height=H, fx=FX, update_tree=False,
                                              with_depth=True)
    out["camera"] = (np.asarray(cols), np.asarray(deps))
    tree = s.jax_tree()
    r = st.VolumeRenderer(tree)
    r.render_dynamic_tape_frames(f, *s.lbs(), rays=s.jax_rays(), update_tree=True)
    baked = tree._baked_spec()
    out["updated"] = (np.asarray(jax.device_get(tree._data)).reshape(-1),
                      np.asarray(baked.aabb_lo), np.asarray(baked.aabb_hi))
    r = st.VolumeRenderer(s.jax_tree())
    G = jnp.asarray(s.G)
    out["grad"] = np.asarray(jax.grad(lambda x: jnp.sum(r.render_dynamic_tape_frames(
        x, *s.lbs(2), rays=s.jax_rays(), update_tree=False) * G))(jnp.asarray(s.stack2)))
    return out


def _depth_close(got, want):
    """Depth on given rays: ``1e-5 * max(1, |d|)``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-5 * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# The union pre-pass and the record


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_union_structure_matches_jax(scene, jax_out, backend):
    """The union pre-pass (warp + re-point per frame, the table carried)
    leaves the JAX package's index table exactly (on the bake: its top grid
    and box after the one refresh), and its occupancy covers every
    frame's."""
    s = scene
    r = stt.VolumeRenderer(s.port_tree(), backend=backend)
    spec_u, Q = r._dyn_union(*s.lbs())
    assert Q == s.Q
    if backend == "baked":
        top, lo, hi = jax_out["union", backend]
        R3 = spec_u.R ** 3
        np.testing.assert_array_equal(spec_u.top.numpy(), top.reshape(-1)[:R3])
        np.testing.assert_array_equal(spec_u.aabb_lo.numpy(), lo)
        np.testing.assert_array_equal(spec_u.aabb_hi.numpy(), hi)
        return
    np.testing.assert_array_equal(spec_u.data_flat.numpy(), jax_out["union", backend][0])
    occ_u = (spec_u.data_flat >= 0) & (spec_u.data_flat < s.Q)
    for k in range(T_FRAMES):
        tk = stt.get_transformation_matrix(_t(s.src), _t(s.poses[k]))
        warped, _ = stt.warp_vertices(tk, _t(s.pts), _t(s.sw), _t(s.ji))
        one = tquery.construct_tree(r.tree._spec(), warped)
        assert not ((one >= 0) & (one < s.Q) & ~occ_u).any()


def test_record_dynamic_guards_and_cache(scene):
    """Dynamic tapes are indirect, exact-geometry, recorded against Q rows;
    `record_dynamic_persp` caches on camera x animation x structure, a
    record_t tape serving a plain request."""
    s = scene
    r = stt.VolumeRenderer(s.port_tree())
    tp = r.record_dynamic_rays(s.port_rays(), *s.lbs())
    assert tp.indirect and tp.n_features == s.Q and tp.tval is None
    assert tp.geom[2] == 0 and tp.geom[3] == 0
    tp_t = r.record_dynamic_persp(s.c2w, *s.lbs(), width=W, height=H, fx=FX, record_t=True)
    assert tp_t.tval is not None and tp_t.n_rays == W * H
    n = len(r._tape_cache)
    assert r.record_dynamic_persp(s.c2w, *s.lbs(), width=W, height=H, fx=FX) is tp_t
    assert r.record_dynamic_persp(s.c2w, *s.lbs(), width=W, height=H, fx=FX, record_t=True) is tp_t
    assert len(r._tape_cache) == n
    other = r.record_dynamic_persp(s.c2w, *s.lbs(2), width=W, height=H, fx=FX)
    assert other is not tp_t and len(r._tape_cache) == n + 1


# ---------------------------------------------------------------------------
# render_dynamic_tape_frames against JAX and against render_dynamic_frames


@pytest.mark.parametrize("backend", ["baked", "tree"])
@pytest.mark.parametrize("compact", [False, True])
def test_dynamic_tape_rays(scene, jax_out, backend, compact):
    """Colors and depths on given rays: against JAX at 1e-5, against the
    port's `render_dynamic_frames` bit for bit."""
    s = scene
    r = stt.VolumeRenderer(s.port_tree(), backend=backend)
    cols, deps = r.render_dynamic_tape_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(),
                                              update_tree=False, compact=compact, with_depth=True)
    assert cols.shape == (T_FRAMES, N_RAYS, 4) and deps.shape == (T_FRAMES, N_RAYS, 1)
    want_c, want_d = jax_out["rays", backend, compact]
    np.testing.assert_allclose(cols.numpy(), want_c, atol=ATOL)
    _depth_close(deps.numpy(), want_d)
    fused_c, fused_d = r.render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(),
                                               update_tree=False, with_depth=True)
    assert torch.equal(cols, fused_c) and torch.equal(deps, fused_d)
    assert (deps > 0).any() and (cols[..., 3] > 0.5).any() and (cols[..., 3] == 0).any()


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_dynamic_tape_fast(scene, jax_out, backend):
    """Fast mode: the thresholds are replay-time radiometry; equal to the
    fused loop with the box advance and skip boxes off, bit for bit, and to
    JAX's (on its default backend: without the box advance and skip boxes
    both structures take the same samples) at 1e-5."""
    s = scene
    r = _nofast_box(stt.VolumeRenderer(s.port_tree(), backend=backend))
    for compact in (False, True):
        taped = r.render_dynamic_tape_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(),
                                             update_tree=False, fast=True, compact=compact)
        fused = r.render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(),
                                        update_tree=False, fast=True)
        assert torch.equal(taped, fused)
    np.testing.assert_allclose(taped.numpy(), jax_out["fast"], atol=ATOL)


def test_dynamic_tape_camera_stack_rotations_depth(scene, jax_out):
    """A camera, a per-frame SH4 stack, per-voxel rotations and depth:
    against JAX at the camera tolerance, against `render_dynamic_frames`
    bit for bit; the camera tape is cached across calls."""
    s = scene
    r = stt.VolumeRenderer(s.port_tree("SH4"))
    kw = dict(c2w=s.c2w, width=W, height=H, fx=FX, update_tree=False, with_depth=True)
    cols, deps = r.render_dynamic_tape_frames(_t(s.sh_stack), *s.lbs(), **kw)
    assert cols.shape == (T_FRAMES, H, W, 4) and deps.shape == (T_FRAMES, H, W, 1)
    want_c, want_d = jax_out["camera"]
    np.testing.assert_allclose(cols.numpy(), want_c, atol=IMG_ATOL)
    np.testing.assert_allclose(deps.numpy(), want_d, atol=IMG_ATOL)
    fused_c, fused_d = r.render_dynamic_frames(_t(s.sh_stack), *s.lbs(), **kw)
    assert torch.equal(cols, fused_c) and torch.equal(deps, fused_d)
    no_rot = r.render_dynamic_tape_frames(_t(s.sh_stack), *s.lbs(), viewdir_rotation=False, **kw)[0]
    assert float((no_rot - cols).abs().max()) > 1e-4
    n = len(r._tape_cache)
    again = r.render_dynamic_tape_frames(_t(s.sh_stack) * 1.1, *s.lbs(), **kw)[0]
    assert len(r._tape_cache) == n and not torch.equal(again, cols)


def test_dynamic_tape_explicit_tape(scene):
    """A tape passed in serves the call (outputs in its ray order)."""
    s = scene
    r = stt.VolumeRenderer(s.port_tree())
    tp = r.record_dynamic_rays(s.port_rays(), *s.lbs(), compact=False)
    got = r.render_dynamic_tape_frames(_t(s.rgba), *s.lbs(), tape=tp, update_tree=False)
    want = r.render_dynamic_tape_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(), update_tree=False,
                                        compact=False)
    assert torch.equal(got, want)


def test_dynamic_tape_update_tree(scene, jax_out):
    """update_tree=True leaves the index table and the bake's box equal to
    JAX's (the box starts empty, joins the frames' leaf boxes and the bake's
    old box), and the tree pointed at the last frame as the fused loop
    leaves it."""
    s = scene
    tree = s.port_tree()
    r = stt.VolumeRenderer(tree)
    before = tree.data.copy()
    r.render_dynamic_tape_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays(), update_tree=True)
    table, lo, hi = jax_out["updated"]
    assert not np.array_equal(before.reshape(-1), table)
    np.testing.assert_array_equal(tree.data.reshape(-1), table)
    baked = tree._baked_spec()
    np.testing.assert_array_equal(baked.aabb_lo.numpy(), lo)
    np.testing.assert_array_equal(baked.aabb_hi.numpy(), hi)
    tree2 = s.port_tree()
    stt.VolumeRenderer(tree2).render_dynamic_frames(_t(s.rgba), *s.lbs(), rays=s.port_rays())
    np.testing.assert_array_equal(tree2.data, tree.data)


def test_dynamic_tape_gradients(scene, jax_out):
    """Gradients of a two-frame stack: against JAX and against the port's
    `render_dynamic_frames` at ``1e-5 * max(1, max|g|)``."""
    s = scene
    G = _t(s.G)
    r = stt.VolumeRenderer(s.port_tree())
    f = _t(s.stack2).requires_grad_()
    (r.render_dynamic_tape_frames(f, *s.lbs(2), rays=s.port_rays(), update_tree=False) * G).sum().backward()
    f2 = _t(s.stack2).requires_grad_()
    (r.render_dynamic_frames(f2, *s.lbs(2), rays=s.port_rays(), update_tree=False) * G).sum().backward()
    want = jax_out["grad"]
    assert f.grad.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(f.grad.numpy(), want, atol=_gtol(want))
    np.testing.assert_allclose(f.grad.numpy(), f2.grad.numpy(), atol=_gtol(f2.grad))


def test_dynamic_tape_guards(scene):
    """A direct tape, with_depth without tval, rays and a camera at once,
    a stack of the wrong length and a weight accumulator raise."""
    s = scene
    tree = s.port_tree()
    r = stt.VolumeRenderer(tree)
    f = _t(s.rgba)
    direct = r.record_rays(s.port_rays(), features=f)
    with pytest.raises(ValueError, match="not data-indirect"):
        r.render_dynamic_tape_frames(f, *s.lbs(), tape=direct)
    no_t = r.record_dynamic_rays(s.port_rays(), *s.lbs())
    with pytest.raises(ValueError, match="record_t=True"):
        r.render_dynamic_tape_frames(f, *s.lbs(), tape=no_t, with_depth=True)
    with pytest.raises(ValueError, match="exactly one"):
        r.render_dynamic_tape_frames(f, *s.lbs())
    with pytest.raises(ValueError, match="exactly one"):
        r.render_dynamic_tape_frames(f, *s.lbs(), rays=s.port_rays(), c2w=s.c2w)
    with pytest.raises(ValueError, match="frames"):
        r.render_dynamic_tape_frames(_t(s.stack2), *s.lbs(), tape=no_t)
    with tree.accumulate_weights():
        with pytest.raises(RuntimeError, match="accumulate"):
            r.render_dynamic_tape_frames(f, *s.lbs(), tape=no_t)
    # A structure change makes the tape stale.
    tree.refine(sel=tuple(tree._all_leaves()[:1].T))
    with pytest.raises(ValueError, match="STRUCTURE"):
        r.render_dynamic_tape_frames(f, *s.lbs(), tape=no_t, update_tree=False)


# ---------------------------------------------------------------------------
# The dynamic cache key (D1): the index table's version, the re-file after
# the renderer's own adoption, tensors by identity and in-place version.


def _poses_b(poses):
    """Animation B: animation A with joint 1 moved to (-0.1, -0.15 - 0.05 k, 0)
    in frame k."""
    b = poses.copy()
    for k in range(len(b)):
        b[k, 1, :3, 3] = (-0.1, -0.15 - 0.05 * k, 0.0)
    return b


def _tapes_equal(a, b):
    """Every stream and field of two tapes, bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor), f.name
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def _specs_equal(a, b):
    """Every table, box and field of two render structures, bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        elif not isinstance(x, np.ndarray):
            assert x == y, f.name


def test_dynamic_tape_stale_table_repro(scene):
    """ROADMAP's D1 repro: animation A, then B, both with update_tree=True
    (each adopts its last frame's table), then A with update_tree=False,
    equals a fresh renderer's image on the same tree exactly. Keyed on the
    layout version alone, the third call replayed the tape recorded against
    the first table's union (363 of 960 pixels off by up to 0.892)."""
    s = scene
    tree = s.port_tree()
    r = _nofast_box(stt.VolumeRenderer(tree, backend="tree"))
    f = _t(s.rgba)
    poses_b = _poses_b(s.poses)
    kw = dict(c2w=s.c2w, width=W, height=H, fx=FX)
    lbs_b = (poses_b,) + s.lbs()[1:]
    r.render_dynamic_tape_frames(f, *s.lbs(), update_tree=True, **kw)
    r.render_dynamic_tape_frames(f, *lbs_b, update_tree=True, **kw)
    got = r.render_dynamic_tape_frames(f, *s.lbs(), update_tree=False, **kw)
    fresh = _nofast_box(stt.VolumeRenderer(tree, backend="tree"))
    want = fresh.render_dynamic_tape_frames(f, *s.lbs(), update_tree=False, **kw)
    assert got.shape == (T_FRAMES, H, W, 4)
    assert torch.equal(got, want)
    fused = fresh.render_dynamic_frames(f, *s.lbs(), update_tree=False, **kw)
    assert torch.equal(got, fused)


@pytest.mark.parametrize("backend", ["baked", "tree"])
def test_dynamic_tape_refiled_after_adoption(scene, monkeypatch, backend):
    """The same animation twice with update_tree=True records once: the
    first call re-files its tape under the adopted table's version. The
    union the animation makes from the adopted table equals the one the
    tape was recorded on, and the re-filed tape equals a fresh record on
    the adopted tree, bit for bit."""
    s = scene
    tree = s.port_tree()
    r = stt.VolumeRenderer(tree, backend=backend)
    calls = []
    record = tape_ops.record_tape

    def counting(*a, **k):
        calls.append(1)
        return record(*a, **k)

    monkeypatch.setattr(tape_ops, "record_tape", counting)
    f = _t(s.rgba)
    kw = dict(c2w=s.c2w, width=W, height=H, fx=FX, with_depth=True)
    union_before = r._dyn_union(*s.lbs())[0]
    first = r.render_dynamic_tape_frames(f, *s.lbs(), **kw)
    v = tree._occ_ver
    union_after = r._dyn_union(*s.lbs())[0]
    _specs_equal(union_before, union_after)
    tape = r.record_dynamic_persp(s.c2w, *s.lbs(), width=W, height=H, fx=FX, record_t=True)
    assert len(calls) == 1 and len(r._tape_cache) == 1
    second = r.render_dynamic_tape_frames(f, *s.lbs(), **kw)
    assert len(calls) == 1 and tree._occ_ver == v + 1 and len(r._tape_cache) == 1
    assert r.record_dynamic_persp(s.c2w, *s.lbs(), width=W, height=H, fx=FX, record_t=True) is tape
    fresh = stt.VolumeRenderer(tree, backend=backend).record_dynamic_persp(
        s.c2w, *s.lbs(), width=W, height=H, fx=FX, record_t=True)
    assert len(calls) == 2
    _tapes_equal(tape, fresh)
    assert first[0].shape == second[0].shape == (T_FRAMES, H, W, 4)


def _counting_records(monkeypatch):
    """A list that gains an entry at each `tape.record_tape` call."""
    calls = []
    record = tape_ops.record_tape

    def counting(*a, **k):
        calls.append(1)
        return record(*a, **k)

    monkeypatch.setattr(tape_ops, "record_tape", counting)
    return calls


def test_dynamic_cache_key_tensors(scene, monkeypatch):
    """CPU tensors, NumPy arrays and lists key by their contents: the same
    or equal tensors of another identity hit, an in-place edit that leaves
    the contents as they were hits, one that changes them re-records, as
    does an edit of a NumPy array that a tensor shares
    (``torch.from_numpy``), which bumps no version. The union plan takes the
    same key. (CUDA tensors key by identity and version:
    `test_tensor_key_identity_and_version` here, and on the card
    tests/test_torch_cuda.py `test_dynamic_tape_cache_key_on_the_card`.)"""
    s = scene
    r = stt.VolumeRenderer(s.port_tree())
    calls = _counting_records(monkeypatch)
    cam = dict(width=W, height=H, fx=FX)
    poses, src, pts, sw, ji = (_t(x) for x in s.lbs())
    c2w_t = _t(s.c2w)
    tp = r.record_dynamic_persp(c2w_t, poses, src, pts, sw, ji, **cam)
    assert len(calls) == 1
    assert r.record_dynamic_persp(_t(s.c2w), poses, src, pts.clone(), sw, ji, **cam) is tp
    pts.add_(0.0)
    assert r.record_dynamic_persp(c2w_t, poses, src, pts, sw, ji, **cam) is tp
    assert len(calls) == 1
    pts[0, 0] += 1e-3
    again = r.record_dynamic_persp(c2w_t, poses, src, pts, sw, ji, **cam)
    assert again is not tp and len(calls) == 2
    shared = np.array(s.lbs()[2], copy=True)
    pts_np = torch.from_numpy(shared)
    tp_np = r.record_dynamic_persp(c2w_t, poses, src, pts_np, sw, ji, **cam)
    assert tp_np is tp and len(calls) == 2
    shared[0, 0] += 1e-3
    assert pts_np._version == 0
    assert r.record_dynamic_persp(c2w_t, poses, src, pts_np, sw, ji, **cam) is again
    assert len(calls) == 2
    shared[1, 1] += 1e-3
    assert r.record_dynamic_persp(c2w_t, poses, src, pts_np, sw, ji, **cam) is not again
    assert len(calls) == 3
    host = [np.array(x, copy=True) for x in s.lbs()]
    tp_host = r.record_dynamic_persp(s.c2w.tolist(), *host, **cam)
    assert tp_host is tp and len(calls) == 3
    host[2][0, 0] += 1e-3
    assert r.record_dynamic_persp(s.c2w.copy(), *host, **cam) is again
    assert len(calls) == 3
    plan = r._plan_dyn_union(c2w_t, W, H, FX, FX, False, poses, src, pts, sw, ji, None, block=1)
    assert r._plan_dyn_union(c2w_t, W, H, FX, FX, False, poses, src, pts.clone(), sw, ji, None, block=1) is plan
    sw.mul_(0.5)
    assert r._plan_dyn_union(c2w_t, W, H, FX, FX, False, poses, src, pts, sw, ji, None, block=1) is not plan


def test_tensor_key_identity_and_version():
    """The key of a CUDA tensor (`_TensorKey`, shown here on CPU tensors):
    equal for the same tensor at the same version, unequal after an
    in-place edit (its version bumps, even where the contents stay), for an
    equal tensor of another identity, and once its tensor is gone, even if
    Python hands its ``id`` to a new tensor."""
    from svox_t_tpu_torch.models.renderer import _TensorKey

    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    k = _TensorKey(t)
    assert k == _TensorKey(t) and hash(k) == hash(_TensorKey(t))
    assert k != _TensorKey(t.clone())
    t.add_(0.0)
    assert k != _TensorKey(t) and _TensorKey(t) == _TensorKey(t)
    u = torch.zeros(5)
    ku = _TensorKey(u)
    del u
    v = torch.zeros(5)
    assert ku != _TensorKey(v)
