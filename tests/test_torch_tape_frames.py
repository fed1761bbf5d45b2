"""svox_t_tpu_torch's multi-frame tape replay (K13e), tape depth replay
(K13f), `render_tape_frames` and rig tapes against the JAX package (CPU).

The counterparts of tests/test_tape_frames.py, tests/test_tape_depth.py
and the rig recorder, on depth-5 shell trees (`helpers.build_tree`) with
seeded rays (64 or fewer) and stacks of at most 3 pools.

Tolerances (ROADMAP.md's north star): outputs on given rays 1e-5 (the JAX
replay forms L per round, the port per sample); camera images 3e-5 (each
package makes its own rays); gradients ``1e-5 * max(1, max|g_jax|)``;
depth on given rays ``1e-5 * max(1, |d|)``. In fast mode the two packages'
ray setup can differ by an ulp of 1/|d| (tests/test_torch_tape.py), which
can move a ray's samples, so JAX comparisons there keep the rays whose
setup agrees bit for bit. Within the port: depth replay equals
`render_depth` bit for bit, a frame of `replay_render_frames` equals
`replay_render` bit for bit, and a carried JAX tape's depth equals JAX's
(t * delta_scale of the same recorded floats).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops import tape as jtape
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.ops import render_aux as taux
from svox_t_tpu_torch.ops import tape as ttape
from svox_t_tpu_torch.utils.convert import tape_from_jax

from helpers import build_tree, make_rays

ATOL = 1e-5
IMG_ATOL = 3e-5
N_RAYS = 64
N_FRAMES = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _trays(rays):
    return stt.Rays(*(_t(r) for r in rays))


def _gtol(g):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(g)).max()))


def _depth_close(got, want, keep=None):
    """Depth on given rays: ``1e-5 * max(1, |d|)`` (on the rays of ``keep``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(len(got), bool) if keep is None else keep
    tol = 1e-5 * np.maximum(1.0, np.abs(want[keep]))
    assert (np.abs(got[keep] - want[keep]) <= tol).all(), np.abs(got[keep] - want[keep]).max()


def _shell(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


def _jax_arrays(tp):
    """A JAX RayTape's fields as NumPy arrays and meta (`tape_from_jax`)."""
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(tp) for v in [getattr(tp, f.name)]}


@functools.lru_cache(maxsize=None)
def _scene():
    """(JAX tree, port tree, pool (numpy), rays, same-setup mask, stack)."""
    rng = np.random.RandomState(11)
    jt, feats, _ = build_tree(rng, N=2, data_dim=28, depth_limit=5, n_random_refines=2,
                              data_format="SH9", occupy=_shell)
    rays = make_rays(rng, N_RAYS)
    pt = stt.tree_from_numpy(stt.tree_state(jt), device="cpu")
    feats = np.array(feats)
    spec = jt._spec()
    jo = jax.jit(lambda o, d: jrender._ray_setup(spec, o, d))(rays.origins, rays.dirs)
    to = trender._ray_setup(pt._spec(), _t(rays.origins), _t(rays.dirs))
    same = np.ones(N_RAYS, bool)
    for a, b in zip(jo[:4], to[:4]):
        same &= (np.asarray(a) == b.numpy()).reshape(N_RAYS, -1).all(axis=1)
    stack = np.stack([feats * (1.0 + 0.03 * i) for i in range(N_FRAMES)])
    return jt, pt, feats, rays, same, stack


def _opt(jt, fast=False):
    return dataclasses.replace(st.VolumeRenderer(jt)._get_options(fast), chunk_size=64)


def _record(fast, compact, indirect=False, backend="baked"):
    """(JAX tape, port tape) of the scene's rays, with t."""
    jt, pt, feats, rays, _, _ = _scene()
    opt = _opt(jt, fast)
    jspec = jt._baked_spec() if backend == "baked" else jt._spec()
    tspec = pt._baked_spec() if backend == "baked" else pt._spec()
    M = feats.shape[0]
    jtp = jtape.record_tape(jspec, M, rays.origins, rays.dirs, rays.viewdirs, opt, compact=compact,
                            record_t=True, indirect=indirect)
    r = _trays(rays)
    ttp = ttape.record_tape(tspec, M, r.origins, r.dirs, r.viewdirs, opt, compact=compact,
                            record_t=True, indirect=indirect)
    return jtp, ttp, jspec, tspec, opt


# ---------------------------------------------------------------------------
# replay_depth (K13f)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_replay_depth_matches_jax_and_render_depth(fast, compact):
    """Depth replay against JAX's (on the rays whose setup agrees in fast
    mode), against the port's `render_depth` bit for bit, and a carried JAX
    tape's depth against JAX's own."""
    jt, pt, feats, rays, same, _ = _scene()
    jtp, ttp, jspec, tspec, opt = _record(fast, compact)
    want = np.asarray(jtape.replay_depth(jtp, jnp.asarray(feats), opt, jspec))
    got = ttape.replay_depth(ttp, _t(feats), opt, tspec)
    assert got.shape == (N_RAYS, 1) and got.dtype == torch.float32
    _depth_close(got, want, same if fast else None)
    r = _trays(rays)
    assert torch.equal(got, taux.render_depth(tspec, _t(feats), r.origins, r.dirs, opt))
    carried = tape_from_jax(_jax_arrays(jtp), device="cpu")
    _depth_close(ttape.replay_depth(carried, _t(feats), opt, tspec), want)
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_replay_depth_indirect_frame(compact):
    """An indirect tape's depth through a frame's table, whose occupancy is
    half the recorded one with other rows (and sigmas of both signs):
    equal to `render_depth` on that frame's tree bit for bit and to JAX's
    indirect depth replay."""
    jt, pt, feats, rays, _, _ = _scene()
    opt = _opt(jt)
    M = feats.shape[0]
    r = _trays(rays)
    jtp = jtape.record_tape(jt._spec(), M, rays.origins, rays.dirs, rays.viewdirs, opt,
                            compact=compact, record_t=True, indirect=True)
    ttp = ttape.record_tape(pt._spec(), M, r.origins, r.dirs, r.viewdirs, opt, compact=compact,
                            record_t=True, indirect=True)
    state = stt.tree_state(jt)
    data = state["data"].reshape(-1)
    occ = np.flatnonzero((data >= 0) & (data < M))
    rng = np.random.RandomState(5)
    keep = occ[rng.rand(len(occ)) < 0.5]
    frame = np.full_like(data, int(stt.DATA_SENTINEL))
    frame[keep] = rng.permutation(M)[:len(keep)]
    f2 = rng.randn(M, 28).astype(np.float32)
    f2[:, -1] *= 10.0
    frame_spec = stt.tree_from_numpy(dict(state, data=frame.reshape(state["data"].shape)),
                                     device="cpu")._spec()
    got = ttape.replay_depth(ttp, _t(f2), opt, frame_spec,
                             index_table=ttape.pack_index_table(_t(frame)))
    assert torch.equal(got, taux.render_depth(frame_spec, _t(f2), r.origins, r.dirs, opt))
    full = ttape.replay_depth(ttp, _t(f2), opt, pt._spec(),
                              index_table=ttape.pack_index_table(pt._spec().data_flat))
    assert not torch.equal(got, full) and (got > 0).any()
    want = jtape.replay_depth(jtp, jnp.asarray(f2), opt, jt._spec(),
                              index_table=jtape.pack_index_table(jnp.asarray(frame)))
    _depth_close(got, want)
    # The JAX indirect tape carried across with its cells and t.
    carried = tape_from_jax(_jax_arrays(jtp), device="cpu")
    assert carried.indirect and carried.tval is not None
    _depth_close(ttape.replay_depth(carried, _t(f2), opt, frame_spec,
                                    index_table=ttape.pack_index_table(_t(frame))), want)


def test_replay_depth_guards():
    """A tape without t, interp, a quantized pool, a sharded pool and a
    pool of another row count raise as in the JAX package."""
    jt, pt, feats, rays, _, _ = _scene()
    _, ttp, _, tspec, opt = _record(False, True)
    f = _t(feats)
    r = _trays(rays)
    no_t = ttape.record_tape(tspec, f.shape[0], r.origins, r.dirs, r.viewdirs, opt)
    with pytest.raises(ValueError, match="record_t"):
        ttape.replay_depth(no_t, f, opt, tspec)
    with pytest.raises(ValueError, match="interp"):
        ttape.replay_depth(ttp, f, dataclasses.replace(opt, interp=1), tspec)
    with pytest.raises(NotImplementedError, match="quantized"):
        ttape.replay_depth(ttp, stt.quantize_features(f), opt, tspec)
    with pytest.raises(NotImplementedError, match="sharded"):
        ttape.replay_depth(ttp, f, dataclasses.replace(opt, pool_axis="pool"), tspec)
    with pytest.raises(ValueError, match="re-record"):
        ttape.replay_depth(ttp, torch.zeros(f.shape[0] + 2, 28), opt, tspec)
    with pytest.raises(ValueError, match="geometry"):
        ttape.replay_depth(ttp, f, dataclasses.replace(opt, step_size=2e-3), tspec)
    # A bf16 pool reads its sigma widened, as JAX's .astype does.
    fb = f.to(torch.bfloat16)
    assert torch.equal(ttape.replay_depth(ttp, fb, opt, tspec),
                       ttape.replay_depth(ttp, fb.float(), opt, tspec))


# ---------------------------------------------------------------------------
# replay_render_frames (K13e)


def _frames_grad_jax(jtp, stack, opt, jspec, G, index_table=None):
    fs = jnp.asarray(stack)
    out = np.asarray(jtape.replay_render_frames(jtp, fs, opt, jspec, index_table=index_table))
    g = np.asarray(jax.grad(lambda x: jnp.sum(jtape.replay_render_frames(
        jtp, x, opt, jspec, index_table=index_table) * G))(fs))
    return out, g


def _frames_grad_port(ttp, stack, opt, tspec, G, index_table=None, dtype=torch.float32):
    fs = _t(stack).to(dtype).requires_grad_()
    out = ttape.replay_render_frames(ttp, fs, opt, tspec, index_table=index_table)
    (out * G).sum().backward()
    return out.detach(), fs.grad


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_replay_frames_match_jax(compact):
    """Forward (N, B, C + 1) and the (N, M, D) gradients against JAX's
    `replay_render_frames`; each frame's output equals `replay_render` bit
    for bit and its gradient the single replay's."""
    jt, pt, feats, rays, _, stack = _scene()
    jtp, ttp, jspec, tspec, opt = _record(False, compact)
    G = np.random.RandomState(3).randn(N_FRAMES, N_RAYS, 4).astype(np.float32)
    want, g_want = _frames_grad_jax(jtp, stack, opt, jspec, jnp.asarray(G))
    out, g = _frames_grad_port(ttp, stack, opt, tspec, _t(G))
    assert out.shape == (N_FRAMES, N_RAYS, 4) and g.shape == stack.shape
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), g_want, atol=_gtol(g_want))
    for n in range(N_FRAMES):
        fn = _t(stack[n]).requires_grad_()
        one = ttape.replay_render(ttp, fn, opt, tspec)
        assert torch.equal(out[n], one.detach())
        (one * _t(G[n])).sum().backward()
        assert torch.equal(g[n], fn.grad)


# The format cases of the frame axis: data_dim of each format (as
# tests/test_torch_tape.py's FORMATS), SH9 also with per-voxel rotations.
FRAME_FORMATS = {"RGBA": 4, "SH4": 13, "SH9": 28, "SH9-rot": 28}


@functools.lru_cache(maxsize=None)
def _format_scene(fmt):
    """(JAX tree, port tree, pool (numpy), rays) of a depth-5 shell in
    format ``fmt`` (SH9's rotations come with the specs)."""
    rng = np.random.RandomState(12)
    jt, feats, _ = build_tree(rng, N=2, data_dim=FRAME_FORMATS[fmt], depth_limit=5, n_random_refines=2,
                              data_format=fmt.split("-")[0], occupy=_shell)
    return jt, stt.tree_from_numpy(stt.tree_state(jt), device="cpu"), np.array(feats), make_rays(rng, N_RAYS)


@pytest.mark.parametrize("fmt", list(FRAME_FORMATS))
def test_replay_frames_formats_match_jax(fmt):
    """The frame axis's forward and gradients (its plain version on the CPU)
    against JAX's `replay_render_frames` in each format (D = 4, 13, 28:
    on the card the tape backward's vector widths 4, 1 and 4) and with
    rotations, on the bake's compacted exact tape."""
    jt, pt, feats, rays = _format_scene(fmt)
    jspec, tspec = jt._baked_spec(), pt._baked_spec()
    if fmt.endswith("-rot"):
        rng = np.random.RandomState(13)
        tm = np.tile(np.eye(4, dtype=np.float32), (feats.shape[0], 1, 1))
        ang = rng.rand(feats.shape[0]).astype(np.float32) * 0.5
        tm[:, 0, 0], tm[:, 0, 1] = np.cos(ang), -np.sin(ang)
        tm[:, 1, 0], tm[:, 1, 1] = np.sin(ang), np.cos(ang)
        jspec, tspec = jt._baked_spec(transformation_matrices=tm), pt._baked_spec(
            transformation_matrices=_t(tm))
    opt = _opt(jt)
    M = feats.shape[0]
    jtp = jtape.record_tape(jspec, M, rays.origins, rays.dirs, rays.viewdirs, opt)
    r = _trays(rays)
    ttp = ttape.record_tape(tspec, M, r.origins, r.dirs, r.viewdirs, opt)
    stack = np.stack([feats * (1.0 + 0.03 * i) for i in range(N_FRAMES)])
    G = np.random.RandomState(6).randn(N_FRAMES, N_RAYS, 4).astype(np.float32)  # 3 colors + alpha
    want, g_want = _frames_grad_jax(jtp, stack, opt, jspec, jnp.asarray(G))
    out, g = _frames_grad_port(ttp, stack, opt, tspec, _t(G))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), g_want, atol=_gtol(g_want))
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("case", ["full", "compact", "indirect", "bf16", *(f"fmt-{f}" for f in FRAME_FORMATS)])
def test_replay_forward_frames_plain_matches_jax(case):
    """The frame axis's forward on the CPU, `replay_forward_frames_plain`,
    against JAX's `replay_render_frames` forward on the cases above (the
    scene's tapes uncompacted, compacted and data-indirect, a bf16 stack,
    each format with rotations for SH9); `replay_render_frames` on the CPU
    equals it bit for bit, and so does each frame's `replay_forward_plain`."""
    index = (None, None)
    if case.startswith("fmt-"):
        fmt = case[4:]
        jt, pt, feats, rays = _format_scene(fmt)
        jspec, tspec = jt._baked_spec(), pt._baked_spec()
        if fmt.endswith("-rot"):
            tm = np.tile(np.eye(4, dtype=np.float32), (feats.shape[0], 1, 1))
            ang = np.random.RandomState(13).rand(feats.shape[0]).astype(np.float32) * 0.5
            tm[:, 0, 0], tm[:, 0, 1] = np.cos(ang), -np.sin(ang)
            tm[:, 1, 0], tm[:, 1, 1] = np.sin(ang), np.cos(ang)
            jspec, tspec = jt._baked_spec(transformation_matrices=tm), pt._baked_spec(
                transformation_matrices=_t(tm))
        opt = _opt(jt)
        r = _trays(rays)
        jtp = jtape.record_tape(jspec, feats.shape[0], rays.origins, rays.dirs, rays.viewdirs, opt)
        ttp = ttape.record_tape(tspec, feats.shape[0], r.origins, r.dirs, r.viewdirs, opt)
        stack = np.stack([feats * (1.0 + 0.03 * i) for i in range(N_FRAMES)])
    else:
        jt, pt, _, _, _, stack = _scene()
        indirect = case == "indirect"
        jtp, ttp, jspec, tspec, opt = _record(False, case != "full", indirect=indirect,
                                              backend="tree" if indirect else "baked")
        if indirect:
            jspec, tspec = jt._spec(), pt._spec()
            index = (jtape.pack_index_table(jspec.data_flat), ttape.pack_index_table(tspec.data_flat))
    fs = _t(stack)
    if case == "bf16":
        fs = fs.to(torch.bfloat16)
        stack = fs.float().numpy()
    want = np.asarray(jtape.replay_render_frames(jtp, jnp.asarray(stack), opt, jspec, index_table=index[0]))
    got = ttape.replay_forward_frames_plain(ttp, fs, opt, tspec, index[1])
    assert got.shape == (N_FRAMES, N_RAYS, want.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(ttape.replay_render_frames(ttp, fs, opt, tspec, index_table=index[1]), got)
    for n in range(N_FRAMES):
        assert torch.equal(got[n], ttape.replay_forward_plain(ttp, fs[n], opt, tspec, False, index[1])[0])
    assert (got[..., -1] > 0).any()


def test_replay_frames_are_independent():
    """A cotangent on frame 1 alone gives frame 1 a gradient and frames 0
    and 2 none."""
    _, _, _, _, _, stack = _scene()
    _, ttp, _, tspec, opt = _record(False, True)
    fs = _t(stack).requires_grad_()
    (ttape.replay_render_frames(ttp, fs, opt, tspec)[1] ** 2).sum().backward()
    assert not fs.grad[0].any() and not fs.grad[2].any() and fs.grad[1].abs().max() > 0
    # Changing frame 1 leaves frame 0's gradient as it was.
    a = _t(stack).requires_grad_()
    ttape.replay_render_frames(ttp, a, opt, tspec).pow(2).sum().backward()
    b_in = _t(stack)
    b_in[1] *= 1.5
    b = b_in.requires_grad_()
    ttape.replay_render_frames(ttp, b, opt, tspec).pow(2).sum().backward()
    assert torch.equal(a.grad[0], b.grad[0]) and not torch.equal(a.grad[1], b.grad[1])


def test_replay_frames_thresholded_fallback():
    """Fast mode takes each frame's backward march over the tape's rays:
    equal to the per-frame `replay_render` gradients, and to JAX's on the
    rays whose setup agrees."""
    jt, pt, feats, rays, same, stack = _scene()
    jtp, ttp, jspec, tspec, opt = _record(True, True)
    G = np.random.RandomState(4).randn(N_FRAMES, N_RAYS, 4).astype(np.float32)
    G[:, ~same] = 0.0
    want, g_want = _frames_grad_jax(jtp, stack, opt, jspec, jnp.asarray(G))
    out, g = _frames_grad_port(ttp, stack, opt, tspec, _t(G))
    keep = same & (np.abs(want[..., -1] - (1.0 - opt.stop_thresh)) > 1e-6).all(axis=0)
    np.testing.assert_allclose(out.numpy()[:, keep], want[:, keep], atol=ATOL)
    np.testing.assert_allclose(g.numpy(), g_want, atol=_gtol(g_want))
    for n in range(N_FRAMES):
        fn = _t(stack[n]).requires_grad_()
        (ttape.replay_render(ttp, fn, opt, tspec) * _t(G[n])).sum().backward()
        assert torch.equal(g[n], fn.grad)


def test_replay_frames_indirect_tape():
    """A data-indirect tape with one shared index table: against JAX."""
    jt, pt, feats, rays, _, stack = _scene()
    jtp, ttp, _, _, opt = _record(False, False, indirect=True, backend="tree")
    G = np.random.RandomState(5).randn(N_FRAMES, N_RAYS, 4).astype(np.float32)
    jtable = jtape.pack_index_table(jt._spec().data_flat)
    ttable = ttape.pack_index_table(pt._spec().data_flat)
    want, g_want = _frames_grad_jax(jtp, stack, opt, jt._spec(), jnp.asarray(G), jtable)
    out, g = _frames_grad_port(ttp, stack, opt, pt._spec(), _t(G), ttable)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), g_want, atol=_gtol(g_want))


def test_replay_frames_bf16_and_int8_stacks():
    """A bf16 stack renders as its widened stack and its gradient comes back
    bf16, the float32 sum cast once; an int8 stack renders frame by frame and
    takes no gradient."""
    _, _, _, _, _, stack = _scene()
    _, ttp, _, tspec, opt = _record(False, True)
    G = _t(np.random.RandomState(6).randn(N_FRAMES, N_RAYS, 4).astype(np.float32))
    out_b, g_b = _frames_grad_port(ttp, stack, opt, tspec, G, dtype=torch.bfloat16)
    wide = _t(stack).to(torch.bfloat16).float()
    out_w, g_w = _frames_grad_port(ttp, wide.numpy(), opt, tspec, G)
    assert torch.equal(out_b, out_w)
    assert g_b.dtype == torch.bfloat16 and torch.equal(g_b, g_w.to(torch.bfloat16))
    qs = [stt.quantize_features(_t(f)) for f in stack]
    q = stt.QuantizedFeatures(*(torch.stack(x) for x in zip(*qs)))
    out_q = ttape.replay_render_frames(ttp, q, opt, tspec)
    assert not out_q.requires_grad
    for n in range(N_FRAMES):
        assert torch.equal(out_q[n], ttape.replay_render(ttp, qs[n], opt, tspec))
    with pytest.raises(TypeError, match="no gradient"):
        ttape.replay_backward_frames(ttp, q, opt, out_q, out_q, tspec)
    with pytest.raises(ValueError, match=r"\(N, M, D\)"):
        ttape.replay_render_frames(ttp, _t(stack[0]), opt, tspec)
    assert ttape.replay_render_frames(ttp, _t(stack[:0]), opt, tspec).shape == (0, N_RAYS, 4)


# ---------------------------------------------------------------------------
# render_tape_frames and rig tapes


def test_render_tape_frames_matches_jax():
    """Without per-frame matrices (`replay_render_frames`) and with them
    (a replay per frame): outputs and gradients against JAX's
    `render_tape_frames`; inside a weight accumulator it raises."""
    jt, pt, feats, rays, _, stack = _scene()
    jr, tr = st.VolumeRenderer(jt), stt.VolumeRenderer(pt)
    jtp = jr.record_rays(rays, features=jnp.asarray(feats))
    ttp = tr.record_rays(_trays(rays), features=_t(feats))
    rng = np.random.RandomState(8)
    tms = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, feats.shape[0], 1, 1))
    ang = rng.rand(N_FRAMES, feats.shape[0]).astype(np.float32) * 0.6
    tms[..., 0, 0], tms[..., 0, 1] = np.cos(ang), -np.sin(ang)
    tms[..., 1, 0], tms[..., 1, 1] = np.sin(ang), np.cos(ang)
    G = rng.randn(N_FRAMES, N_RAYS, 4).astype(np.float32)
    for tm in (None, tms):
        jtm = None if tm is None else jnp.asarray(tm)
        want = np.asarray(jr.render_tape_frames(jtp, jnp.asarray(stack), jtm))
        g_want = np.asarray(jax.grad(lambda x: jnp.sum(jr.render_tape_frames(jtp, x, jtm)
                                                       * jnp.asarray(G)))(jnp.asarray(stack)))
        fs = _t(stack).requires_grad_()
        out = tr.render_tape_frames(ttp, fs, None if tm is None else _t(tm))
        (out * _t(G)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)
        np.testing.assert_allclose(fs.grad.numpy(), g_want, atol=_gtol(g_want))
        for n in range(N_FRAMES):
            one = tr.render_tape(ttp, _t(stack[n]), transformation_matrices=None if tm is None
                                 else _t(tm[n]))
            assert torch.equal(out[n].detach(), one)
    with pt.accumulate_weights():
        with pytest.raises(RuntimeError, match="accumulate"):
            tr.render_tape_frames(ttp, _t(stack))


def _rig():
    c2ws = []
    for k in range(3):
        c = np.eye(4, dtype=np.float32)
        c[:3, 3] = [0.45 + 0.05 * k, 0.5, 2.2]
        c2ws.append(c)
    return np.stack(c2ws)


def test_rig_tape_matches_jax():
    """`record_persp_rig` + `render_persp_rig_tape` on 3 small views: (V, H,
    W, C + 1), each view `render_persp` bit for bit, against JAX's at the
    camera tolerance; cached, a record_t rig tape serving a plain request
    (the JAX recorder drops record_t: ROADMAP.md §3); a rig tape as a frame
    stack through `render_tape_frames`."""
    jt, pt, feats, _, _, stack = _scene()
    jr, tr = st.VolumeRenderer(jt), stt.VolumeRenderer(pt)
    c2ws = _rig()
    W, H, fx = 16, 12, 20.0
    want = np.asarray(jr.render_persp_rig_tape(jnp.asarray(feats), c2ws, W, H, fx))
    img = tr.render_persp_rig_tape(_t(feats), c2ws, W, H, fx)
    assert img.shape == (3, H, W, 4)
    np.testing.assert_allclose(img.numpy(), want, atol=IMG_ATOL)
    for v in range(3):
        assert torch.equal(img[v], tr.render_persp(_t(feats), c2ws[v], W, H, fx))
    assert (img[..., 3] > 0.5).any()
    n = len(tr._tape_cache)
    tr.render_persp_rig_tape(_t(feats), c2ws, W, H, fx)
    assert len(tr._tape_cache) == n
    tr._tape_cache.clear()
    tp_t = tr.record_persp_rig(c2ws, W, H, fx, features=_t(feats), record_t=True)
    assert tp_t.tval is not None and len(tr._tape_cache) == 1
    # The JAX recorder drops record_t (ROADMAP.md §3); the port keeps it.
    assert jr.record_persp_rig(c2ws, W, H, fx, features=jnp.asarray(feats), record_t=True).tval is None
    assert tr.record_persp_rig(c2ws, W, H, fx, features=_t(feats)) is tp_t
    frames = tr.render_tape_frames(tp_t, _t(stack))
    assert frames.shape == (N_FRAMES, 3 * H * W, 4)
    assert torch.equal(frames[0].reshape(3, H, W, 4), img)
    with pytest.raises(ValueError, match=r"\(V, 4, 4\)"):
        tr.record_persp_rig(c2ws[0], W, H, fx, features=_t(feats))


@pytest.mark.parametrize("size", [(16, 12, 0), (16, 16, 8), (10, 6, 0)],
                         ids=["blocks32", "blocks8", "scanline"])
def test_jax_rig_tape_carried(size):
    """A JAX rig tape (block-major groups with `ginv` and `out_blocks`, or
    JAX's scanline fallback) carried by `tape_from_jax` comes out in (view,
    pixel) order: the port's replay equals JAX's own replay at 1e-5 and its
    depth JAX's depth replay. For these tapes the group gather and the
    composed `inv_pos` agree."""
    jt, pt, feats, _, _, _ = _scene()
    jr = st.VolumeRenderer(jt)
    W, H, G = size
    jtp = jr.record_persp_rig(_rig(), W, H, 20.0, features=jnp.asarray(feats), group_size=G)
    opt = jr._get_options(False)
    jspec, tspec = jt._baked_spec(), pt._baked_spec()
    want = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec))
    sorted_out = np.asarray(jtape.replay_render(jtp, jnp.asarray(feats), opt, jspec, unsort=False))
    np.testing.assert_array_equal(sorted_out[np.asarray(jtp.inv_pos)], want)
    tp = tape_from_jax(_jax_arrays(jtp), device="cpu")
    assert tp.n_rays == 3 * W * H
    np.testing.assert_allclose(ttape.replay_render(tp, _t(feats), opt, tspec).numpy(), want, atol=ATOL)
    if jtp.group > 1:
        assert jtp.ginv is not None
