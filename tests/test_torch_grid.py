"""svox_t_tpu_torch's dense-grid max-weight pass (K12, `grid_weight_render`)
against the JAX package (CPU).

The kernel's occupancy pass (`grid_occupancy_plain`) is held to a NumPy
brute force, and its masked march (`grid_march_mirror`: sigma read only in
marked bricks) to `grid_weight_plain` bit for bit and to the JAX package
under the rules above, on the block and NDC scenes and on seeded grids with
NaN and -inf sigmas, sigmas equal to the threshold and a negative
threshold, at reso 20 and 16.

`test_misc.py::test_grid_weight_render`'s scene (a solid block in a 16^3
grid, a 24x24 camera) and an NDC case (a forward-facing camera over a
seeded 20^3 grid, offset and scaling 0.5). Hit counts compare exactly and
weights within 1e-6, over the rays whose setup agrees bit for bit between
the packages (the NDC warp's normalization differs by an ulp on a few
rays, which moves their samples across voxel faces).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
from svox_t_tpu.ops import grid as jgrid
from svox_t_tpu.ops import render as jrender
from svox_t_tpu.ops import traversal as jtrav
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import grid as tgrid
from svox_t_tpu_torch.ops import render as trender


def _block_scene():
    reso = 16
    data = np.zeros((reso, reso, reso), np.float32)
    data[6:10, 6:10, 6:10] = 20.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.5, 0.5, 3.0]
    opt = dict(step_size=1e-3, sigma_thresh=1e-4, max_steps=256)
    return data, pose, 30.0, 24, opt, np.zeros(3, np.float32), np.ones(3, np.float32)


def _ndc_scene():
    rng = np.random.RandomState(4)
    reso = 20
    data = (rng.rand(reso, reso, reso) * 8.0).astype(np.float32)
    data[rng.rand(reso, reso, reso) < 0.6] = 0.0
    opt = dict(step_size=1e-2, sigma_thresh=0.5, max_steps=128, ndc_width=24, ndc_height=24,
               ndc_focal=26.0)
    return data, np.eye(4, dtype=np.float32), 26.0, 24, opt, np.full(3, 0.5, np.float32), \
        np.full(3, 0.5, np.float32)


def _same_setup(pose, f, wh, opt, offset, scaling):
    """(keep, the port's rays): the rays whose setup agrees bit for bit
    between the packages: the camera rays, their NDC warp and the march's
    tree-space setup, each computed as `grid_weight_render` computes them
    for rays that fit one chunk (op by op, outside the compiled loop)."""
    o, d = jrender.cam2world_rays(jnp.asarray(pose), wh, wh, f, f)
    to, td = trender.cam2world_rays(torch.from_numpy(pose), wh, wh, f, f)
    if opt.get("ndc_width", -1) >= 0:
        d, o = jrender.world2ndc(st.RenderOptions(**opt), d, o)
        td, to = trender.world2ndc(stt.RenderOptions(**opt), td, to)

    def setup(o, d):
        oo = jtrav.world2tree(o, jnp.asarray(offset), jnp.asarray(scaling))
        dd, ds = jtrav.get_delta_scale(jnp.asarray(scaling), d)
        inv = 1.0 / (dd + 1e-9)
        return (o, d, oo, dd, inv, ds, *jtrav.dda_unit(oo, inv))

    tsetup = trender._ray_setup(SimpleNamespace(offset=torch.from_numpy(offset),
                                                scaling=torch.from_numpy(scaling)), to, td)
    keep = np.ones(wh * wh, bool)
    for a, b in zip(setup(o, d), (to, td, *tsetup[:6])):
        keep &= (np.asarray(a) == b.numpy()).reshape(len(keep), -1).all(axis=1)
    return keep, to, td


@pytest.mark.parametrize("scene", [_block_scene, _ndc_scene], ids=["block", "ndc"])
def test_grid_weight_render_matches_jax(scene, monkeypatch):
    """The port's `grid_weight_render` against the JAX package's. The NDC
    warp normalizes the directions in another order in the two packages
    (an ulp on 4 of the 576 rays here), and the tree-space norm too (on 9%
    of the block scene's rays), which can move a ray's samples: the grids
    compare over the rays whose setup agrees (the JAX pass takes them
    through its own ray function, patched in this test), and the port's
    public call equals its plain pass over all its rays. On the block
    scene the public calls also agree over all rays."""
    data, pose, f, wh, opt, offset, scaling = scene()
    topt = stt.RenderOptions(**opt)
    tcam = stt.CameraSpec(c2w=torch.from_numpy(pose), fx=f, fy=f, width=wh, height=wh)
    gw, gh = stt.grid_weight_render(torch.from_numpy(data), tcam, topt, offset, scaling)
    assert gw.shape == gh.shape == data.shape and gw.dtype == gh.dtype == torch.float32
    keep, to, td = _same_setup(pose, f, wh, opt, offset, scaling)
    assert keep.mean() > 0.9
    jcam = st.CameraSpec(c2w=jnp.asarray(pose), fx=f, fy=f, width=wh, height=wh)
    jopt = st.RenderOptions(**opt)
    if scene is _block_scene:
        jgw, jgh = st.grid_weight_render(jnp.asarray(data), jcam, jopt, jnp.asarray(offset),
                                         jnp.asarray(scaling))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
        np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-6, rtol=0)
    args = (torch.from_numpy(offset), torch.from_numpy(scaling), topt)
    pw, ph = tgrid.grid_weight_plain(torch.from_numpy(data), to, td, *args)
    assert torch.equal(pw, gw) and torch.equal(ph, gh)
    o, d = jrender.cam2world_rays(jnp.asarray(pose), wh, wh, f, f)
    monkeypatch.setattr(jgrid, "cam2world_rays", lambda *a: (o[keep], d[keep]))
    gw, gh = tgrid.grid_weight_plain(torch.from_numpy(data), to[keep], td[keep], *args)
    jgw, jgh = st.grid_weight_render(jnp.asarray(data), jcam, jopt, jnp.asarray(offset),
                                     jnp.asarray(scaling))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-6, rtol=0)
    assert float(gh.sum()) > 0 and float(gw.max()) > 0.1


def test_grid_weight_render_block_semantics():
    """`test_misc.py`'s checks on the port: weights on the block's front
    face, less behind it, none above 1."""
    data, pose, f, wh, opt, offset, scaling = _block_scene()
    cam = stt.CameraSpec(c2w=torch.from_numpy(pose), fx=f, fy=f, width=wh, height=wh)
    gw, gh = stt.grid_weight_render(torch.from_numpy(data), cam, stt.RenderOptions(**opt), offset,
                                    scaling)
    assert gw[6:10, 6:10, 9].max() > 0.5
    assert gw[6:10, 6:10, 6].max() < gw[6:10, 6:10, 9].max()
    assert gh.sum() > 0 and gw.max() <= 1.0 + 1e-5
    assert not gh[data == 0].any()


def test_grid_weight_plain_counts_each_sample():
    """The plain version's hits are the samples that contribute: a grid of
    one dense value everywhere counts every sample of every ray, and each
    ray's first sample (L = 1) gives its voxel 1 - exp(-dt * sigma)."""
    reso = 8
    data = torch.full((reso, reso, reso), 3.0)
    o = torch.tensor([[0.5, 0.5, -1.0], [0.05, 0.5, 2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    opt = stt.RenderOptions(step_size=1e-3, max_steps=64)
    gw, gh = tgrid.grid_weight_plain(data, o, d, torch.zeros(3), torch.ones(3), opt)
    # Each ray crosses 8 voxels along z, one sample per voxel plus the
    # step's overshoot: between 8 and 9 samples a ray.
    assert 16 <= float(gh.sum()) <= 18
    assert float(gh[4, 4].sum()) >= 8 and float(gh[0, 4].sum()) >= 8
    first = gw[4, 4, 0]
    assert 0.0 < float(first) < 1.0 and float(gw.max()) < 1.0


def test_dense_density_grid_is_the_shell():
    """`utils/scenes.py`'s dense grid of a shell tree holds each occupied
    leaf's sigma at its cell and 0 elsewhere: the point query of the
    tree at every voxel centre reads the same sigma (0 in empty leaves)."""
    from svox_t_tpu_torch.utils.scenes import build_shell_tree, dense_density_grid

    state, feats, centers = build_shell_tree(depth=4, data_format="RGBA", data_dim=4)
    grid = dense_density_grid(centers, feats[:, -1], 16)
    tree = stt.tree_from_numpy(state, device="cpu")
    c = (np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5) / 16
    rows = tree.forward(torch.from_numpy(feats), torch.from_numpy(c.astype(np.float32)))
    np.testing.assert_array_equal(grid.reshape(-1), rows[:, -1].numpy())
    assert (grid > 0).sum() == len(centers)


def _seeded_scene(reso, thresh, seed):
    """A seeded reso^3 grid over the block scene's camera: 2% of the voxels
    dense (a few clusters), some NaN, -inf and exactly the threshold."""
    rng = np.random.RandomState(seed)
    data = np.zeros((reso, reso, reso), np.float32)
    c = rng.randint(2, reso - 2, (3, 3))
    for x, y, z in c:
        data[x - 2:x + 2, y - 1:y + 2, z - 2:z + 1] = rng.rand() * 30 + 1
    u = rng.rand(reso, reso, reso)
    data[u < 0.01] = np.nan
    data[(u >= 0.01) & (u < 0.02)] = -np.inf
    data[(u >= 0.02) & (u < 0.03)] = thresh
    data[(u >= 0.03) & (u < 0.035)] = 5.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.45, 0.55, 2.5]
    opt = dict(step_size=2e-3, sigma_thresh=thresh, max_steps=400)
    return data, pose, 24.0, 24, opt, np.zeros(3, np.float32), np.ones(3, np.float32)


def _occupancy_brute(data, thresh, brick):
    reso = data.shape[0]
    nb = -(-reso // brick)
    flags = np.zeros(nb ** 3, bool)
    with np.errstate(invalid="ignore"):
        for bx in range(nb):
            for by in range(nb):
                for bz in range(nb):
                    blk = data[bx * brick:(bx + 1) * brick, by * brick:(by + 1) * brick,
                               bz * brick:(bz + 1) * brick]
                    flags[(bx * nb + by) * nb + bz] = bool((blk > thresh).any())
    words = np.zeros(-(-nb ** 3 // 32), np.uint32)
    for b in np.flatnonzero(flags):
        words[b >> 5] |= np.uint32(1 << (b & 31))
    return words.view(np.int32)


@pytest.mark.parametrize("brick", [4, 8, 16])
@pytest.mark.parametrize("reso,thresh", [(16, 0.5), (20, 0.5), (20, -1.0), (13, 0.0),
                                         (20, float("nan"))])
def test_grid_occupancy_plain_matches_brute_force(reso, thresh, brick):
    """The occupancy pass's plain version sets the bit of every brick (edge
    bricks partial) with a voxel whose sigma exceeds the threshold: NaN
    sigmas never do, a NaN threshold marks nothing, a negative one marks
    the zeros too."""
    data = _seeded_scene(reso, 0.5 if thresh != thresh else thresh, 3)[0]
    got = tgrid.grid_occupancy_plain(torch.from_numpy(data), thresh, brick)
    assert got.dtype == torch.int32 and got.shape == (tgrid.mask_words(reso, brick),)
    np.testing.assert_array_equal(got.numpy(), _occupancy_brute(data, thresh, brick))
    if thresh != thresh:
        assert not got.any()


_MIRROR_SCENES = {
    "block": _block_scene,
    "ndc": _ndc_scene,
    "seeded20": lambda: _seeded_scene(20, 0.5, 5),
    "seeded16": lambda: _seeded_scene(16, 0.5, 6),
    "negative_thresh": lambda: _seeded_scene(20, -0.5, 7),
    "zero_thresh16": lambda: _seeded_scene(16, 0.0, 8),
}


@pytest.mark.parametrize("brick", [8, 4])
@pytest.mark.parametrize("scene", sorted(_MIRROR_SCENES))
def test_grid_march_mirror_matches_plain_and_jax(scene, brick, monkeypatch):
    """The kernel's masked march, mirrored in PyTorch, equals
    `grid_weight_plain` bit for bit on every ray, and the JAX package
    (hits exact, weights within 1e-6) on the rays whose setup agrees; its
    census counts a sigma load for every sample in a marked brick, each
    contributing sample once, and the voxels those samples land in."""
    data, pose, f, wh, opt, offset, scaling = _MIRROR_SCENES[scene]()
    topt = stt.RenderOptions(**opt)
    keep, to, td = _same_setup(pose, f, wh, opt, offset, scaling)
    assert keep.mean() > 0.9
    args = (torch.from_numpy(offset), torch.from_numpy(scaling), topt)
    tdata = torch.from_numpy(data)
    mask = tgrid.grid_occupancy_plain(tdata, topt.sigma_thresh, brick)
    gw, gh, census = tgrid.grid_march_mirror(tdata, to, td, *args, mask=mask, brick=brick, width=wh)
    pw, ph = tgrid.grid_weight_plain(tdata, to, td, *args)
    assert torch.equal(gw, pw) and torch.equal(gh, ph)
    assert census["contrib"] == int(gh.sum()) > 0
    assert census["voxels_contrib"] == int((gh > 0).sum()) <= census["voxels_marked"]
    assert census["contrib"] <= census["loads"] <= census["samples"]
    assert census["bricks"] == int(sum(bin(w & 0xFFFFFFFF).count("1") for w in mask.tolist()))
    assert census["warp_steps"] * 32 >= census["samples"] and census["tile_warp_steps"] * 32 >= census["samples"]
    o, d = jrender.cam2world_rays(jnp.asarray(pose), wh, wh, f, f)
    monkeypatch.setattr(jgrid, "cam2world_rays", lambda *a: (o[keep], d[keep]))
    gw, gh, _ = tgrid.grid_march_mirror(tdata, to[keep], td[keep], *args, mask=mask, brick=brick)
    jcam = st.CameraSpec(c2w=jnp.asarray(pose), fx=f, fy=f, width=wh, height=wh)
    jgw, jgh = st.grid_weight_render(jnp.asarray(data), jcam, st.RenderOptions(**opt), jnp.asarray(offset),
                                     jnp.asarray(scaling))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(jgh))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-6, rtol=0)
