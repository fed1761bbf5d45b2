"""svox_t_tpu_torch's dense-grid max-weight pass (K12, `grid_weight_render`)
against the JAX package (CPU).

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
