"""`tools/mf_census.py` (the plain census of K9d's adds)
against the JAX package's motion-feature VJP (CPU), and its counts.

The census walks the rays as the port's plain VJP does and sums the same
addends, so its gradient is held to `jax.grad` of
`svox_t_tpu.VolumeRenderer.motion_feature_render` at the VJP's tolerance,
``1e-5 * max(1, max|g_jax|)``, on `tests/test_torch_aux.py`'s small
scene, nearest and trilinear, exact and fast. The counts are held to what
they must be: the same rays and joints counted two ways, and a skinning
table whose every row names the same joints, where each hit ray is one
run and each bone adds into one joint.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svox_t_tpu as st
import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import render_aux as taux

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mf_census as tcensus  # noqa: E402

from test_torch_aux import KD, NB, _gtol, _scene, _t, _trays


def _census(pt, feats, lbs, rays, G, interp, fast, ji=None):
    tr = stt.VolumeRenderer(pt, backend="tree", interp="trilinear" if interp else "nearest")
    opt = tr._get_options(fast)
    jf, sw = _t(lbs["jf"]), _t(lbs["sw"])
    ji = _t(lbs["ji"]) if ji is None else ji
    spec = pt._spec(joint_features=jf, skinning_weights=sw, joint_index=ji)
    o, d = (_t(r) for r in _trays(rays)[:2])
    return tcensus.mf_census(spec, jf, _t(feats), o, d, _t(G), opt), (spec, jf, o, d, opt)


@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_census_sums_match_jax_vjp(interp, fast):
    """The census's sums are the JAX package's VJP, and equal the port's
    plain VJP bit for bit (the same terms in the same order)."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(31, "SH4", 13)
    G = rng.randn(len(rays.origins), KD).astype(np.float32)
    jr = st.VolumeRenderer(jt, backend="tree", interp="trilinear" if interp else "nearest")
    gj = np.asarray(jax.grad(lambda j: jnp.sum(jr.motion_feature_render(
        jnp.asarray(feats), j, jnp.asarray(lbs["sw"]), jnp.asarray(lbs["ji"]), rays, fast=fast) * G))(
        jnp.asarray(lbs["jf"])))
    (grad, counts), (spec, jf, o, d, opt) = _census(pt, feats, lbs, rays, G, interp, fast)
    np.testing.assert_allclose(grad.numpy(), gj, atol=_gtol(gj))
    assert np.abs(gj).max() > 0
    assert torch.equal(grad, taux.motion_feature_backward_plain(spec, jf, _t(feats), o, d, _t(G), opt))
    assert counts["contrib"] > 0


def test_census_counts_agree():
    """Each add is a contributing sample's bone with sw > 0 and each
    contributing lane is one of a warp-step's lanes; runs of the same row
    are runs of the same joint-index row, so there are at least as many of
    them; a bone-step's joints lie between one and its lanes, its most
    shared joint between one lane and all."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(32, "SH4", 13)
    G = rng.randn(len(rays.origins), KD).astype(np.float32)
    (_, c), _ = _census(pt, feats, lbs, rays, G, False, False)
    assert c["lanes"] == c["contrib"] > 0 and c["bone_lanes"] == c["adds"]
    assert c["adds"] <= NB * c["contrib"]
    assert c["runs_ji"] <= c["runs_row"] <= c["contrib"]
    assert c["adds_merged_ji"] <= c["adds"]
    assert c["warp_steps"] <= c["contrib"] and c["bone_steps"] <= NB * c["warp_steps"]
    assert c["bone_steps"] <= c["bone_joints"] <= c["bone_lanes"]
    assert c["bone_steps"] <= c["bone_peak"] <= c["bone_lanes"]


def test_census_counts_on_shared_joints():
    """Every row naming joints (0, 1, 2): each hit ray's contributing
    samples are one run of the same joint-index row, each bone-step adds
    into one joint with all its lanes, and a merged run adds each bone
    with a positive weight once."""
    rng, jt, pt, feats, rays, lbs, _ = _scene(33, "SH4", 13)
    G = rng.randn(len(rays.origins), KD).astype(np.float32)
    M = feats.shape[0]
    ji = torch.arange(NB, dtype=torch.int32).repeat(M, 1)
    (_, c), _ = _census(pt, feats, lbs, rays, G, False, False, ji=ji)
    (_, c_rand), _ = _census(pt, feats, lbs, rays, G, False, False)
    assert c["contrib"] == c_rand["contrib"] > c["runs_ji"] > 0
    assert c["bone_joints"] == c["bone_steps"] and c["bone_peak"] == c["bone_lanes"]
    assert c["runs_ji"] <= c["adds_merged_ji"] <= NB * c["runs_ji"]
    assert c_rand["bone_joints"] > c_rand["bone_steps"]
