"""The backward march's vector widths (K3 and K3+K4, `csrc/render_bwd.cuh`)
on the CPU, where no kernel runs:

  * the width a launch takes: 4 (the row in 16-byte vectors, added with
    vector atomics) only for the three-colour RGBA, SH1 and SH9 rows with no
    spare column (D = 4, 4, 28) whose pool lies on a 4-value boundary and
    whose rotation matrices lie on 16 bytes, else 1 (the earlier loop);
    K2's rule (`render_fwd_width`), taken through `_fwd_width` from a spec
    and a pool of each kind;
  * ``volume_render_backward_cuda(..., width=)`` refuses a width other than
    1 or 4, and width 4 on a row or pointers that do not allow it, in
    Python before any device check; a width it takes reaches the device
    checks;
  * the trilinear backward's corners: at width 4 the kernel finds them from
    each sample's own lookup (K2+K4's levers, `ops/corner_lookup.py`'s
    mirror); on the samples the backward march takes (every sample while
    ``t < tmax``, no early stop), the mirror's corner rows equal
    `interp_corners`' exactly, on the tree walk and the bake, N = 2 and 3.

The plain backward itself is held to the JAX package's by
`tests/test_torch_backward.py` (nearest, exact and fast) and
`tests/test_torch_interp.py` (trilinear, both structures).
"""

import functools

import numpy as np
import pytest
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu_torch.ops import corner_lookup as cl
from svox_t_tpu_torch.ops import render as trender
from svox_t_tpu_torch.utils.spec import FORMAT_ASG, FORMAT_RGBA, FORMAT_SG, FORMAT_SH

from helpers import build_tree, make_rays

FORMATS = {"RGBA": FORMAT_RGBA, "SH": FORMAT_SH, "SG": FORMAT_SG, "ASG": FORMAT_ASG}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _tree(D):
    """A small CPU tree with an SH-sized pool of D columns."""
    t = stt.N3Tree(N=2, data_dim=D, depth_limit=3, data_format="RGBA", device="cpu")
    t.refine(repeats=1)
    return t


def _pool(M, D, dtype, off):
    """An (M, D) pool of ``dtype`` starting ``off`` values past an
    allocation's (aligned) start."""
    return torch.ones(M * D + off, dtype=dtype)[off:].view(M, D)


def _rotations(M, off):
    """(M, 4, 4) identities starting ``off`` floats past an allocation's start."""
    eye = torch.eye(4).expand(M, 4, 4).reshape(-1)
    out = torch.empty(eye.numel() + off)
    out[off:] = eye
    return out[off:].view(M, 4, 4)


# (format, basis_dim, D, pool type, pool offset (values), rotation offset
# (floats; None: no rotations), the width the backward takes).
WIDTH_CASES = [
    ("SH", 9, 28, "f32", 0, None, 4), ("SH", 9, 28, "bf16", 0, None, 4),
    ("SH", 1, 4, "f32", 0, None, 4), ("RGBA", 0, 4, "f32", 0, None, 4),
    ("RGBA", 0, 4, "bf16", 0, None, 4), ("SH", 9, 28, "f32", 0, 0, 4), ("SH", 9, 28, "bf16", 4, 16, 4),
    ("SH", 9, 28, "f32", 4, None, 4), ("SH", 9, 28, "f32", 1, None, 1), ("SH", 9, 28, "bf16", 2, None, 1),
    ("SH", 9, 28, "f32", 0, 1, 1), ("SH", 9, 28, "f32", 0, 2, 1), ("SH", 4, 13, "f32", 0, None, 1),
    ("SH", 16, 49, "f32", 0, None, 1), ("SH", 9, 32, "f32", 0, None, 1), ("RGBA", 0, 8, "f32", 0, None, 1),
    ("SG", 9, 28, "f32", 0, None, 1), ("ASG", 9, 28, "bf16", 0, None, 1),
]


@pytest.mark.parametrize("fmt,bd,D,kind,pool_off,rot_off,want", WIDTH_CASES)
def test_backward_width_rule(fmt, bd, D, kind, pool_off, rot_off, want):
    """The width of a K3 / K3+K4 launch from the row and the alignment of
    its pool and rotations (16-byte vectors of 4 float32 or 8-byte ones of
    4 bf16 values), nearest and interp alike."""
    tree = _tree(D)
    M = tree.n_leaves
    spec = tree._spec() if rot_off is None else tree._spec(transformation_matrices=_rotations(M, rot_off))
    pool = _pool(M, D, DTYPES[kind], pool_off)
    for interp in (False, True):
        opt = stt.RenderOptions(format=FORMATS[fmt], basis_dim=bd if fmt != "RGBA" else -1, interp=interp)
        assert trender._fwd_width(spec, pool, opt) == want


def _backward(tree, pool, opt, width):
    rays = torch.zeros(4, 3)
    g = torch.zeros(4, 4)
    return trender.volume_render_backward_cuda(tree._spec(), pool, rays, rays, rays, g, opt, width=width)


@pytest.mark.parametrize("width", [0, 2, 3, 8, "4", 4.5])
def test_backward_width_override_must_be_1_or_4(width):
    """A width other than 1 or 4 raises before any device check."""
    tree = _tree(28)
    opt = stt.RenderOptions(format=FORMAT_SH, basis_dim=9)
    with pytest.raises(ValueError, match="width must be 1 or 4"):
        _backward(tree, _pool(tree.n_leaves, 28, torch.float32, 0), opt, width)


@pytest.mark.parametrize("fmt,bd,D,kind,off", [
    ("SH", 4, 13, "f32", 0), ("SG", 9, 28, "f32", 0), ("SH", 9, 32, "f32", 0), ("RGBA", 0, 8, "f32", 0),
    ("SH", 9, 28, "f32", 1), ("SH", 9, 28, "bf16", 2)])
def test_backward_width_4_refused_in_python(fmt, bd, D, kind, off):
    """Width 4 on a row with no vector instance, or on a pool off its
    vector alignment, raises in Python; width 1 on the same row passes the
    width checks and stops at the device check (these tensors lie on the
    CPU), as does width 4 on an aligned SH9 row. No width falls back."""
    tree = _tree(D)
    opt = stt.RenderOptions(format=FORMATS[fmt], basis_dim=bd if fmt != "RGBA" else -1)
    pool = _pool(tree.n_leaves, D, DTYPES[kind], off)
    with pytest.raises(ValueError, match="width 4 takes only"):
        _backward(tree, pool, opt, 4)
    with pytest.raises((ValueError, NotImplementedError)) as e1:
        _backward(tree, pool, opt, 1)
    assert "width" not in str(e1.value)
    sh9 = stt.RenderOptions(format=FORMAT_SH, basis_dim=9)
    with pytest.raises(ValueError, match="one CUDA device"):
        _backward(_tree(28), _pool(_tree(28).n_leaves, 28, DTYPES[kind], 0), sh9, 4)


@functools.lru_cache(maxsize=None)
def _scene(N):
    """A JAX-built tree of irregular depth with a part of it empty (the
    port's copy of it, baked on first use), and seeded rays."""
    rng = np.random.RandomState(40 + N)
    jt, _, _ = build_tree(rng, N=N, data_format="RGBA", data_dim=4, depth_limit={2: 4, 3: 3}[N],
                          n_random_refines=2, occupy=lambda c: c[:, 0] < 0.6)
    rays = make_rays(rng, B=96)
    return (stt.tree_from_numpy(stt.tree_state(jt), device="cpu"),
            torch.from_numpy(np.array(rays.origins)), torch.from_numpy(np.array(rays.dirs)))


def _backward_samples(spec, origins, dirs, opt):
    """The tree-space positions of every sample the backward march takes
    (`volume_render_backward_plain`'s rule: while ``t < tmax``, up to
    ``max_steps``, no early stop, no cull under interp)."""
    rays = trender._ray_setup(spec, origins, dirs, opt)
    o, d, invdir, _, tmin, tmax, hit = rays
    t, out = tmin, []
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        leaf, dt = trender._sample_leaf(spec, opt, rays, t)
        out.append(trender.sample_position(o, t, d)[active])
        t = torch.where(active, t + dt, t)
    return torch.cat(out)


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("structure", ["tree", "baked"])
def test_backward_corners_from_own_lookup(N, structure):
    """The corner rows the width-4 trilinear backward adds into, found from
    each sample's own lookup (`corner_lookups`, the kernel's levers), equal
    `interp_corners`' on every sample the backward takes; the samples reach
    both empty and occupied corners."""
    tree, origins, dirs = _scene(N)
    spec = tree._spec() if structure == "tree" else tree._baked_spec()
    opt = stt.VolumeRenderer(tree, interp="trilinear", backend=structure)._get_options(False)
    pos = _backward_samples(spec, origins, dirs, opt)
    assert pos.shape[0] > 500
    leaf = trender._locate(spec, pos)
    rows, _ = trender.interp_corners(spec, pos, leaf.cube_sz)
    got = cl.corner_lookups(spec, pos, leaf.cube_sz)
    assert torch.equal(got.rows.to(rows.dtype), rows)
    M = tree.n_leaves
    assert bool(((rows < 0) | (rows >= M)).any()) and bool(((rows >= 0) & (rows < M)).any())
