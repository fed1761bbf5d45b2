"""VolumeRenderer — the user-facing renderer, the counterpart of
`svox_t_tpu/models/renderer.py` for the serving and training paths and
the aux passes:

  forward(features, rays, transformation_matrices=None, fast=False)
  render_persp(features, c2w, width, height, fx, fy, fast=False, schedule="tile")
  plan_rays(rays, fast=False) / plan_persp(c2w, width, height, fx, ...)
  opacity_render(features, rays, fast=False)
  render_depth(features, rays, fast=False)
  motion_render(features, rays, fast=False)
  motion_feature_render(features, joint_features, skinning_weights,
                        joint_index, rays, fast=False)
  render_frames(features_frames, rays, transformation_matrices_frames=None)
  render_persp_frames(features_frames, c2w, width, height, fx, fy, ...)
  render_dynamic_frames(features, tgt_poses, src_pose, points,
                        skinning_weights, joint_index, rays | c2w, ...)
  record_rays(rays, features | n_features, ...) / render_tape(tape, features)
  record_persp(c2w, width, height, fx, ...) / render_persp_tape(features, c2w, ...)
  record_persp_rig(c2ws, ...) / render_persp_rig_tape(features, c2ws, ...)
  render_tape_frames(tape, features_frames, transformation_matrices_frames=None)
  record_dynamic_rays(rays, tgt_poses, ...) / record_dynamic_persp(c2w, tgt_poses, ...)
  render_dynamic_tape_frames(features, tgt_poses, src_pose, points,
                             skinning_weights, joint_index, rays | c2w | tape, ...)

`forward`, `render_persp`, `opacity_render` and the three frame loops
are differentiable with respect to ``features``, `motion_feature_render`
with respect to ``joint_features``; the first-hit passes are not
differentiable. The frame loops are Python loops over frames (the JAX
package's `lax.scan`s); `render_dynamic_frames` is the Artemis frame:
LBS-warp the canonical cloud (`ops/warp.py`), re-point the tree at it
(`construct_tree`, the table carried from frame to frame), refresh the
bake and render. The aux passes never add into an active weight
accumulator. `fast=True` sets sigma_thresh = stop_thresh = 1e-2 and turns
on ``box_advance`` and ``skip_boxes``; the attribute overrides
``self.sigma_thresh``, ``self.stop_thresh``, ``self.box_advance`` and
``self.skip_boxes`` are honored. Rendering runs on the device of the tree
and the feature pool: on CUDA through the march kernels, on the CPU
through their plain versions. Inside ``tree.accumulate_weights()`` every
render also adds its per-leaf weights to the tree's accumulator.

``backend="baked"``, the default as in the JAX package, renders through
the tree's bake (`N3Tree._baked_spec`, `ops/bake.py`): a dense top grid
and brick atlas, the occupied-box cull, and in fast mode the box advance
and the skip boxes. ``backend="tree"`` walks the octree. The two give the
same exact-mode outputs bit for bit; fast mode differs between them, as
in the JAX package. ``interp="trilinear"`` interpolates every sample from
the 8 cells around it (K4, `ops/render.py` `interp_corners`) in every
march and aux pass on both backends; the bake's box cull, box advance
and skip boxes are then off, as in the JAX package. A feature pool is a
float32 or bfloat16 tensor (rendered, differentiated and queried in its
own type, its gradient bf16 too), or an int8 `QuantizedFeatures`
(`quantize_features`; every render and aux pass takes one, and it takes
no gradient); the frame loops take float32 or bf16 stacks.

Ray schedules (`ops/schedule.py`, K15): `plan_rays` and `plan_persp`
return a cost-ordered permutation of a ray batch or of a camera's pixels
and its inverse, int32 tensors on the tree's device. The cost is each
ray's step count of the march's walk (with the density column, the
predicted early stop), sorted stably over the tile order, so that a warp's
rays take alike numbers of steps. ``schedule="cost"`` in `render_persp`,
`render_persp_frames` and `render_dynamic_frames` marches a camera's rays
in the cached plan's order and unsorts the output; ``schedule="union"``
(the dynamic loop) plans against the animation's union occupancy. A plan
never changes an output: every schedule renders bit for bit the image of
``"tile"``, which marches in pixel order (only the weight accumulator's
atomics add in another order).

Recorded sample tapes (`ops/tape.py`): `record_rays` records the samples
of a ray batch once per (rays x structure x geometry), and `render_tape`
replays any feature pool over them with no structure walk, equal to
`forward` bit for bit (compacted or not), differentiable with respect to
the pool and adding weights inside ``tree.accumulate_weights()``.
`record_persp` records a camera's rays in the pixel order `render_persp`
renders and caches the tape on (camera, size, the tree's layout and
occupancy versions, geometry, compaction, record_t); `render_persp_tape`
is `render_persp` through that cache. `record_persp_rig` records V cameras'
pixels as one tape in (view, pixel) order (`render_persp_rig_tape`), and
`render_tape_frames` replays a stack of pools over one tape, its backward
one K13e launch for the stack. The dynamic tapes serve the Artemis frame
without a structure walk: `record_dynamic_persp` / `record_dynamic_rays`
re-point the tree by every frame of an animation (the union occupancy) and
record a data-indirect tape against it, once; `render_dynamic_tape_frames`
then warps, re-points and packs the frame's index table per frame and
replays the tape through it (K13c, and K13f for ``with_depth``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref

import numpy as np
import torch
from torch import nn

from ..ops import bake as bake_ops
from ..ops import query as query_ops
from ..ops import render as render_ops
from ..ops import render_aux as aux_ops
from ..ops import schedule as schedule_ops
from ..ops import tape as tape_ops
from ..ops import warp as warp_ops
from ..utils.dataformat import DataFormat
from ..utils.spec import NDCConfig, Rays, RenderOptions

__all__ = ["VolumeRenderer", "Rays", "NDCConfig", "convert_to_ndc"]

# Cost plans a renderer keeps (plan_persp, the union plan): the oldest
# goes once there are more.
_PLAN_CACHE_MAX = 32


class _TensorKey:
    """A CUDA tensor as a part of a dynamic cache key (`_key_part`): its
    identity, its in-place version counter (``Tensor._version``), shape,
    dtype and device, with no copy of its contents. The key holds a weak
    reference and compares identities with ``is``: Python reuses an ``id``
    once its object is gone, so the ``id`` alone could match another
    tensor. An in-place edit through torch bumps the version, so the key
    misses; a tensor with equal contents but another identity misses too (a
    new record, never a stale one). A write that bypasses the counter
    (through ``.data`` or a raw pointer) is not seen: such a caller passes
    its tape in."""

    __slots__ = ("ref", "sig")

    def __init__(self, t: torch.Tensor):
        self.ref = weakref.ref(t)
        self.sig = (id(t), t._version, tuple(t.shape), t.dtype, t.device)

    def __hash__(self):
        return hash(self.sig)

    def __eq__(self, other):
        if not isinstance(other, _TensorKey) or self.sig != other.sig:
            return False
        t = self.ref()
        return t is not None and t is other.ref()


def _key_part(x, dtype):
    """A part of a dynamic cache key: a CUDA tensor by identity and version
    (`_TensorKey`: its contents stay on the card, unhashed); a CPU tensor, a
    NumPy array or a list by an MD5 of its contents as ``dtype`` and its
    shape. A CPU tensor may share its memory with a NumPy array
    (``torch.from_numpy``), whose edits bump no version, and costs no copy
    from the card to hash."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            return _TensorKey(x)
        x = x.detach().numpy()
    a = np.ascontiguousarray(np.asarray(x, dtype=dtype))
    return (a.shape, hashlib.md5(a.tobytes()).hexdigest())


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of an int32 permutation, on its device."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)
    return inv


def _tile_order(opt: RenderOptions, width: int, height: int, device):
    """The pixel order a plan sorts over (JAX `_tile_order` and
    `_tile_perm`), int32 on ``device``: (tile x tile) blocks of
    max(8, isqrt(chunk_size)) pixels a side in row-major order, row-major
    within a block; None when chunk_size <= 0 (the plan then sorts pixel
    order)."""
    if opt.chunk_size <= 0:
        return None
    tile = max(8, int(np.sqrt(opt.chunk_size)))
    iy = torch.arange(height, device=device)[:, None]
    ix = torch.arange(width, device=device)[None, :]
    tid = (iy // tile) * -(-width // tile) + ix // tile
    return torch.argsort((tid * (width * height) + iy * width + ix).reshape(-1)).to(torch.int32)


def _in_order(rays, perm):
    """A camera's (origins, dirs, viewdirs) gathered into plan order."""
    if perm is None:
        return rays
    return tuple(r.index_select(0, perm) for r in rays)


def _unsort(out, inv, axis: int = 0):
    """Rows of ``out`` back in pixel order (through the plan's inverse)."""
    return out if inv is None else out.index_select(axis, inv)


def convert_to_ndc(origins, directions, focal, w, h, near=1.0):
    """Convert rays to NDC coordinates (the standard NeRF NDC
    projection)."""
    t_near = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t_near[..., None] * directions
    sx = -2.0 * focal / w
    sy = -2.0 * focal / h
    depth = origins[..., 2]
    ndc_o = torch.stack(
        [sx * origins[..., 0] / depth, sy * origins[..., 1] / depth,
         1.0 + 2.0 * near / depth],
        -1,
    )
    ndc_d = torch.stack(
        [
            sx * (directions[..., 0] / directions[..., 2] - origins[..., 0] / depth),
            sy * (directions[..., 1] / directions[..., 2] - origins[..., 1] / depth),
            -2.0 * near / depth,
        ],
        -1,
    )
    return ndc_o, ndc_d


class VolumeRenderer(nn.Module):
    """Volume renderer bound to an N3Tree (see module docstring)."""

    def __init__(
        self,
        tree,
        step_size: float = 1e-3,
        background_brightness: float = 1.0,
        ndc: NDCConfig = None,
        min_comp: int = 0,
        max_comp: int = -1,
        max_steps: int = 1024,
        backend: str = "baked",
        chunk_size: int = 1024,
        interp: str = "nearest",
        round_size: int = 0,
    ):
        """`backend`: "baked" (default) renders through the tree's bake,
        "tree" walks the octree. `interp`: "nearest" (0, leaf-constant
        features) or "trilinear" (1, K4: each sample interpolates the 8
        cells around it on its leaf's grid). `chunk_size` and `round_size`
        schedule work on a TPU; they are accepted and ignored."""
        super().__init__()
        if backend not in ("baked", "tree"):
            raise ValueError(f"unknown backend {backend!r}")
        if interp not in ("nearest", "trilinear", 0, 1):
            raise ValueError(f"unknown interp {interp!r}")
        self.tree = tree
        self.backend = backend
        self.interp = 1 if interp in ("trilinear", 1) else 0
        self.chunk_size = chunk_size
        self.round_size = int(round_size)
        self.step_size = step_size
        self.background_brightness = background_brightness
        self.ndc_config = ndc
        self.min_comp = min_comp
        self.max_comp = max_comp
        self.max_steps = max_steps
        if isinstance(tree.data_format, DataFormat):
            self.data_format = tree.data_format
        else:
            ddim = tree.data_dim
            self.data_format = DataFormat("" if ddim == 4 else f"SH{(ddim - 1) // 3}")
        if self.max_comp < 0:
            self.max_comp += self.data_format.basis_dim
        # Recorded camera tapes (record_persp), oldest first.
        self._tape_cache = {}
        self._tape_cache_max = 4
        # Cost plans (plan_persp, the union plan), oldest first.
        self._plan_cache = {}

    def _render(self, spec, features, origins, dirs, vdirs, opt):
        """Render, adding per-leaf weights into an active accumulator."""
        if self.tree._weight_accum is None:
            return render_ops.volume_render(spec, features, origins, dirs, vdirs, opt)
        out, waccum = render_ops.volume_render_with_weight_accum(
            spec, features, origins, dirs, vdirs, opt
        )
        self.tree._weight_accum.add_(waccum.reshape(self.tree._weight_accum.shape))
        return out

    def forward(self, features, rays: Rays, transformation_matrices=None,
                cuda=True, fast=False):
        """Render a batch of rays; differentiable with respect to
        ``features``.

        :param rays: Rays(origins (B,3), dirs (B,3), viewdirs (B,3)) on the
            tree's device
        :return: (B, n_color + 1) colors + alpha
        """
        del cuda
        spec = self._render_spec(transformation_matrices)
        return self._render(spec, features, rays.origins, rays.dirs,
                            rays.viewdirs, self._get_options(fast))

    def _render_spec(self, transformation_matrices=None):
        """The structure this renderer marches: the bake or the tree."""
        if self.backend == "baked":
            return self.tree._baked_spec(transformation_matrices=transformation_matrices)
        return self.tree._spec(transformation_matrices)

    def render_persp(self, features, c2w, width=800, height=800,
                     fx=1111.111, fy=None, cuda=True, fast=False,
                     schedule="tile"):
        """Render a perspective image; differentiable with respect to
        ``features``.

        :param c2w: (3,4) or (4,4) camera-to-world matrix
        :param schedule: "tile" (pixel order) or "cost": the rays marched
            in the order of the cached `plan_persp` plan, the output unsorted
            through its inverse; the image is the same bit for bit
        :return: (height, width, n_color + 1)
        """
        del cuda
        if schedule not in ("tile", "cost"):
            raise ValueError(f"unknown schedule {schedule!r}")
        opt = self._get_options(fast)
        perm = inv = None
        if schedule == "cost":
            perm, inv = self.plan_persp(c2w, width, height, fx, fy, fast, features=features)
        rays = _in_order(self._camera_rays(c2w, width, height, fx, fy, opt), perm)
        out = _unsort(self._render(self._render_spec(), features, *rays, opt), inv)
        return out.reshape(int(height), int(width), -1)

    def _camera_rays(self, c2w, width, height, fx, fy, opt):
        """(origins, dirs, viewdirs) of every pixel of a (3|4, 4) camera,
        NDC-warped when the renderer has an NDC config."""
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.tree.device)
        origins, dirs = render_ops.cam2world_rays(c2w, int(width), int(height), float(fx),
                                                  float(fx if fy is None else fy))
        vdirs = dirs
        if opt.ndc_width >= 0:
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        return origins.contiguous(), dirs.contiguous(), vdirs

    def opacity_render(self, features, rays: Rays, cuda=True, fast=False):
        """Alpha-only render, (B, 1); differentiable with respect to
        ``features``."""
        del cuda
        return aux_ops.opacity_render(self._render_spec(), features, rays.origins,
                                      rays.dirs, self._get_options(fast))

    def render_depth(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit depth map, (B, 1)."""
        del cuda
        return aux_ops.render_depth(self._render_spec(), features, rays.origins,
                                    rays.dirs, self._get_options(fast))

    def motion_render(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit pass: (motion_feature (B, n_joints), depth (B, 1),
        hit_point (B, 3), data_idx (B, 1)). The tree's ``extra_data``
        holds the joint positions. Not differentiable."""
        del cuda
        if self.tree.extra_data is None:
            raise ValueError("motion_render needs the skeleton's joint positions "
                             "in the tree's extra_data")
        return aux_ops.motion_render(self._render_spec(), features, rays.origins,
                                     rays.dirs, self._get_options(fast))

    def motion_feature_render(self, features, joint_features, skinning_weights,
                              joint_index, rays: Rays, cuda=True, fast=False):
        """Volumetric LBS-feature render, (B, joint_feature_dim);
        differentiable with respect to ``joint_features``."""
        del cuda
        if self.backend == "baked":
            spec = self.tree._baked_spec(skinning_weights=skinning_weights,
                                         joint_index=joint_index)
        else:
            spec = self.tree._spec(joint_features=joint_features,
                                   skinning_weights=skinning_weights, joint_index=joint_index)
        return aux_ops.motion_feature_render(spec, joint_features, features, rays.origins,
                                             rays.dirs, self._get_options(fast))

    def _check_no_accumulator(self, entry: str) -> None:
        if self.tree._weight_accum is not None:
            raise RuntimeError(f"weight accumulation is per-render: {entry} cannot run inside "
                               "accumulate_weights(); use forward() or render_persp() there")

    def _pool(self, features):
        """A pool or stack on the tree's device: a tensor or a quantized
        pool in its own type (JAX `_as_features` and `jnp.asarray`), so
        that a type with no kernel instance raises on the card; a host
        array as float32."""
        if isinstance(features, (torch.Tensor, render_ops.QuantizedFeatures)):
            return features.to(self.tree.device)
        return torch.as_tensor(features, dtype=torch.float32, device=self.tree.device)

    def render_frames(self, features_frames, rays: Rays,
                      transformation_matrices_frames=None, fast=False):
        """Render T animation frames over one ray batch: frame k is
        ``forward(features_frames[k], rays, transformation_matrices_frames[k])``.
        Differentiable with respect to the stack.

        :param features_frames: (T, M, data_dim) per-frame feature pools
        :param rays: Rays with (B, 3) components, shared by all frames
        :param transformation_matrices_frames: optional (T, M, 4, 4)
            per-frame per-voxel view-direction rotations
        :return: (T, B, n_color + 1)
        """
        self._check_no_accumulator("render_frames")
        opt = self._get_options(fast)
        features_frames = self._pool(features_frames)
        tms = self._frame_mats(transformation_matrices_frames, features_frames)
        outs = [render_ops.volume_render(self._render_spec(tm), f, rays.origins, rays.dirs,
                                         rays.viewdirs, opt)
                for f, tm in zip(features_frames.unbind(0), tms)]
        return torch.stack(outs)

    def render_persp_frames(self, features_frames, c2w, width=800, height=800,
                            fx=1111.111, fy=None, transformation_matrices_frames=None,
                            fast=False, schedule="tile"):
        """Render T perspective frames (see `render_frames`). ``c2w`` is one
        (3|4, 4) camera shared by every frame, whose rays are made once, or
        a (T, 3|4, 4) camera path.

        :param schedule: "tile" (pixel order) or "cost": with one shared
            camera, its rays marched in the order of the `plan_persp` plan
            made with frame 0's pool and every frame unsorted (a camera path
            keeps pixel order); the images are the same bit for bit
        :return: (T, height, width, n_color + 1)
        """
        if schedule not in ("tile", "cost"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self._check_no_accumulator("render_persp_frames")
        opt = self._get_options(fast)
        features_frames = self._pool(features_frames)
        tms = self._frame_mats(transformation_matrices_frames, features_frames)
        perm = inv = None
        if schedule == "cost" and torch.as_tensor(c2w).ndim == 2:
            perm, inv = self.plan_persp(c2w, width, height, fx, fy, fast,
                                        features=features_frames[0])
        rays = self._frame_rays(c2w, features_frames.shape[0], width, height, fx, fy, opt, perm)
        outs = [_unsort(render_ops.volume_render(self._render_spec(tm), f, *r, opt), inv)
                for f, tm, r in zip(features_frames.unbind(0), tms, rays)]
        return torch.stack(outs).reshape(len(outs), int(height), int(width), -1)

    def _frame_mats(self, tms, features_frames):
        """Per-frame rotation stacks (or Nones) for a (T, M, D) pool stack."""
        if features_frames.ndim != 3:
            raise ValueError(f"features_frames must be (T, M, D), got "
                             f"{tuple(features_frames.shape)}")
        T = features_frames.shape[0]
        if tms is None:
            return [None] * T
        tms = torch.as_tensor(tms, dtype=torch.float32, device=self.tree.device)
        if tms.ndim != 4 or tms.shape[0] != T:
            raise ValueError(f"transformation_matrices_frames must be (T, M, 4, 4) with T = "
                             f"{T}, got {tuple(tms.shape)}")
        return list(tms.unbind(0))

    def _frame_rays(self, c2w, T, width, height, fx, fy, opt, perm=None):
        """T (origins, dirs, viewdirs) triples: one camera's rays made once
        and shared (gathered into the order of ``perm``, a plan of it), or
        one per frame of a (T, 3|4, 4) path."""
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.tree.device)
        if c2w.ndim == 2:
            return [_in_order(self._camera_rays(c2w, width, height, fx, fy, opt), perm)] * T
        if c2w.ndim != 3 or c2w.shape[0] != T:
            raise ValueError(f"a c2w path must be (T, 3|4, 4) with T = {T}, got "
                             f"{tuple(c2w.shape)}")
        return [self._camera_rays(cam, width, height, fx, fy, opt) for cam in c2w]

    def render_dynamic_frames(self, features, tgt_poses, src_pose, points,
                              skinning_weights, joint_index, rays: Rays = None,
                              c2w=None, width=800, height=800, fx=1111.111,
                              fy=None, fast=False, viewdir_rotation=True,
                              update_tree=True, with_depth=False,
                              schedule="tile"):
        """The Artemis frame loop: per frame k, LBS-warp the canonical
        cloud by pose k (`get_transformation_matrix`, `warp_vertices`),
        re-point the octree at the warped points (`construct_tree`, on the
        table the previous frame left: stale pointers persist), on the
        baked backend refresh the bake from that table with the occupied
        box grown by the points' leaf box (`points_leaf_aabb`, the union
        carried from frame to frame; `construct_tree_aabb` computes the
        table and the box in one descent) and, in fast mode, regrow its skip
        boxes, and render this frame's pool, with the blended matrices as
        per-voxel view-direction rotations when ``viewdir_rotation``.
        Equal to the eager loop of those public calls. Differentiable with
        respect to ``features``; poses, points and skinning get no
        gradient.

        :param features: (Q, data_dim) shared or (T, Q, data_dim) per-frame
            feature pool (row i belongs to point i)
        :param tgt_poses: (T, J, 4, 4) per-frame joint poses
        :param src_pose: (J, 4, 4) canonical pose
        :param points: (Q, 3) canonical point cloud
        :param skinning_weights / joint_index: (Q, n_bones)
        :param rays: shared Rays (B, 3), or else ``c2w``: a (3|4, 4) camera
            (rays made once) or a (T, 3|4, 4) camera path
        :param update_tree: leave the tree pointed at the last frame; False
            leaves its table untouched
        :param with_depth: also return per-frame first-hit depths
        :param schedule: "tile" (pixel order), "cost" (one fixed camera's
            rays in the order of the `plan_persp` plan on the canonical-pose
            structure with frame 0's pool) or "union" (a plan against the
            animation's union occupancy, `_plan_dyn_union`, which no frame of
            it makes stale); all three render the same images bit for bit. A
            camera path or an NDC renderer keeps pixel order; raw rays take
            "tile" only
        :return: (T, B, n_color + 1) for rays, (T, H, W, n_color + 1) for a
            camera; with_depth returns (colors, depths), depths (T, B, 1) /
            (T, H, W, 1)
        """
        if (rays is None) == (c2w is None):
            raise ValueError("pass exactly one of rays and c2w")
        if schedule not in ("tile", "cost", "union"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if rays is not None and schedule != "tile":
            raise ValueError(f"schedule={schedule!r} requires c2w; raw rays take "
                             "schedule='tile'")
        self._check_no_accumulator("render_dynamic_frames")
        opt = self._get_options(fast)
        dev = self.tree.device
        features = self._pool(features)
        tgt_poses = torch.as_tensor(tgt_poses, dtype=torch.float32, device=dev)
        T = tgt_poses.shape[0]
        if features.ndim == 3 and features.shape[0] != T:
            raise ValueError(f"a per-frame pool stack must have T = {T} frames, got "
                             f"{features.shape[0]}")
        pools = features.unbind(0) if features.ndim == 3 else [features] * T
        perm = inv = None
        if rays is not None:
            frame_rays = [(rays.origins, rays.dirs, rays.viewdirs)] * T
        else:
            if torch.as_tensor(c2w).ndim == 2 and opt.ndc_width < 0:
                if schedule == "cost":
                    perm, inv = self.plan_persp(c2w, width, height, fx, fy, fast, features=pools[0])
                elif schedule == "union":
                    perm, inv = self._plan_dyn_union(c2w, width, height, fx, fy, fast, tgt_poses,
                                                     src_pose, points, skinning_weights,
                                                     joint_index, features)
            frame_rays = self._frame_rays(c2w, T, width, height, fx, fy, opt, perm)
        src_pose = torch.as_tensor(src_pose, dtype=torch.float32, device=dev)
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        sw = torch.as_tensor(skinning_weights, dtype=torch.float32, device=dev)
        ji = torch.as_tensor(joint_index, dtype=torch.int32, device=dev)
        spec = self.tree._spec()
        baked = self.tree._baked_spec() if self.backend == "baked" else None
        # The occupied box is carried only where a bake will take it.
        keep_box = baked is not None or self.tree._cached_baked is not None
        if baked is not None:
            lo, hi = baked.aabb_lo, baked.aabb_hi
        else:
            lo, hi = torch.zeros(3, device=dev), torch.ones(3, device=dev)
        colors, depths = [], []
        for k in range(T):
            with torch.no_grad():
                tk = warp_ops.get_transformation_matrix(src_pose, tgt_poses[k])
                warped, mats = warp_ops.warp_vertices(tk, points, sw, ji)
                if keep_box:
                    new_flat, lo, hi = query_ops.construct_tree_aabb(spec, warped, union=(lo, hi))
                else:
                    new_flat = query_ops.construct_tree(spec, warped)
                spec = spec.with_(data_flat=new_flat)
                sp = spec
                if baked is not None:
                    sp = bake_ops.refresh(baked, new_flat, lo, hi)
                    if opt.skip_boxes:
                        sp = bake_ops.grow_boxes_device(sp)
            if viewdir_rotation:
                sp = sp.with_(transformation_matrices=mats)
            o, d, v = frame_rays[k]
            colors.append(render_ops.volume_render(sp, pools[k], o, d, v, opt))
            if with_depth:
                depths.append(aux_ops.render_depth(sp, pools[k], o, d, opt))
        if update_tree:
            if keep_box and self.tree._cached_baked is not None:
                # the tree's bake keeps its old rows: its box joins the union
                old = self.tree._cached_baked
                lo, hi = torch.minimum(lo, old.aabb_lo), torch.maximum(hi, old.aabb_hi)
            self.tree._adopt_data_flat(spec, spec.data_flat, lo if keep_box else None,
                                       hi if keep_box else None)

        def _finish(outs):
            out = _unsort(torch.stack(outs), inv, 1)
            return out if rays is not None else out.reshape(T, int(height), int(width), -1)

        if with_depth:
            return _finish(colors), _finish(depths)
        return _finish(colors)

    # --- cost-ordered ray schedules (ops/schedule.py) ------------------

    def plan_rays(self, rays: Rays, fast=False, n_rows=None, features=None):
        """A cost-ordered schedule of a ray batch (`ops/schedule.py`):
        (perm, inv), int32 permutations on the rays' device. Render
        ``rays[perm]`` and read the outputs back through ``inv``: the
        outputs are the same bit for bit, so a plan may serve many frames
        and only ever goes stale (slower), never wrong.

        :param n_rows: the occupied-row bound of the cost walk (default:
            the rows of ``features``, else of the tree's pool)
        :param features: the pool that will be rendered: its row count and
            density column drive the cost (the predicted early stop in fast
            mode); default the tree's own pool
        """
        opt = self._get_options(fast)
        n_rows, sigmas = self._plan_sigmas(features, n_rows)
        perm = schedule_ops.cost_order(self._render_spec(), rays.origins, rays.dirs, opt, n_rows,
                                       sigmas)
        return perm, _inverse_perm(perm)

    def _plan_sigmas(self, features, n_rows):
        """(n_rows, sigmas) of a plan's cost walk: a float pool's density
        column (a bf16 one widened; `ray_costs`), the first n_rows rows; a
        quantized pool, an odd one, or one with fewer than n_rows rows gives
        its row count only (no stop prediction), as in the JAX package."""
        src = self.tree.features if features is None else features
        if isinstance(src, render_ops.QuantizedFeatures):
            return int(src.q.shape[0] if n_rows is None else n_rows), None
        src = self._pool(src)
        if n_rows is None:
            n_rows = int(src.shape[0])
        ok = src.ndim == 2 and int(src.shape[0]) >= n_rows
        return int(n_rows), src[:n_rows, -1] if ok else None

    def plan_persp(self, c2w, width=800, height=800, fx=1111.111, fy=None, fast=False,
                   n_rows=None, features=None, block=4):
        """A cost-ordered schedule of a perspective camera's pixels (see
        `plan_rays`): (perm, inv), int32 on the tree's device, the stable
        cost sort over the tile order. Cached (FIFO, 32 plans) on the
        camera, the image size, fx, fy, the tree's layout and occupancy
        versions, the options and ``block``; ``render_persp(...,
        schedule="cost")`` uses it.

        ``block`` > 1 costs one ray per (block x block) pixel block, its
        centre, and gives that cost to the whole block: block^2 fewer rays
        walked. A size that ``block`` does not divide takes block 1, the
        per-pixel plan."""
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        c2w_np = torch.as_tensor(c2w, dtype=torch.float32).cpu().numpy()
        bs = int(block)
        if bs < 1 or int(width) % bs or int(height) % bs:
            bs = 1
        key = (c2w_np.tobytes(), int(width), int(height), float(fx), float(fy), self.tree._ver,
               self.tree._occ_ver, opt, bs)
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        n_rows, sigmas = self._plan_sigmas(features, n_rows)
        plan = self._plan_persp_core(self._render_spec(), opt, c2w_np, width, height, fx, fy,
                                     n_rows, sigmas, bs)
        self._plan_cache_put(key, plan)
        return plan

    def _plan_persp_core(self, spec, opt, c2w_np, width, height, fx, fy, n_rows, sigmas, bs):
        """The uncached camera plan (`plan_persp`, the union plan): the
        camera's rays (NDC-warped as the march takes them), the cost walk
        on every block centre (``bs`` > 1) or every pixel, and the stable
        sort of the costs over the tile order; the sort runs on the card."""
        dev = self.tree.device
        width, height = int(width), int(height)
        origins, dirs = render_ops.cam2world_rays(
            torch.as_tensor(c2w_np, device=dev), width, height, float(fx), float(fy))
        if opt.ndc_width >= 0:
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        if bs > 1:
            h2, w2 = height // bs, width // bs
            iy = torch.arange(h2, device=dev)[:, None] * bs + bs // 2
            ix = torch.arange(w2, device=dev)[None, :] * bs + bs // 2
            centers = (iy * width + ix).reshape(-1)
            cost = schedule_ops.ray_costs(spec, origins[centers], dirs[centers], opt, n_rows,
                                          sigmas).reshape(h2, w2)
            cost = cost.repeat_interleave(bs, 0).repeat_interleave(bs, 1).reshape(-1)
        else:
            cost = schedule_ops.ray_costs(spec, origins, dirs, opt, n_rows, sigmas)
        tperm = _tile_order(opt, width, height, dev)
        if tperm is None:
            perm = torch.sort(cost, stable=True).indices.to(torch.int32)
        else:
            perm = tperm[torch.sort(cost[tperm.long()], stable=True).indices]
        return perm, _inverse_perm(perm)

    def _plan_cache_put(self, key, plan) -> None:
        while len(self._plan_cache) > _PLAN_CACHE_MAX:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = plan

    def _plan_dyn_union(self, c2w, width, height, fx, fy, fast, tgt_poses, src_pose, points,
                        skinning_weights, joint_index, features, block=4):
        """A camera plan against the animation's union occupancy
        (`_dyn_union`: every frame's re-point, on the bake the union box),
        cached on the camera, the size, the options, ``block``, the
        animation's arrays and the tree's layout and index-table versions
        (`_dyn_cache_key`). A ray cheap under
        the union is cheap in every frame, so no frame of the animation
        makes it stale. A per-frame pool stack is costed with each point's
        largest density over the frames."""
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        parts = self._dyn_parts(c2w, tgt_poses, src_pose, points, skinning_weights, joint_index)
        key = self._dyn_cache_key(
            ("uplan", int(width), int(height), float(fx), float(fy), opt, int(block)), parts)
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        spec_u, Q = self._dyn_union(tgt_poses, src_pose, points, skinning_weights, joint_index)
        sigmas = None
        if isinstance(features, torch.Tensor) and features.ndim in (2, 3) and features.shape[-2] == Q:
            col = features[..., -1].detach().float()
            sigmas = col.amax(dim=0) if features.ndim == 3 else col
        bs = int(block)
        if bs < 1 or int(width) % bs or int(height) % bs:
            bs = 1
        plan = self._plan_persp_core(spec_u, opt, c2w, width, height, fx, fy, Q, sigmas, bs)
        self._plan_cache_put(key, plan)
        return plan

    # --- recorded sample tapes (ops/tape.py) --------------------------

    def record_rays(self, rays: Rays, features=None, n_features=None,
                    fast=False, compact=True, record_cells=True,
                    chunk_size=0, group_size=1, spec=None, opt=None,
                    indirect=False, record_t=False):
        """Record a `RayTape` for this ray batch against the renderer's
        structure (`ops/tape.py` `record_tape`); `render_tape` then replays
        only the radiometry. Pass ``features`` (or ``n_features``): the
        pool's row count is the occupied/empty split the tape is compacted
        against. ``spec`` / ``opt`` override the recording structure and
        options; ``indirect=True`` records a cell-indexed tape.
        ``chunk_size`` and ``group_size`` schedule the JAX package's TPU
        layout; they are accepted and ignored."""
        del chunk_size, group_size
        if n_features is None:
            if features is None:
                raise ValueError(
                    "pass features or n_features (the feature-pool row "
                    "count defines the occupied/empty split)"
                )
            n_features = features.shape[0]
        if opt is None:
            opt = self._get_options(fast)
        if spec is None:
            spec = self._render_spec()
        return tape_ops.record_tape(
            spec, int(n_features), rays.origins, rays.dirs, rays.viewdirs, opt,
            compact=compact, record_cells=record_cells, indirect=indirect, record_t=record_t,
        )

    def render_tape(self, tape, features, fast=False,
                    transformation_matrices=None, unsort=True):
        """Render by replaying a recorded tape; differentiable with respect
        to ``features`` (exact mode: the tape backward; thresholded modes
        take the backward march). Equal to `forward` on the recorded rays
        bit for bit. Inside ``tree.accumulate_weights()`` it adds its
        per-leaf weights. ``unsort`` is accepted for the JAX API: rows come
        back in ray order either way."""
        spec = self._render_spec(transformation_matrices)
        opt = self._get_options(fast)
        features = self._pool(features)
        if self.tree._weight_accum is None:
            return tape_ops.replay_render(tape, features, opt, spec, unsort=unsort)
        out, waccum = tape_ops.replay_render_weighted(tape, features, opt, spec, unsort=unsort)
        self.tree._weight_accum.add_(waccum.reshape(self.tree._weight_accum.shape))
        return out

    def record_persp(self, c2w, width=800, height=800, fx=1111.111,
                     fy=None, fast=False, features=None, n_features=None,
                     compact=True, group_size=0, record_t=False):
        """Record (and cache) a tape of a perspective camera's rays, in the
        pixel order `render_persp` renders. Cached FIFO on (camera, size,
        the tree's layout and occupancy versions, geometry, compaction,
        record_t); a cached ``record_t=True`` tape also serves
        ``record_t=False`` requests. ``group_size`` is accepted for the
        JAX API and ignored."""
        del group_size
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        spec = self._render_spec()
        c2w_key = torch.as_tensor(c2w, dtype=torch.float32).cpu().numpy().tobytes()

        def mk_key(rt):
            return ("tape", c2w_key, int(width), int(height), float(fx), float(fy),
                    self.tree._ver, self.tree._occ_ver, tape_ops._geom_key(spec, opt),
                    bool(compact), rt)

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        rays = Rays(*self._camera_rays(c2w, width, height, fx, fy, opt))
        tape = self.record_rays(rays, features=features, n_features=n_features, compact=compact,
                                spec=spec, opt=opt, record_t=bool(record_t))
        self._tape_cache_put(key, tape)
        return tape

    def _tape_cache_put(self, key, tape) -> None:
        while len(self._tape_cache) >= self._tape_cache_max:
            self._tape_cache.pop(next(iter(self._tape_cache)))
        self._tape_cache[key] = tape

    def render_persp_tape(self, features, c2w, width=800, height=800,
                          fx=1111.111, fy=None, fast=False, compact=True,
                          group_size=0):
        """`render_persp` through a cached recorded tape: the first call
        per (camera, structure, geometry) records, later calls replay only
        the radiometry. Differentiable with respect to ``features``.

        :return: (height, width, n_color + 1)
        """
        tape = self.record_persp(c2w, width, height, fx, fy, fast=fast, features=features,
                                 compact=compact, group_size=group_size)
        out = self.render_tape(tape, features, fast=fast)
        return out.reshape(int(height), int(width), -1)

    def record_persp_rig(self, c2ws, width=800, height=800, fx=1111.111,
                         fy=None, fast=False, features=None, n_features=None,
                         compact=True, group_size=0, record_t=False):
        """Record (and cache) one tape of a V-camera capture rig: every
        view's pixels in (view, pixel) order, recorded together, so that a
        frame of the whole rig is one replay (`render_persp_rig_tape`, or
        `render_tape_frames` for an animation). Cached FIFO like
        `record_persp`, a ``record_t=True`` tape also serving
        ``record_t=False`` requests. ``group_size`` is accepted for the JAX
        API and ignored.

        :param c2ws: (V, 3|4, 4) camera-to-world matrices
        :return: a RayTape with n_rays == V * width * height
        """
        del group_size
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        spec = self._render_spec()
        c2ws = torch.as_tensor(c2ws, dtype=torch.float32)
        if c2ws.ndim != 3:
            raise ValueError(f"c2ws must be (V, 4, 4), got {tuple(c2ws.shape)}")
        c2w_key = c2ws.cpu().numpy().tobytes()

        def mk_key(rt):
            return ("rig", c2w_key, int(width), int(height), float(fx), float(fy),
                    self.tree._ver, self.tree._occ_ver, tape_ops._geom_key(spec, opt),
                    bool(compact), rt)

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        views = [self._camera_rays(c2w, width, height, fx, fy, opt) for c2w in c2ws]
        rays = Rays(*(torch.cat([v[k] for v in views]).contiguous() for k in range(3)))
        tape = self.record_rays(rays, features=features, n_features=n_features, compact=compact,
                                spec=spec, opt=opt, record_t=bool(record_t))
        self._tape_cache_put(key, tape)
        return tape

    def render_persp_rig_tape(self, features, c2ws, width=800, height=800,
                              fx=1111.111, fy=None, fast=False, compact=True,
                              group_size=0):
        """Render a whole multi-view rig through one cached rig tape
        (`record_persp_rig`); differentiable with respect to ``features``.

        :return: (V, height, width, n_color + 1)
        """
        tape = self.record_persp_rig(c2ws, width, height, fx, fy, fast=fast, features=features,
                                     compact=compact, group_size=group_size)
        out = self.render_tape(tape, features, fast=fast)
        return out.reshape(len(c2ws), int(height), int(width), -1)

    def render_tape_frames(self, tape, features_frames,
                           transformation_matrices_frames=None, fast=False,
                           unsort=True):
        """T animation frames over one recorded tape (`render_frames`' tape
        counterpart): frame k replays ``features_frames[k]``. Without
        per-frame matrices the stack goes through `replay_render_frames`,
        whose backward takes the T gradients in one K13e launch; with
        ``transformation_matrices_frames`` (T, M, 4, 4) each frame is a
        `render_tape` with its rotations. Differentiable with respect to the
        stack. Not inside ``tree.accumulate_weights()``.

        :return: (T, B, n_color + 1)
        """
        self._check_no_accumulator("render_tape_frames")
        opt = self._get_options(fast)
        features_frames = self._pool(features_frames)
        if transformation_matrices_frames is None:
            return tape_ops.replay_render_frames(tape, features_frames, opt, self._render_spec(),
                                                 unsort=unsort)
        tms = self._frame_mats(transformation_matrices_frames, features_frames)
        return torch.stack([tape_ops.replay_render(tape, f, opt, self._render_spec(tm), unsort=unsort)
                            for f, tm in zip(tape_ops.frame_pools(features_frames), tms)])

    # --- data-indirect (dynamic) tapes ----------------------------------

    def _dyn_geom_options(self, fast=False) -> RenderOptions:
        """The options of a dynamic tape's record and replay: the box
        advance and the skip boxes are off (they move samples with the
        occupancy, which changes every frame); the thresholds of ``fast``
        stay, as replay-time radiometry."""
        return dataclasses.replace(self._get_options(fast), box_advance=0, skip_boxes=0)

    def _dyn_inputs(self, tgt_poses, src_pose, points, skinning_weights, joint_index):
        dev = self.tree.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        return (f32(tgt_poses), f32(src_pose), f32(points), f32(skinning_weights),
                torch.as_tensor(joint_index, dtype=torch.int32, device=dev))

    def _dyn_union(self, tgt_poses, src_pose, points, skinning_weights, joint_index):
        """(union structure, Q): the structure a dynamic tape records
        against. The tree is re-pointed by every frame of the animation
        (warp and `construct_tree`, the table carried from frame to frame:
        stale pointers persist, so the last table's occupancy is the union
        over the frames); on the bake it is refreshed once from that table
        under the union of the bake's box and the points' leaf boxes."""
        tgt_poses, src_pose, points, sw, ji = self._dyn_inputs(
            tgt_poses, src_pose, points, skinning_weights, joint_index)
        spec = self.tree._spec()
        baked = self.tree._baked_spec() if self.backend == "baked" else None
        lo, hi = (baked.aabb_lo, baked.aabb_hi) if baked is not None else (None, None)
        with torch.no_grad():
            for tgt in tgt_poses:
                tk = warp_ops.get_transformation_matrix(src_pose, tgt)
                warped, _ = warp_ops.warp_vertices(tk, points, sw, ji)
                if baked is not None:
                    new_flat, lo, hi = query_ops.construct_tree_aabb(spec, warped, union=(lo, hi))
                else:
                    new_flat = query_ops.construct_tree(spec, warped)
                spec = spec.with_(data_flat=new_flat)
            if baked is not None:
                spec = bake_ops.refresh(baked, spec.data_flat, lo, hi)
        return spec, int(points.shape[0])

    @staticmethod
    def _dyn_parts(c2w, tgt_poses, src_pose, points, skinning_weights, joint_index):
        """The camera and the animation's arrays as parts of a dynamic cache
        key (`_dyn_cache_key`): CUDA tensors by identity and version, CPU
        tensors, NumPy arrays and lists by an MD5 of their contents
        (`_key_part`)."""
        return (_key_part(c2w, np.float32), _key_part(tgt_poses, np.float32),
                _key_part(src_pose, np.float32), _key_part(points, np.float32),
                _key_part(skinning_weights, np.float32), _key_part(joint_index, np.int32))

    def _dyn_cache_key(self, tag, parts):
        """A dynamic tape's or union plan's cache key: ``tag``, the parts
        (`_dyn_parts`), the tree's layout version and its index table's
        version: a tape recorded against one table's union is stale once
        the table changes."""
        return (tag, parts, self.tree._ver, self.tree._occ_ver)

    def _dyn_tape_key(self, parts, width, height, fx, fy, compact, record_t):
        if fy is None:
            fy = fx
        opt = self._dyn_geom_options(False)
        return self._dyn_cache_key(
            ("dyn", int(width), int(height), float(fx), float(fy), bool(compact), bool(record_t),
             (float(opt.step_size), int(opt.max_steps), int(opt.interp))), parts)

    def record_dynamic_rays(self, rays: Rays, tgt_poses, src_pose, points,
                            skinning_weights, joint_index, compact=True,
                            group_size=1, record_t=False):
        """Record a data-indirect tape of a ray batch over an animation: the
        tape survives every re-point the animation makes, and a replay
        resolves rows through the frame's index table. ``group_size`` is
        accepted for the JAX API and ignored."""
        del group_size
        spec_u, Q = self._dyn_union(tgt_poses, src_pose, points, skinning_weights, joint_index)
        return self.record_rays(rays, n_features=Q, compact=compact, spec=spec_u,
                                opt=self._dyn_geom_options(False), indirect=True,
                                record_t=record_t)

    def record_dynamic_persp(self, c2w, tgt_poses, src_pose, points,
                             skinning_weights, joint_index, width=800,
                             height=800, fx=1111.111, fy=None,
                             compact=True, group_size=0, record_t=False):
        """Record (and cache) a data-indirect tape of a camera's pixels over
        an animation: one structure walk serves every frame of
        `render_dynamic_tape_frames`. The cache key covers the camera, the
        image size, compaction, record_t, the geometry, the tree's layout
        and index-table versions and the animation's arrays
        (`_dyn_cache_key`); a ``record_t=True`` tape also
        serves ``record_t=False`` requests. ``group_size`` is accepted for
        the JAX API and ignored."""
        del group_size
        parts = self._dyn_parts(c2w, tgt_poses, src_pose, points, skinning_weights, joint_index)
        return self._record_dynamic_persp(parts, c2w, tgt_poses, src_pose, points, skinning_weights,
                                          joint_index, width, height, fx, fy, compact, record_t)

    def _record_dynamic_persp(self, parts, c2w, tgt_poses, src_pose, points, skinning_weights,
                              joint_index, width, height, fx, fy, compact, record_t):
        if fy is None:
            fy = fx
        opt = self._dyn_geom_options(False)

        def mk_key(rt):
            return self._dyn_tape_key(parts, width, height, fx, fy, compact, rt)

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        spec_u, Q = self._dyn_union(tgt_poses, src_pose, points, skinning_weights, joint_index)
        rays = Rays(*self._camera_rays(c2w, width, height, fx, fy, opt))
        tape = self.record_rays(rays, n_features=Q, compact=compact, spec=spec_u, opt=opt,
                                indirect=True, record_t=bool(record_t))
        self._tape_cache_put(key, tape)
        return tape

    def render_dynamic_tape_frames(self, features, tgt_poses, src_pose,
                                   points, skinning_weights, joint_index,
                                   tape=None, rays: Rays = None, c2w=None,
                                   width=800, height=800, fx=1111.111,
                                   fy=None, fast=False,
                                   viewdir_rotation=True, update_tree=True,
                                   compact=True, group_size=0,
                                   with_depth=False):
        """`render_dynamic_frames` through a data-indirect tape: per frame k
        LBS-warp the canonical cloud by pose k, re-point the tree
        (`construct_tree`, the table carried from frame to frame), pack the
        frame's index table (`pack_index_table`) and replay the tape's
        radiometry with this frame's pool, rows resolved through the table
        (K13c) and the blended matrices as rotations when
        ``viewdir_rotation``; with ``with_depth`` also the tape's first-hit
        depth (K13f). No structure walk and no bake refresh in the frame
        loop. The first call per (camera, animation, structure) records the
        tape (`record_dynamic_persp` / `record_dynamic_rays`, with
        ``record_t`` when ``with_depth``), or pass ``tape``. The record and
        the replays take the options of ``fast`` with the box advance and
        skip boxes off. Equal to `render_dynamic_frames` under those
        options, bit for bit with ``compact=False``. Differentiable with
        respect to ``features``. ``update_tree`` leaves the tree pointed at
        the last frame, its bake refreshed under the frames' leaf boxes
        joined to the bake's box. ``group_size`` is accepted for the JAX API
        and ignored.

        :param features: (Q, data_dim) shared or (T, Q, data_dim) per-frame
            pool
        :return: (T, B, n_color + 1) for rays or an explicit tape, (T, H, W,
            n_color + 1) for a camera; with_depth returns (colors, depths),
            depths (T, B, 1) / (T, H, W, 1)
        """
        if tape is None and (rays is None) == (c2w is None):
            raise ValueError("pass exactly one of rays and c2w (or an explicit tape)")
        self._check_no_accumulator("render_dynamic_tape_frames")
        del group_size
        tape_key = None
        if tape is None:
            if c2w is not None:
                parts = self._dyn_parts(c2w, tgt_poses, src_pose, points, skinning_weights, joint_index)
                tape = self._record_dynamic_persp(parts, c2w, tgt_poses, src_pose, points,
                                                  skinning_weights, joint_index, width, height, fx,
                                                  fy, compact, with_depth)
                rt = tape.tval is not None

                def tape_key():
                    return self._dyn_tape_key(parts, width, height, fx, fy, compact, rt)
            else:
                tape = self.record_dynamic_rays(rays, tgt_poses, src_pose, points, skinning_weights,
                                                joint_index, compact=compact, record_t=with_depth)
        if not tape.indirect:
            raise ValueError("tape is not data-indirect; record with "
                             "record_dynamic_persp/record_dynamic_rays")
        if with_depth and tape.tval is None:
            raise ValueError("with_depth needs a tape recorded with record_t=True")
        opt = self._dyn_geom_options(fast)
        tgt_poses, src_pose, points, sw, ji = self._dyn_inputs(
            tgt_poses, src_pose, points, skinning_weights, joint_index)
        T = tgt_poses.shape[0]
        features = self._pool(features)
        if features.ndim == 3 and features.shape[0] != T:
            raise ValueError(f"a per-frame pool stack must have T = {T} frames, got "
                             f"{features.shape[0]}")
        pools = tape_ops.frame_pools(features) if features.ndim == 3 else [features] * T
        tree_spec = spec = self.tree._spec()
        # The occupied box is carried only where a bake will take it; as in
        # the JAX package it starts empty, not at the bake's box.
        keep_box = update_tree and self.tree._cached_baked is not None
        dev = self.tree.device
        lo, hi = torch.ones(3, device=dev), torch.zeros(3, device=dev)
        colors, depths = [], []
        for k in range(T):
            with torch.no_grad():
                tk = warp_ops.get_transformation_matrix(src_pose, tgt_poses[k])
                warped, mats = warp_ops.warp_vertices(tk, points, sw, ji)
                if keep_box:
                    new_flat, lo, hi = query_ops.construct_tree_aabb(spec, warped, union=(lo, hi))
                else:
                    new_flat = query_ops.construct_tree(spec, warped)
                spec = spec.with_(data_flat=new_flat)
                table = tape_ops.pack_index_table(new_flat)
            sp = tree_spec.with_(transformation_matrices=mats) if viewdir_rotation else tree_spec
            colors.append(tape_ops.replay_render(tape, pools[k], opt, sp, index_table=table))
            if with_depth:
                depths.append(tape_ops.replay_depth(tape, pools[k], opt, sp, index_table=table))
        if update_tree:
            if keep_box:
                # the tree's bake keeps its old rows: its box joins the union
                old = self.tree._cached_baked
                lo, hi = torch.minimum(lo, old.aabb_lo), torch.maximum(hi, old.aabb_hi)
            old_key = tape_key() if tape_key is not None else None
            self.tree._adopt_data_flat(spec, spec.data_flat, lo if keep_box else None,
                                       hi if keep_box else None)
            # Re-file the camera's tape under the adopted table's version.
            # The union this animation makes from that table is the one the
            # tape was recorded on: its frames write the same cells and stale
            # pointers keep the rest; on the bake the refresh reads only the
            # table, and the carried box already holds the frames' leaf boxes.
            if old_key is not None and (self.backend == "tree" or keep_box):
                self._tape_cache.pop(old_key, None)
                self._tape_cache_put(tape_key(), tape)

        def _finish(outs):
            out = torch.stack(outs)
            return out if c2w is None else out.reshape(T, int(height), int(width), -1)

        if with_depth:
            return _finish(colors), _finish(depths)
        return _finish(colors)

    def _get_options(self, fast=False) -> RenderOptions:
        """Build the RenderOptions of a call."""
        if self.ndc_config is not None:
            ndc_w, ndc_h, ndc_f = (
                self.ndc_config.width, self.ndc_config.height, self.ndc_config.focal,
            )
        else:
            ndc_w, ndc_h, ndc_f = -1, -1, -1.0
        sigma_thresh = 1e-2 if fast else 0.0
        stop_thresh = 1e-2 if fast else 0.0
        # Fast mode also starts at the occupied box (box_advance) and
        # crosses the bake's skip boxes in one step: both shift samples by
        # bounded amounts, the license of the thresholds.
        box_advance = skip_boxes = 1 if fast else 0
        # Attribute overrides, honored like the reference.
        sigma_thresh = getattr(self, "sigma_thresh", sigma_thresh)
        stop_thresh = getattr(self, "stop_thresh", stop_thresh)
        box_advance = getattr(self, "box_advance", box_advance)
        skip_boxes = getattr(self, "skip_boxes", skip_boxes)
        return RenderOptions(
            step_size=float(self.step_size),
            background_brightness=float(self.background_brightness),
            format=self.data_format.format,
            basis_dim=self.data_format.basis_dim,
            ndc_width=int(ndc_w),
            ndc_height=int(ndc_h),
            ndc_focal=float(ndc_f),
            min_comp=int(self.min_comp),
            max_comp=int(self.max_comp),
            sigma_thresh=float(sigma_thresh),
            stop_thresh=float(stop_thresh),
            max_steps=int(self.max_steps),
            chunk_size=int(self.chunk_size),
            round_size=self.round_size or 4,
            interp=int(self.interp),
            box_advance=int(box_advance),
            skip_boxes=int(skip_boxes),
            compat_hit_point=int(getattr(self, "compat_hit_point", 0)),
        )
