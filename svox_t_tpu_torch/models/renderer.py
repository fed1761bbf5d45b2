"""VolumeRenderer — the user-facing renderer, the counterpart of
`svox_t_tpu/models/renderer.py` for the serving and training paths and
the aux passes:

  forward(features, rays, transformation_matrices=None, fast=False)
  render_persp(features, c2w, width, height, fx, fy, fast=False)
  opacity_render(features, rays, fast=False)
  render_depth(features, rays, fast=False)
  motion_render(features, rays, fast=False)
  motion_feature_render(features, joint_features, skinning_weights,
                        joint_index, rays, fast=False)

`forward`, `render_persp` and `opacity_render` are differentiable with
respect to ``features``, `motion_feature_render` with respect to
``joint_features``; the first-hit passes are not differentiable. The aux
passes never add into an active weight accumulator. `fast=True` sets
sigma_thresh = stop_thresh = 1e-2; the attribute overrides
``self.sigma_thresh`` / ``self.stop_thresh`` are honored. Rendering runs
on the device of the tree and the feature pool: on CUDA through the
forward- and backward-march kernels, on the CPU through their plain
versions. Inside ``tree.accumulate_weights()`` every render also adds
its per-leaf weights to the tree's accumulator.

This package walks the octree (``backend="tree"``), whose exact outputs
equal the JAX package's baked backend. The baked structure, trilinear
interpolation and quantized pools raise NotImplementedError until the
ROADMAP items that bring them land. Image renders march rays in pixel
order: the JAX package's tile and cost orders only schedule work and do
not change the image.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import render as render_ops
from ..ops import render_aux as aux_ops
from ..utils.dataformat import DataFormat
from ..utils.spec import NDCConfig, Rays, RenderOptions

__all__ = ["VolumeRenderer", "Rays", "NDCConfig", "convert_to_ndc"]


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
        backend: str = "tree",
        chunk_size: int = 1024,
        interp: str = "nearest",
        round_size: int = 0,
    ):
        """`chunk_size` and `round_size` schedule work on a TPU; they are
        accepted and ignored."""
        super().__init__()
        if backend == "baked":
            raise NotImplementedError(
                "backend='baked' waits for the bake kernels K6/K7 "
                "(ROADMAP.md §1 item 12); use backend='tree'"
            )
        if backend != "tree":
            raise ValueError(f"unknown backend {backend!r}")
        if interp in ("trilinear", 1):
            raise NotImplementedError(
                "interp='trilinear' waits for K4 (ROADMAP.md §1 item 10)"
            )
        if interp not in ("nearest", 0):
            raise ValueError(f"unknown interp {interp!r}")
        self.tree = tree
        self.backend = backend
        self.interp = 0
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
        spec = self.tree._spec(transformation_matrices)
        return self._render(spec, features, rays.origins, rays.dirs,
                            rays.viewdirs, self._get_options(fast))

    def render_persp(self, features, c2w, width=800, height=800,
                     fx=1111.111, fy=None, cuda=True, fast=False,
                     schedule="tile"):
        """Render a perspective image; differentiable with respect to
        ``features``.

        :param c2w: (3,4) or (4,4) camera-to-world matrix
        :param schedule: "tile" or "cost"; both render the same image, and
            this package marches in pixel order for either
        :return: (height, width, n_color + 1)
        """
        del cuda
        if schedule not in ("tile", "cost"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.tree.device)
        origins, dirs = render_ops.cam2world_rays(c2w, int(width), int(height),
                                                  float(fx), float(fy))
        vdirs = dirs
        if opt.ndc_width >= 0:
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        out = self._render(self.tree._spec(), features, origins.contiguous(),
                           dirs.contiguous(), vdirs, opt)
        return out.reshape(int(height), int(width), -1)

    def opacity_render(self, features, rays: Rays, cuda=True, fast=False):
        """Alpha-only render, (B, 1); differentiable with respect to
        ``features``."""
        del cuda
        return aux_ops.opacity_render(self.tree._spec(), features, rays.origins,
                                      rays.dirs, self._get_options(fast))

    def render_depth(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit depth map, (B, 1)."""
        del cuda
        return aux_ops.render_depth(self.tree._spec(), features, rays.origins,
                                    rays.dirs, self._get_options(fast))

    def motion_render(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit pass: (motion_feature (B, n_joints), depth (B, 1),
        hit_point (B, 3), data_idx (B, 1)). The tree's ``extra_data``
        holds the joint positions. Not differentiable."""
        del cuda
        if self.tree.extra_data is None:
            raise ValueError("motion_render needs the skeleton's joint positions "
                             "in the tree's extra_data")
        return aux_ops.motion_render(self.tree._spec(), features, rays.origins,
                                     rays.dirs, self._get_options(fast))

    def motion_feature_render(self, features, joint_features, skinning_weights,
                              joint_index, rays: Rays, cuda=True, fast=False):
        """Volumetric LBS-feature render, (B, joint_feature_dim);
        differentiable with respect to ``joint_features``."""
        del cuda
        spec = self.tree._spec(joint_features=joint_features,
                               skinning_weights=skinning_weights, joint_index=joint_index)
        return aux_ops.motion_feature_render(spec, joint_features, features, rays.origins,
                                             rays.dirs, self._get_options(fast))

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
        # Attribute overrides, honored like the reference.
        if hasattr(self, "sigma_thresh"):
            sigma_thresh = self.sigma_thresh
        if hasattr(self, "stop_thresh"):
            stop_thresh = self.stop_thresh
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
            box_advance=1 if fast else 0,
            skip_boxes=1 if fast else 0,
            compat_hit_point=int(getattr(self, "compat_hit_point", 0)),
        )
