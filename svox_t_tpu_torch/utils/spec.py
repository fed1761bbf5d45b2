"""Specs handed to the render and query ops: the PyTorch counterparts of
`svox_t_tpu/utils/spec.py`.

``TreeSpec`` holds the octree's structure tables as torch tensors on one
device. ``child``/``data`` are stored flattened to ``(capacity * N^3,)``
so a descent step is one flat gather, and ``n_levels`` bounds the
descent loop, exactly as in the JAX package. ``RenderOptions`` keeps
every field of the JAX dataclass so the two packages take the same
options; the fields that only schedule work on a TPU (``chunk_size``,
``round_size``, ``straggler_rounds``, the backward sizing and tape
fields, ``pool_axis``/``ray_axis``) are accepted and ignored here.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Any, Optional

import numpy as np
import torch

# Empty-leaf sentinel: int32 wraparound of 1e10 (the value the reference
# fills its index table with). Any data entry >= the pool's row count is
# empty space; this value keeps .npz files interchangeable.
DATA_SENTINEL = np.int32(np.uint64(10_000_000_000) & 0xFFFFFFFF)  # 1410065408

NDCConfig = namedtuple("NDCConfig", ["width", "height", "focal"])
Rays = namedtuple("Rays", ["origins", "dirs", "viewdirs"])

# Format codes mirror DataFormat (utils/dataformat.py).
FORMAT_RGBA = 0
FORMAT_SH = 1
FORMAT_SG = 2
FORMAT_ASG = 3


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render configuration, field for field the JAX package's.

    Semantic fields: ``step_size``, ``background_brightness``,
    ``format``, ``basis_dim``, ``ndc_*``, ``min_comp``/``max_comp``,
    ``sigma_thresh``, ``stop_thresh``, ``max_steps`` (an exact per-ray
    sample cap), ``interp``, ``box_advance``/``skip_boxes`` (fast-mode
    options of a baked spec: start at the occupied box, cross skip boxes
    in one step; no-ops on tree specs) and ``compat_hit_point``. The rest only scheduled work on
    a TPU and are ignored.
    """

    step_size: float = 1e-3
    background_brightness: float = 1.0
    format: int = FORMAT_RGBA
    basis_dim: int = -1
    ndc_width: int = -1
    ndc_height: int = -1
    ndc_focal: float = -1.0
    min_comp: int = 0
    max_comp: int = -1
    sigma_thresh: float = 0.0
    stop_thresh: float = 0.0
    max_steps: int = 1024
    chunk_size: int = 1024
    round_size: int = 4
    interp: int = 0
    box_advance: int = 0
    skip_boxes: int = 0
    compat_hit_point: int = 0
    grad_tape_rows: int = 0
    bwd_bulk_scatter: int = 1
    tape_stop_program: int = 0
    bwd_round_size: int = 0
    bwd_chunk_size: int = 0
    straggler_rounds: int = 0
    pool_axis: Optional[str] = None
    pool_rows: int = 0
    ray_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Octree structure and auxiliary tensors, all on one device.

      child_flat:    (capacity * N^3,) int32 relative child offsets in
                     nodes; 0 = leaf cell.
      data_flat:     (capacity * N^3,) int32 feature-pool row per leaf
                     cell; >= n_features means empty space.
      parent_depth:  (capacity, 2) int32 (packed parent id, depth).
      offset:        (3,) float32 world->tree offset.
      scaling:       (3,) float32 world->tree scale (invradius).
      extra_data:    (K, E) float32 or None (SG/ASG parameters).
      transformation_matrices: (M, 4, 4) float32 or None, per pool row.

    ``N`` is the branching factor, ``n_levels`` the number of descent
    iterations (tree depth + 2), ``n_internal`` the number of nodes in
    use.
    """

    child_flat: torch.Tensor
    data_flat: torch.Tensor
    parent_depth: torch.Tensor
    offset: torch.Tensor
    scaling: torch.Tensor
    extra_data: Optional[torch.Tensor] = None
    joint_features: Optional[torch.Tensor] = None
    skinning_weights: Optional[torch.Tensor] = None
    joint_index: Optional[torch.Tensor] = None
    transformation_matrices: Optional[torch.Tensor] = None
    N: int = 2
    n_levels: int = 11
    n_internal: int = 1

    @property
    def capacity(self) -> int:
        return self.child_flat.shape[0] // (self.N ** 3)

    @property
    def device(self) -> torch.device:
        return self.child_flat.device

    def with_(self, **kw) -> "TreeSpec":
        return dataclasses.replace(self, **kw)


def _tensor(x, dtype, device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()


def make_tree_spec(
    child: Any,
    data: Any,
    parent_depth: Any,
    offset: Any,
    scaling: Any,
    *,
    n_internal: int,
    n_levels: Optional[int] = None,
    extra_data: Any = None,
    joint_features: Any = None,
    skinning_weights: Any = None,
    joint_index: Any = None,
    transformation_matrices: Any = None,
    device: Any = "cpu",
) -> TreeSpec:
    """Build a TreeSpec on ``device`` from (capacity, N, N, N[, 1])-shaped
    tables (NumPy arrays or tensors).

    ``n_levels`` defaults to (max depth stored in parent_depth) + 2, which
    bounds root-to-leaf descent for any point.
    """
    device = torch.device(device)
    child_t = _tensor(child, torch.int32, device)
    N = int(child_t.shape[1])
    data_t = _tensor(data, torch.int32, device).reshape(-1)
    pd = _tensor(parent_depth, torch.int32, device)
    if n_levels is None:
        rows = pd[: max(n_internal, 1), 1]
        max_depth = int(rows.max()) if rows.numel() else 0
        n_levels = max_depth + 2
    f32 = torch.float32
    return TreeSpec(
        child_flat=child_t.reshape(-1),
        data_flat=data_t,
        parent_depth=pd,
        offset=_tensor(offset, f32, device),
        scaling=_tensor(scaling, f32, device),
        extra_data=_tensor(extra_data, f32, device),
        joint_features=_tensor(joint_features, f32, device),
        skinning_weights=_tensor(skinning_weights, f32, device),
        joint_index=_tensor(joint_index, torch.int32, device),
        transformation_matrices=_tensor(transformation_matrices, f32, device),
        N=N,
        n_levels=int(n_levels),
        n_internal=int(n_internal),
    )


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Pinhole camera."""

    c2w: torch.Tensor  # (3, 4) or (4, 4)
    fx: float = 1111.111
    fy: float = 1111.111
    width: int = 800
    height: int = 800


def get_out_data_dim(format: int, basis_dim: int, in_data_dim: int) -> int:
    """Color channels + 1 (alpha) of a render."""
    if format != FORMAT_RGBA:
        return (in_data_dim - 1) // basis_dim + 1
    return in_data_dim
