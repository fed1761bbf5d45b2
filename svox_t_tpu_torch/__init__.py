"""svox_t_tpu_torch — the PyTorch and CUDA port of svox_t_tpu.

A second package beside the JAX one (which stays the reference): the
same N^3 sparse voxel octree with an int32 index table into a per-frame
feature pool, serving and training on an NVIDIA Hopper GPU. Serving
re-points the tree at this frame's point cloud (`N3Tree.construct_tree`)
and renders with this frame's feature pool (`VolumeRenderer.forward` /
`render_persp`). Training takes gradients of those renders, and of the
point query `N3Tree.forward`, with respect to the feature pool, and
collects per-leaf weights for pruning (`N3Tree.accumulate_weights`);
`tree[key]` is an `N3TreeView` of leaves (values, corners, in-place
edits, `refine`), and `N3Tree.set`, `merge`, `shrink_to_fit` and the
frontier reductions edit the tree (`unique_leaf_nodes`, `assign` and
`calc_corners` run as kernels). The aux passes
(`VolumeRenderer.opacity_render`, `render_depth`, `motion_render`,
`motion_feature_render`) give opacity, first-hit depth and skeleton
distances, and LBS-blended joint features. The dynamic
frame loop (`VolumeRenderer.render_dynamic_frames`) LBS-warps the
canonical cloud per frame (`warp_vertices`), re-points the tree and
renders; `voxelize` splats a cloud into a density grid, and
`render_frames` / `render_persp_frames` render a stack of pools. Recorded
sample tapes (`record_tape`, `replay_render`, `replay_render_frames`,
`replay_depth`; `VolumeRenderer.record_rays` / `render_tape`,
`render_persp_tape`, `render_persp_rig_tape`, `render_tape_frames`) record
a ray batch's samples once and replay any pool, or a stack of pools, over
them with no structure walk; `render_dynamic_tape_frames` serves an
animation through one data-indirect tape recorded against its union
occupancy. Minibatch training replays random ray subsets of a recorded
(rig) tape (`TapeRowSource`, `subset_tape`, `replay_render_rows`,
`train_minibatches`; `train_steps` over a whole tape: gather, replay, L2
cotangent, tape backward and SGD per step), and `grid_weight_render`
marches a dense sigma grid for PlenOctrees-style pruning. Cost-ordered
ray schedules (`VolumeRenderer.plan_rays`, `plan_persp`, `schedule="cost"`
and `"union"`; `ops.ray_costs`, `ops.cost_order`) sort rays by their
predicted march cost without changing an output, and
`native.quantize_median_cut` is the host median-cut quantizer. A pool
is float32 or bfloat16, or int8 through `quantize_features` (K5). The
renderer marches the tree's bake by default (`ops/bake.py`: a dense top
grid and brick atlas, refreshed at every re-point), as the JAX package
does; `backend="tree"` walks the octree. Entry points run on the CUDA
card unless the caller names another device. The hot loops are
hand-written CUDA kernels under `csrc/`, built by nvcc at first use; on
CPU tensors their plain PyTorch versions run instead.

Names follow `svox_t_tpu/__init__.py`; what is not ported yet is absent.
"""

__version__ = "0.1.0"

from .models.tree import N3Tree, WeightAccumulator
from .models.view import N3TreeView
from .models.renderer import VolumeRenderer, convert_to_ndc
from .utils.spec import (NDCConfig, Rays, RenderOptions, TreeSpec,
                         CameraSpec, DATA_SENTINEL, make_tree_spec)
from .utils.dataformat import DataFormat, LocalIndex
from .ops.sh import eval_sh, eval_sh_bases
from .utils.builders import tree_from_occupancy, tree_structure_from_occupancy
from .utils.convert import quantized_from_numpy, tree_from_numpy, tree_state
from .ops.render import QuantizedFeatures, quantize_features
from .ops.render_aux import (motion_feature_render, motion_render,
                             opacity_render, render_depth)
from .ops.warp import (blend_transformation_matrix, get_transformation_matrix,
                       warp_vertices)
from .ops.p2v import voxelize
from .ops.tape import (RayTape, pack_index_table, record_tape, replay_depth, replay_render,
                       replay_render_frames, replay_render_weighted)
from .ops.tape_subset import (TapeRowSource, replay_render_rows, subset_tape, train_minibatches,
                              train_steps)
from .ops.grid import grid_weight_render

__all__ = [
    "N3Tree",
    "N3TreeView",
    "WeightAccumulator",
    "VolumeRenderer",
    "NDCConfig",
    "Rays",
    "RenderOptions",
    "TreeSpec",
    "CameraSpec",
    "DataFormat",
    "LocalIndex",
    "convert_to_ndc",
    "eval_sh",
    "eval_sh_bases",
    "tree_from_occupancy",
    "tree_structure_from_occupancy",
    "tree_from_numpy",
    "tree_state",
    "quantized_from_numpy",
    "opacity_render",
    "render_depth",
    "motion_render",
    "motion_feature_render",
    "get_transformation_matrix",
    "blend_transformation_matrix",
    "warp_vertices",
    "voxelize",
    "RayTape",
    "record_tape",
    "replay_render",
    "replay_render_weighted",
    "replay_render_frames",
    "replay_depth",
    "pack_index_table",
    "TapeRowSource",
    "subset_tape",
    "replay_render_rows",
    "train_minibatches",
    "train_steps",
    "grid_weight_render",
    "QuantizedFeatures",
    "quantize_features",
    "make_tree_spec",
    "DATA_SENTINEL",
    "__version__",
]
