"""Smoke run of svox_t_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the package's CUDA kernels from `svox_t_tpu_torch/csrc`, holds
each kernel against its plain PyTorch version at the main paths' shapes
(construct_tree; the forward march in RGBA, SH9, SH9 with rotations,
SG9 and ASG9, with weight accumulation; the backward march in five
cases; the point query forward and backward; the aux kernels, exact and
fast: the opacity VJP, the first hit, the motion-feature forward and
backward; the LBS warp forward and backward, also at 2 joints and 2
bones, with the census of the backward's register runs from their plain
mirror; the voxelize splat forward, in the cloud's row order and
shuffled, with the count of its blocks that took the shared tile against
the plain mirror's, and backward; then the bake: the
depth-9 shell baked on the host, the K6 point lookup on every leaf centre
and 1M seeded points, K7a refresh after a re-point and points_leaf_aabb,
exactly, K7b skip-box regrowth on bench.py's dynamic tree, exactly, the
baked forward march on one of bench.py's fast frames, whose march steps
across those skip boxes, the baked instances of the forward march (SH9,
SH9 with rotations, with weights), of the backward and of the four aux
kernels, exact and fast;
and the baked and tree-walk kernels bit for bit in exact mode; then the
trilinear (K4) instances of the six march kernels on both structures
against their plain versions on every camera ray, and the two
structures' exact interp renders and depths bit for bit; then the
feature pools' instances (K5): every bf16 and int8 instance of the march
kernels, on both structures, nearest and interp, its forwards equal bit
for bit to the float32 kernels on the widened (or dequantized) pool on
every camera ray and each instance against its plain version on the
same rays, the bf16 backward and opacity VJP also after their cast to
bf16, the two structures' renders bit for bit, and the bf16 point query),
then the recorded sample tapes (K13: the count and record kernels equal
to their plain versions on every camera ray, both structures, exact and
fast, compacted and not; the replay forward equal to the forward march
bit for bit, with rotations and with weights, and across bench.py's
skip boxes, its vector widths 4 and 1 equal bit for bit; its bf16 and
int8 instances equal to the float32 one on the widened pools and to the
march's pool instances, widths 4 and 1 bit for bit; the replay backward
against plain and the backward march, each of its vector widths 4 and 1
against plain;
an indirect tape replayed after a re-point equal to the march on the
re-pointed tree; the depth replay K13f equal to its plain version and to
the first-hit kernel bit for bit on every tape, direct and indirect; the
multi-frame backward K13e on a stack of 4 pools, float32 and bf16,
each width against its plain version, and against 4 calls of the
single-frame backward; the forward's frame axis on stacks of 4 pools,
float32, bf16 and int8, each width equal to 4 single K13c launches bit
for bit and against its plain version),
then minibatch tape training and the dense-grid weight pass (phase 3h,
K14 and K12: the run gather K14a on a 65,536-ray subset of bench.py's
4-view rig tape with duplicate ids, compacted and not, with cells, and
the SGD update K14c bit for bit, timed beside `pool.add_` in turns, L2
cold and warm (K14C_PAIRS rounds each, their spread printed); the tape
backward K13d at that subset's shape, widths 4 and 1 against plain on a
seeded unit-scale cotangent and timed in turns; the replay forward K13c at
that shape, widths 4 and 1 bit for bit equal to each other and to the
forward march on the subset's rays (float32, bf16 and int8 pools), against
plain, and timed in turns, L2 cold and warm, beside its byte bound; the L2 cotangent K14b bit for bit, its
loss within 1e-6 relative; K12, its occupancy pass and its march, each
bit for bit against its plain version on the depth-9 shell's 512^3
density grid, on a solid ball of the shell's outer radius and on a seeded
100^3 grid with NaN and -inf sigmas, the pair timed by the profiler), then
the ray schedules' cost walk (phase 3i,
K15: its counts equal to its plain version's on every camera ray, both
structures, exact and fast with and without the pool's sigma column, the
rays whose transmittance comes within 1e-6 of the stop counted and
printed), then
drives the main paths through the public entry points on the depth-9 SH9
shell scene at 800x800, with a seeded 32-joint skeleton for the aux and
dynamic paths, each on the default baked backend and on the tree walk
(`backend="tree"`):

  * serving: three frames of `N3Tree.construct_tree` with the frame's
    point cloud and `VolumeRenderer.render_persp` (exact and fast) with
    the frame's feature pool (on the bake, each re-point refreshes it);
  * training: Adam steps on a feature pool (five on the bake, two on the
    tree walk), each re-pointing the tree, rendering with `render_persp`,
    taking an image loss plus a density prior through the point query
    `N3Tree.forward`, and calling `backward()`; one step runs inside
    `N3Tree.accumulate_weights()`;
  * aux serving: three frames of `construct_tree`, `render_persp`,
    `opacity_render`, `render_depth` and `motion_render` (with the CUDA
    reference's hit point: on the bake, one K6 lookup per frame);
  * aux training: Adam steps (five, two) over the pool and the joint
    features, each taking an image MSE of `render_persp`, an opacity mask
    loss of `opacity_render` and an MSE of `motion_feature_render`;
  * dynamic serving: `VolumeRenderer.render_dynamic_frames` over three
    poses of the leaf-centre cloud skinned to the skeleton (LBS warp,
    re-pointing, on the bake the box union and refresh, render with
    per-voxel rotations and first-hit depth), fast and exact, checked
    against the eager loop of the public calls, and `voxelize` of each
    frame's warped cloud into a 257^3 grid;
  * dynamic training: Adam steps (three, two) on a two-frame pool stack
    through `render_dynamic_frames`;
  * pose fit: three Adam steps on the joints' transforms through
    `warp_vertices` and `voxelize` (the two backward kernels);
  * bench.py's dynamic configuration: a 20,000-point Gaussian cloud on a
    depth-5 RGBA tree, four frames of `render_dynamic_frames`, timed as
    bench.py times them, on the default baked backend as bench.py renders
    (`dynamic_fused_frame_ms`, `dynamic_fast_frame_ms`; the fast frames
    regrow the skip boxes), and on the tree walk
    (`dynamic_fused_frame_tree_ms`, `dynamic_fast_frame_tree_ms`);
  * tree editing (`edit_path`): the corners of every leaf (the K8b
    calc_corners kernel), `N3Tree.set` at the leaf centres (assign), the
    point query with ``want_leaf_node`` (unique_leaf_nodes), each kernel
    equal to its plain version; then a weighted frame, `merge` of idle
    frontier nodes and `shrink_to_fit`, and `refine` of the leaves with
    the most weight, each edit re-baked and rendered exact on both
    backends, bit for bit equal;
  * trilinear interpolation: `VolumeRenderer(interp="trilinear")` on the
    aux scene, an exact and a fast frame, one training step (image, mask
    and motion-feature losses) with `backward()` inside
    `accumulate_weights()`, `render_depth` and `motion_render`, through
    the interp kernel instances only;
  * bf16 and int8 pools (`pool_path`): bench.py's deep serving on a bf16
    pool and on its `quantize_features` in pixel order (`deep9_noplan_ms`,
    `deep9_int8_noplan_ms`; `deep9_int8_max_err`), a bf16
    forward + backward (`fwd_bwd_bf16_ms`), a bf16 training step (opacity,
    motion features with bf16 joint features, point query), the aux
    passes on the int8 pool, one bf16 `render_dynamic_frames` call equal
    to the same call on the widened pool, and the same pools under
    interp, each through the pool instances;
  * recorded sample tapes (`tape_path`): three frames of
    `VolumeRenderer.render_persp_tape` (exact and fast) with the frames'
    pools, bit for bit equal to `render_persp`, and two Adam steps through
    `render_persp_tape` + `backward()`, one inside `accumulate_weights()`;
    then bench.py's tape keys beside the march on the same rays
    (`tape_record_ms`, `fwd_tape_ms`, `tape_fwd_bwd_seq_ms` on its
    depth-7 headline scene; `deep9_tape_ms`, `deep9_tape_mrays_s`,
    `deep9_tape_int8_mrays_s`);
  * temporal tapes (`dynamic_tape_path`): on the deep dynamic scene,
    `record_dynamic_persp` (a data-indirect tape against the animation's
    union occupancy, compacted and not), `render_dynamic_tape_frames`
    exact, fast and uncompacted with rotations and depth (K13c and K13f per
    frame), held to `render_dynamic_frames` (uncompacted bit for bit,
    compacted within 2e-6, depths bit for bit), a two-frame pool stack
    through `render_tape_frames` (float32, bf16 and int8: one launch of
    K13c's frame axis each, every frame equal to K13c bit for bit; the
    float32 and bf16 gradients, K13e, against per-frame K13d), a 3-view rig frame (`render_persp_rig_tape`) equal to
    `render_persp` per view; the host ms of a deep frame with the tape passed
    in and through the cache key; then bench.py's temporal keys
    (`dynamic_tape_record_s`, `dynamic_tape_record_warm_s`,
    `dynamic_tape_frame_ms`, `dynamic_tape_fast_frame_ms` on its dynamic
    cloud; `deep9_dyn_record_s`, `deep9_dyn_tape_frame_ms`,
    `deep9_dyn_tape_mrays_s` on its deep cloud; `tape_fwd_bwd_ms`,
    `tape_fwd_bwd_mrays_s`, a 16-frame stack's gradient) beside the march's;
  * minibatch tape training (phase 4n, `minibatch_path`, on bench.py's
    headline configuration: the depth-7 SH9 shell, step_size 1e-3, a
    4-view 800x800 rig at fx 880 recorded by `record_persp_rig`, targets
    the replay of the true pool, training from pool * 0.9 at lr 0.05):
    bench.py's keys `minibatch_source_s`, `minibatch_step_ms` and
    `minibatch_fwd_bwd_mrays_s` (32 steps of 65,536 ids from seed 7),
    `minibatch256k_*` (8 steps of 262,144), `tape_train_chain_step_ms`
    and `tape_train_chain_mrays_s` (`train_steps`, 8 steps on the
    640,000-ray tape), each the least of 3 calls with the next pack's
    prep overlapped; one random-batch SGD step through the march beside
    them; `train_minibatches` and `train_steps` held to eager chains of
    `replay_render_rows` / `replay_render`, autograd and f - lr * g, at
    lr 0.05 and at an lr that moves the pool visibly (the update itself);
  * the dense-grid weight pass (phase 4o): `grid_weight_render` on the
    depth-9 shell's 512^3 density grid through the 800x800 orbit camera
    (the occupancy pass and the march launch once each);
  * cost-ordered ray schedules (phase 4p, `plan_path`): three frames of
    `render_persp(schedule="cost")` (exact and fast; the first call of each
    mode makes its `plan_persp` plan, K15 on the block centres), a training
    step through the planned render, and `render_dynamic_frames(
    schedule="union")` on the deep dynamic scene, each equal to the tile
    order (pixel order) bit for bit, the gradient at the atomic tolerance;
    then bench.py's planning keys (`plan_times`): `plan_exact_ms`,
    `plan_fast_ms`, `plan_opaque_ms`, `plan_deep_ms`, `plan_block_ms`, the
    marches on cost-ordered rays as bench.py times them (`fwd_ms`,
    `fwd_march_mrays_s`, `fast_mode_ms`, `opaque_fast_ms`, `deep9_ms`,
    `deep9_int8_ms`), `fwd_march_blockplan_mrays_s`, `orbit32_planned_*` and
    `orbit32_cached_*`, and the planned exact march against pixel order in
    turns. The pixel-order marches are `fwd_march_noplan_ms` (phase 4l) and
    `deep9_noplan_ms` (phases 4k, 4l).

The two backends' exact outputs are checked equal bit for bit on every
serving path. Each path's launch counts are read from zero around it (and
the SH9 tape paths' forward and backward launches are all the vector
instance, as are the SH9 serving paths' forward-march launches: phases 4,
4e, 4k and the march keys of 4l). The forward march's widths 4 and 1 are
held bit for bit in phases 3, 3d and 3f (both structures, float32, bf16
and int8, exact and fast, with rotations and weights) at its callers' two
shapes: the deep camera and bench.py's depth-7 headline shell at fx 880
in pixel order. The redesigned kernels (K2, K13c and its frame axis, K13d,
K13e) are timed beside their width-1 instance in turns (K2's, K13d's and
K13e's the earlier design, K13c's the scalar row; `prev_ms` in the
kernels line), K2 also at the headline shape and with rotations, the
forward's frame axis also beside N single launches; ptxas's registers and
spills of the tape forward's and backward's instances and of K2's are
printed by width, K2's with their blocks an SM (no tape forward and no
nearest K2 instance may spill), and the census's samples per hitting ray
and 128-ray blocks are set against the resident blocks (`K2 waves`).
The trilinear march (K2+K4) has the same two widths: the SH9
interp launches on aligned pools must be width 4 too (phases 4j and 4k),
its width 4 is timed beside its width 1 in turns (`prev_ms`), and a census
line per structure gives the table loads of its lookups as the width-4
kernel makes them (the own corner's row reused, on the tree walk the own
path too), with the own row alone, and with 9 lookups from the root, and
its bound counted from the kernel's lookups (the kernels line's) and from
9 lookups (`K2+K4 census`, from `ops/corner_lookup.py`'s mirror over the
march's samples); phase 4m also
times a `record_dynamic_persp` call that hits the cache (D1's key). The
motion-feature march (K9c, K9d) has a vector instance, width 4 (the LBS
rows, the joint table and the output rows in 16-byte loads), which the
wrappers launch where the tables are aligned (`mf_width`), and the scalar
one, width 1: the aux training, interp and pool paths must launch only
width 4 (`check_mf_widths`); each phase that holds K9c or K9d against its
plain version holds width 1 too, on the same inputs; each instance is timed
at width 4 in turns against width 1 on the same tables (`prev_ms`), beside
the aux serving frame and training step of phases 4c-4d; ptxas's
registers and spills of each K9c and K9d instance are printed. The
first-hit march (K9b) prints a census line per structure, nearest and
interp (`K9b census`, from `ops/first_hit_path.py`'s mirror: the own
lookups' loads from the root against those of the designs that lost, the
tree walk's path-started descents and the bake's reused top and mid
entries, and under interp the lookups of 9 from the root against the
kernel's), and
its interp instances' bounds count the kernel's lookups, beside the bound
counting 9 (`K9b+K4 bound`); so do the opacity VJP's (`K9a+K4 bound`).
The query forward's and backward's launches are counted by unit, and the
training, pool and editing paths must launch only the widest unit their
SH9 pools allow (16 bytes float32, 8 bf16: `check_query_units`); phase 6
holds every other unit of those rows, and the generic instance, to the
plain version once, the backward on every leaf centre with a duplicated
tenth and on a tenth of them. The bake's three kernels (K6's lookup, K7a,
K7b) are timed in phase 6 by the profiler, kernels alone, L2 cold, beside
their wrapper calls (where a profiler session records none of a kernel's
launches, by CUDA events behind a busy stream, named in the kernels
line's ``timer``). construct_tree's time in phase 5 is given twice: CUDA events over back-to-back wrapper calls (the kernels line's
``ms``) and its kernels' device time alone (``device_ms``). It
prints kernel and plain-version times and each kernel's bound with the
card's name and power limit, the whole run's seconds, one JSON line
describing the kernels, and as its last line {"ok": true, "device":
{...}}. Any failed phase raises and the script exits nonzero. It needs a
CUDA GPU and does not fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import svox_t_tpu_torch as stt
from svox_t_tpu_torch import _build
from svox_t_tpu_torch.models import renderer as renderer_mod
from svox_t_tpu_torch.ops import bake as bake_ops
from svox_t_tpu_torch.ops import corner_lookup, first_hit_path
from svox_t_tpu_torch.ops import grid as grid_ops
from svox_t_tpu_torch.ops import p2v as p2v_ops
from svox_t_tpu_torch.ops import query as query_ops
from svox_t_tpu_torch.ops import render as render_ops
from svox_t_tpu_torch.ops import render_aux as aux_ops
from svox_t_tpu_torch.ops import schedule as sched_ops
from svox_t_tpu_torch.ops import tape as tape_ops
from svox_t_tpu_torch.ops import tape_subset as subset_ops
from svox_t_tpu_torch.ops import traversal
from svox_t_tpu_torch.ops import warp as warp_ops
from svox_t_tpu_torch.utils.scenes import (bench_deep_dynamic_cloud, bench_dynamic_cloud,
                                           build_opaque_tree, build_shell_tree, dense_density_grid,
                                           joint_pose_sequence, orbit_camera, random_lobes,
                                           skin_to_nearest_joints)

DEPTH = 9
WIDTH = HEIGHT = 800
FX = 1111.111
N_FRAMES = 3
N_STEPS = 5
# Training steps of the tree backend, which the default baked backend
# runs N_STEPS (DYN_STEPS) of: the tree walk is the second backend, and
# its steps are cut to keep the smoke's time.
N_TREE_STEPS = 2
BACKENDS = ("baked", "tree")  # the default first
N_LOOKUP_POINTS = 1 << 20
LR = 0.05
# Weight of the density prior (mean |sigma| at sampled leaf centres,
# through the point query) in the training loss; small beside the image
# loss.
PRIOR_WEIGHT = 1e-8
N_PRIOR_POINTS = 65536
RENDER_ATOL = 2e-5  # fma-free builds on both sides; covers expf ulps
ATOMIC_RTOL = 1e-5  # float atomics sum in another order: 1e-5 * max(1, max|plain|)
KERNEL_REPS = 10
# The aux path's skeleton, made from a seed: joint positions (the tree's
# extra_data), joint features, and per pool row N_BONES skinning weights
# and joint indices.
N_JOINTS = 32
JOINT_DIM = 16
N_BONES = 4
MASK_WEIGHT = 0.1  # weight of the opacity mask loss in the aux training loss
# The dynamic paths: the leaf centres skinned to the skeleton's N_BONES
# nearest joints, posed by `joint_pose_sequence`; a voxel grid at benchmarks/configs.py's
# config_5 ratios scaled to depth 9 (voxel ~2 leaves, k ~0.93 voxel, cr
# ~1.86 voxel). The sizes are the port's choice, not a published rig.
P2V_N, P2V_KR, P2V_CR = 257, 0.00363, 0.00727
DYN_TRAIN_FRAMES = 2
DYN_STEPS = 3
POSE_LR = 1e-4
WARP_ATOL = 1e-6  # the warp follows its plain version operation for operation
EXACT_RTOL = 1e-6  # deterministic sums in the plain version's order: 1e-6 * max(1, max|plain|)
BENCH_FX = 880.0  # bench.py: fx = W * 1.1
# The bound of a kernel: the larger of its bytes over the H100 SXM's HBM
# rate and its float32 operations over its peak non-tensor rate
# (NVIDIA's data sheet, at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations counted per unit of work for the bounds: a descent
# level (3 scalings, 3 floors, 3 clamps, 3 fraction subtractions); a
# sample's position, clamps, in-leaf DDA and step; and a contributing
# sample's own math in each kernel (SH9 colors, compositing, blends of
# N_BONES joint rows of JOINT_DIM, sigmoids as 3 operations).
OPS_LEVEL = 12
# The baked lookup per sample or point: clamps, the finest-grid floor, the
# cube, the scaled point, its floor and the fraction.
OPS_LOOKUP = 24
OPS_SAMPLE = 30
OPS_RAY = 40
OPS_FWD_SH9 = 75
OPS_BWD_SH9 = 115
OPS_OPACITY_BWD = 7
OPS_MF_FWD = 2 * N_BONES * JOINT_DIM + 5 * JOINT_DIM + 5
OPS_MF_BWD = 4 * N_BONES * JOINT_DIM + 7 * JOINT_DIM + 5
# The warp per point: a blend of nb rows of 12 (24 per bone) and the
# transform (18); its backward: G (24), dx (15), per bone dw (24) and the
# dT terms and adds (24). Voxelize, each term formed once where it
# varies: per point its window (two subtractions, a division, a rounding
# and two clamps, for each end of each axis: 36); per kept window index of
# an axis the centre, the offset and its square (4); per (x, y) row of the
# window dx^2 + dy^2 (1); per window voxel r^2 and its gate (2); per voxel
# within the radius an exp, a division and a product or atomic add (6)
# forward, and 17 backward.
OPS_WARP_FWD = 24 * N_BONES + 18
OPS_WARP_BWD = 39 + 48 * N_BONES
OPS_P2V_POINT = 36
OPS_P2V_AXIS = 4
OPS_P2V_ROW = 1
OPS_P2V_VOXEL = 2
OPS_P2V_FWD = 6
OPS_P2V_BWD = 17
# Trilinear interpolation (K4), per sample: the corner grid point, its
# floor and weights, the reciprocal, 24 corner coordinates (an add and a
# multiply each), 8 weight products and 8 sigma multiply-adds; per
# contributing SH9 sample: 8 corners' color dot products (3 x 9
# multiply-adds each) and their 3 x 8 weighted adds, the compositing as
# in nearest mode, and in the backward 8 corners' gradient rows (27
# products and adds each) and sigma column.
OPS_CORNERS = 96
OPS_FWD_SH9_INTERP = 8 * 54 + 48 + 21
OPS_BWD_SH9_INTERP = 8 * 54 + 48 + 8 * 54 + 16 + 10
OPS_OPACITY_BWD_INTERP = OPS_OPACITY_BWD + 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def atomic_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max|got - want|, checked against ATOMIC_RTOL * max(1, max|want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    bound = ATOMIC_RTOL * max(1.0, float(want.abs().max()) if want.numel() else 1.0)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel result")
    check(err <= bound, f"{what}: kernel vs plain {err} > {bound}")
    return err


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the device, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(new, old, timer) -> tuple:
    """(new ms, old ms): ``timer(fn)`` of an earlier design ``old`` and its
    redesign ``new`` in turns (old, new, new, old), each the mean of its
    two."""
    o1, n1, n2, o2 = timer(old), timer(new), timer(new), timer(old)
    return (n1 + n2) / 2, (o1 + o2) / 2


def mf_turns(spec, jf, pool, origins, dirs, opt, g_m=None) -> tuple:
    """(ms, width-1 ms) of K9c (K9d with the cotangent ``g_m``) in turns
    (`in_turns`): the vector instance (width 4) against the scalar one
    (width 1, the earlier kernel's reads) on the same inputs. K9c's two
    outputs must be equal bit for bit, K9d's gradients within ATOMIC_RTOL of
    each other (each is held against the plain version where its phase
    checks the kernel)."""
    if g_m is None:
        def run(w):
            return aux_ops.motion_feature_forward_cuda(spec, jf, pool, origins, dirs, opt, width=w)
    else:
        def run(w):
            return aux_ops.motion_feature_backward_cuda(spec, jf, pool, origins, dirs, g_m, opt, width=w)
    what = "mf_bwd" if g_m is not None else "mf_fwd"
    if g_m is None:
        check(torch.equal(run(4), run(1)), f"{what}: widths 4 and 1 differ")
    else:
        atomic_err(run(1), run(4), f"{what}: width 1 against width 4")
    return in_turns(lambda: run(4), lambda: run(1), lambda fn: time_ms(fn, KERNEL_REPS))


MF_TURNS = "its width-1 instance (the earlier kernel's reads)"


def mf_width_check(spec, jf, pool, origins, dirs, opt, out, want, g_m, want_g, what: str) -> tuple:
    """K9c's and K9d's width-1 instances (the scalar reads) on the inputs
    of a phase that holds their width-4 launches (``out`` and the gradient
    it compares) against the plain versions (``want``, ``want_g``): K9c
    equal to ``out`` bit for bit and within RENDER_ATOL of plain, K9d
    within ATOMIC_RTOL of plain. Returns (K9c's error, K9d's)."""
    m_1 = aux_ops.motion_feature_forward_cuda(spec, jf, pool, origins, dirs, opt, width=1)
    check(torch.equal(m_1, out), f"mf_fwd{what} width 1: not the width-4 output")
    err = float((m_1 - want).abs().max())
    check(err <= RENDER_ATOL, f"mf_fwd{what} width 1: kernel vs plain {err}")
    b_1 = aux_ops.motion_feature_backward_cuda(spec, jf, pool, origins, dirs, g_m, opt, width=1)
    return err, atomic_err(b_1, want_g, f"mf_bwd{what} width 1")


PROFILER_ATTEMPTS = 6


class ProfilerMissedKernel(AssertionError):
    """A `torch.profiler` session that, after every retry, recorded fewer
    launches of the kernels it was asked to time than were made; ``ms``:
    the mean device ms of those it recorded (None if none)."""

    def __init__(self, msg: str, ms=None):
        super().__init__(msg)
        self.ms = ms


def recorded_names(events) -> str:
    """The distinct names (cut to 60 characters) of a session's events, for
    a retry's message."""
    return ", ".join(sorted({e.name[:60] for e in events})) or "none"


def profiled_kernels(run, enough, what: str) -> list:
    """The device kernels (fills aside, in start order) of one
    `torch.profiler` session around ``run()``. A session at times comes
    back without some of its calls' device events (seen in phases 3h and
    4n on an H100, and once with no device event in three sessions in a
    row): one whose kernels fail ``enough`` is run again, after a pause of
    half a second a retry, at most PROFILER_ATTEMPTS - 1 times, and each
    retry is printed with ``what``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILER_ATTEMPTS):
        if attempt:
            print(f"profiler retry: {what}: {len(events)} device kernels recorded ({recorded_names(events)}); "
                  f"attempt {attempt + 1} of {PROFILER_ATTEMPTS}")
            time.sleep(0.5 * attempt)
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation and "FillFunctor" not in e.name),
                        key=lambda e: e.time_range.start)
        if enough(events):
            break
    return events


def paired_device_ms(new, old, names, pairs: int, cold: bool = True) -> list:
    """[(new ms, old ms)] of ``pairs`` rounds of calls in turns (old, new,
    new, old), each the mean of its round's two kernels, from one
    `torch.profiler` session (`profiled_kernels`): ``new`` launches one
    kernel whose name contains one of ``names``, ``old`` one kernel of
    another name (fills aside). ``cold`` as in `device_ms`."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda") if cold else None
    new()
    old()
    torch.cuda.synchronize()

    def run():
        for _ in range(pairs):
            for fn in (old, new, new, old):
                if cold:
                    flush.zero_()
                fn()

    def in_order(events):
        return [any(n in e.name for n in names) for e in events] == [False, True, True, False] * pairs

    events = profiled_kernels(run, in_order, f"in-turns profile of {names}")
    check(in_order(events),
          f"in-turns profile of {names}: {len(events)} kernels recorded, not {4 * pairs} in turns: "
          f"{sorted({e.name[:80] for e in events})}")
    ms = [e.time_range.elapsed_us() / 1e3 for e in events]
    return [((ms[4 * i + 1] + ms[4 * i + 2]) / 2, (ms[4 * i] + ms[4 * i + 3]) / 2) for i in range(pairs)]


def device_ms(fn, reps: int, names=None, cold: bool = True) -> float:
    """Device ms per call of ``fn``, from `torch.profiler`
    (`profiled_kernels`): the summed time of the kernels whose names
    contain one of ``names`` (None: every kernel but the L2 flush's fill),
    after one warm-up call. A kernel shorter than the host's dispatch of its call leaves the
    card idle between back-to-back calls, which CUDA events around them
    count (`time_ms`); this counts the kernels alone. ``cold``: a 128 MB
    write before each call evicts the 50 MB L2, so the kernel reads its
    inputs from HBM, as the bounds count them."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            if cold:
                flush.zero_()
            fn()

    def named(events):
        return [e for e in events if any(n in e.name for n in names)] if names else events

    events = named(profiled_kernels(run, lambda ev: len(named(ev)) >= reps, f"{names or 'every kernel'}"))
    if len(events) < reps:
        rec = sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(events) if events else None
        raise ProfilerMissedKernel(f"the profiler recorded {len(events)} of {reps} launches of a kernel named "
                                   f"{names}" + (f" (their mean {rec:.4f} ms)" if events else ""), rec)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


# The sleep that holds the stream busy while the host enqueues a call timed
# by `queued_ms` (about half a millisecond on an H100).
QUEUE_SLEEP_CYCLES = 1_000_000


def queued_ms(fn, reps: int, cold: bool = True) -> float:
    """Device ms per call of ``fn`` from CUDA events around each call alone,
    after one warm-up call: before each, a sleep kernel holds the stream
    busy while the host enqueues the events and the call, so no dispatch
    gap is counted (the kernels alone, as `device_ms` counts them, plus the
    events' own few microseconds). ``cold`` as in `device_ms`."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def kernel_alone_ms(fn, reps: int, names) -> tuple:
    """(ms, timer): a call's kernels alone, L2 cold: `device_ms` from the
    profiler, or where every profiler session comes back without the
    call's kernels (`ProfilerMissedKernel`: seen for `lookup_kernel` and
    `refresh_kernel` in phase 6 on an H100, though a fresh process records
    them, tools/profile_bake_kernels.py), `queued_ms` from CUDA events.
    Any other failure raises."""
    try:
        return device_ms(fn, reps, names), "profiler"
    except ProfilerMissedKernel as e:
        print(f"{e}; timed by CUDA events behind a busy stream instead")
        return queued_ms(fn, reps), "CUDA events behind a busy stream"


def timed_once_ms(fn):
    """(result, device ms) of one call, measured with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def random_rotations(M: int, rng: np.random.RandomState, device) -> torch.Tensor:
    """(M, 4, 4) float32 rotations from normalized random quaternions."""
    q = rng.randn(M, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    m = np.zeros((M, 4, 4), np.float32)
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y - z * w)
    m[:, 0, 2] = 2 * (x * z + y * w)
    m[:, 1, 0] = 2 * (x * y + z * w)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z - x * w)
    m[:, 2, 0] = 2 * (x * z - y * w)
    m[:, 2, 1] = 2 * (y * z + x * w)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    m[:, 3, 3] = 1
    return torch.from_numpy(m).to(device)


def seeded_pool(rng: np.random.RandomState, M: int, D: int, device) -> torch.Tensor:
    """A feature pool like the scene's: coefficients ~0.3, densities 10-40+."""
    f = (rng.randn(M, D) * 0.3).astype(np.float32)
    f[:, -1] = np.abs(rng.randn(M)).astype(np.float32) * 30.0 + 10.0
    return torch.from_numpy(f).to(device)


def camera_rays(device):
    c2w = torch.as_tensor(orbit_camera(), device=device)
    origins, dirs = render_ops.cam2world_rays(c2w, WIDTH, HEIGHT, FX, FX)
    return origins.contiguous(), dirs.contiguous()


COUNTERS = {
    "construct_tree": query_ops.CONSTRUCT_TREE,
    "render_fwd": render_ops.RENDER_FWD,
    "render_bwd": render_ops.RENDER_BWD,
    "query_fwd": query_ops.QUERY_FWD,
    "query_bwd": query_ops.QUERY_BWD,
    "opacity_bwd": aux_ops.OPACITY_BWD,
    "first_hit": aux_ops.FIRST_HIT,
    "mf_fwd": aux_ops.MF_FWD,
    "mf_bwd": aux_ops.MF_BWD,
    "warp_fwd": warp_ops.WARP_FWD,
    "warp_bwd": warp_ops.WARP_BWD,
    "voxelize_fwd": p2v_ops.VOXELIZE_FWD,
    "voxelize_bwd": p2v_ops.VOXELIZE_BWD,
    "render_fwd_baked": render_ops.RENDER_FWD_BAKED,
    "render_bwd_baked": render_ops.RENDER_BWD_BAKED,
    "opacity_bwd_baked": aux_ops.OPACITY_BWD_BAKED,
    "first_hit_baked": aux_ops.FIRST_HIT_BAKED,
    "mf_fwd_baked": aux_ops.MF_FWD_BAKED,
    "mf_bwd_baked": aux_ops.MF_BWD_BAKED,
    "bake_lookup": bake_ops.LOOKUP,
    "bake_refresh": bake_ops.REFRESH,
    "grow_boxes": bake_ops.GROW_BOXES,
    "points_aabb": query_ops.POINTS_AABB,
    "construct_tree_aabb": query_ops.CONSTRUCT_TREE_AABB,
    "assign": query_ops.ASSIGN,
    "unique_leaf": query_ops.UNIQUE_LEAF,
    "calc_corners": query_ops.CALC_CORNERS,
    "render_fwd_interp": render_ops.RENDER_FWD_INTERP,
    "render_bwd_interp": render_ops.RENDER_BWD_INTERP,
    "opacity_bwd_interp": aux_ops.OPACITY_BWD_INTERP,
    "first_hit_interp": aux_ops.FIRST_HIT_INTERP,
    "mf_fwd_interp": aux_ops.MF_FWD_INTERP,
    "mf_bwd_interp": aux_ops.MF_BWD_INTERP,
    "render_fwd_baked_interp": render_ops.RENDER_FWD_BAKED_INTERP,
    "render_bwd_baked_interp": render_ops.RENDER_BWD_BAKED_INTERP,
    "opacity_bwd_baked_interp": aux_ops.OPACITY_BWD_BAKED_INTERP,
    "first_hit_baked_interp": aux_ops.FIRST_HIT_BAKED_INTERP,
    "mf_fwd_baked_interp": aux_ops.MF_FWD_BAKED_INTERP,
    "mf_bwd_baked_interp": aux_ops.MF_BWD_BAKED_INTERP,
}
# The march kernels, each with its trilinear (K4) instances.
MARCH_KERNELS = ("render_fwd", "render_bwd", "opacity_bwd", "first_hit", "mf_fwd", "mf_bwd")
# K5: the march kernels' bf16 and int8 pool instances, by name
# (<kernel><structure suffix>_<pool>): every one for both pools but the
# backward and the opacity VJP, bf16 only (a quantized pool takes no
# gradient); and the bf16 point query.
POOL_KINDS = ("bf16", "i8")
POOL_INSTANCES = {
    "render_fwd": render_ops._FWD_INSTANCES, "render_bwd": render_ops._BWD_INSTANCES,
    "opacity_bwd": aux_ops._OPACITY_INSTANCES, "first_hit": aux_ops._FIRST_HIT_INSTANCES,
    "mf_fwd": aux_ops._MF_FWD_INSTANCES, "mf_bwd": aux_ops._MF_BWD_INSTANCES,
}
POOL_KERNELS = {f"{base}{sfx}_{kind}": inst[kind][i]
                for base, inst in POOL_INSTANCES.items() for kind in POOL_KINDS if kind in inst
                for i, sfx in enumerate(render_ops._STRUCT_SUFFIXES)}
COUNTERS.update(POOL_KERNELS)
COUNTERS.update(query_fwd_bf16=query_ops.QUERY_FWD_BF16, query_bwd_bf16=query_ops.QUERY_BWD_BF16)
# K13: the tape recorder on each structure (the one walk and its copy, and
# the earlier count and record walks), the replay per pool type.
TAPE_KERNELS = {
    "tape_stage": tape_ops.TAPE_STAGE, "tape_stage_baked": tape_ops.TAPE_STAGE_BAKED,
    "tape_copy": tape_ops.TAPE_COPY, "tape_copy_baked": tape_ops.TAPE_COPY_BAKED,
    "tape_count": tape_ops.TAPE_COUNT, "tape_count_baked": tape_ops.TAPE_COUNT_BAKED,
    "tape_record": tape_ops.TAPE_RECORD, "tape_record_baked": tape_ops.TAPE_RECORD_BAKED,
    "tape_replay_fwd": tape_ops.TAPE_REPLAY_FWD, "tape_replay_fwd_bf16": tape_ops.TAPE_REPLAY_FWD_BF16,
    "tape_replay_fwd_i8": tape_ops.TAPE_REPLAY_FWD_I8,
    "tape_replay_fwd_frames": tape_ops.TAPE_REPLAY_FWD_FRAMES,
    "tape_replay_fwd_frames_bf16": tape_ops.TAPE_REPLAY_FWD_FRAMES_BF16,
    "tape_replay_fwd_frames_i8": tape_ops.TAPE_REPLAY_FWD_FRAMES_I8, "tape_replay_bwd": tape_ops.TAPE_REPLAY_BWD,
    "tape_replay_bwd_bf16": tape_ops.TAPE_REPLAY_BWD_BF16,
    "tape_replay_bwd_frames": tape_ops.TAPE_REPLAY_BWD_FRAMES,
    "tape_replay_bwd_frames_bf16": tape_ops.TAPE_REPLAY_BWD_FRAMES_BF16,
    "tape_depth": tape_ops.TAPE_DEPTH,
}
COUNTERS.update(TAPE_KERNELS)
# K14 (minibatch tape training) and K12 (the dense-grid weight pass).
MB_KERNELS = {"subset_gather": subset_ops.SUBSET_GATHER, "l2_cotangent": subset_ops.L2_COTANGENT,
              "sgd_update": subset_ops.SGD_UPDATE, "grid_occupancy": grid_ops.GRID_OCCUPANCY,
              "grid_weight": grid_ops.GRID_WEIGHT}
COUNTERS.update(MB_KERNELS)
# K15, the ray schedules' cost walk, on each structure.
COUNTERS.update(march_cost=sched_ops.MARCH_COST, march_cost_baked=sched_ops.MARCH_COST_BAKED)
# bench.py's minibatch cell (bench.py:284-407): MB_VIEWS rig views; N_MB
# steps of B_MB ids, N_MB2 of B_MB2; train_steps' N_CHAIN steps; lr MB_LR.
# The eager-chain check runs N_EAGER steps of B_MB rays.
MB_VIEWS = 4
N_MB, B_MB = 32, 65536
N_MB2, B_MB2 = 8, 262144
N_CHAIN = 8
MB_LR = 0.05
K14C_PAIRS = 20  # rounds of K14c and pool.add_ in turns, L2 cold and warm each
N_EAGER = 4
LOSS_RTOL = 1e-6  # K14b's loss against plain and eager chains (relative)
# At bench.py's lr a step moves the features below float32 resolution, so
# the update itself is checked with an lr chosen at the first step to move
# the largest feature step to UPDATE_MOVE * max|f|, within UPDATE_RTOL of
# the eager chain's update relative to its largest entry.
UPDATE_MOVE = 1e-2
UPDATE_RTOL = 1e-3
# K12 per sample: the position (3), clamps and scale (9), floor and clamp
# (6), the fraction (3), the in-voxel DDA (18), the step (3) and the sigma
# test (1); per contributing sample the exp, weight and transmittance (6).
OPS_GRID_SAMPLE = 43
OPS_GRID_CONTRIB = 6
# Phase 3h's third K12 check: a seeded GRID_NAN_RESO^3 grid (not a multiple
# of the occupancy mask's brick) with NaN and -inf sigmas.
GRID_NAN_RESO = 100
# K15 per sample that changes the transmittance: the step's optical depth
# (two products), the exp as 3 operations and the new transmittance (1).
OPS_COST_STOP = 6
# K13e's stack in phases 3g and 5: N_STACK pools over the deep shell's tape.
N_STACK = 4
# Bytes of a pool element.
POOL_ELEM = {"f32": 4, "bf16": 2, "i8": 1}
# bench.py:100: frames per timed call of its sustained loops; bench.py:615:
# the seeded rays of its int8 error.
N_SUSTAIN = 4
INT8_ERR_RAYS = 8192


# Kernels that no main path launches, with the reason: each is held to its
# plain version and timed all the same.
OFF_PATH = {"points_aabb": "every re-point that keeps a box takes the fused construct_tree_aabb; "
                           "points_leaf_aabb's own kernel serves direct callers"}
for _k in ("tape_count", "tape_count_baked", "tape_record", "tape_record_baked"):
    OFF_PATH[_k] = ("record_tape walks each ray once (tape_stage, then tape_copy); the count and record "
                    "walks serve direct callers (count_samples_cuda, record_samples_cuda)")

# The kernel-name suffix and the label of each backend in the output.
SUFFIX = {"baked": "_baked", "tree": ""}
LABEL = {"baked": "baked, the default", "tree": "tree walk"}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_bake_counts(counts: dict, backend: str, n: int) -> None:
    """On the baked backend every re-point refreshes the bake with the
    points' leaf box (n times), the box from the fused re-point
    (construct_tree_aabb), never from a points_leaf_aabb call of its own;
    the tree walk launches no baked kernel and keeps no box."""
    if backend == "baked":
        check(counts["construct_tree_aabb"] == n and counts["bake_refresh"] == n and counts["points_aabb"] == 0,
              f"the bake refreshed {counts['bake_refresh']} times and its box grown "
              f"{counts['construct_tree_aabb']} times by the fused re-point ({counts['points_aabb']} "
              f"points_leaf_aabb calls), not {n}")
    else:
        check(not any(v for k, v in counts.items()
                      if "_baked" in k or k in ("bake_refresh", "points_aabb", "bake_lookup",
                                                "construct_tree_aabb")),
              "the tree backend launched a baked kernel")


def reset_counts() -> None:
    for k in COUNTERS.values():
        k.launches = 0
    for widths in (tape_ops.BWD_WIDTH_LAUNCHES, tape_ops.FWD_WIDTH_LAUNCHES, render_ops.FWD_WIDTH_LAUNCHES,
                   render_ops.MARCH_BWD_WIDTH_LAUNCHES, aux_ops.MF_FWD_WIDTH_LAUNCHES,
                   aux_ops.MF_BWD_WIDTH_LAUNCHES, query_ops.QUERY_FWD_UNIT_LAUNCHES,
                   query_ops.QUERY_BWD_UNIT_LAUNCHES):
        for w in widths:
            widths[w] = 0


def read_counts() -> dict:
    """Each counter's launches, and the tape replay's and the marches'
    launches by vector width: K13d / K13e's (``bwd_width_<w>``), K13c's and
    its frame axis's (``fwd_width_<w>``), K2's, nearest and interp
    (``march_width_<w>``), K3's, nearest and interp
    (``march_bwd_width_<w>``), and K9c's and K9d's (``mf_fwd_width_<w>``,
    ``mf_bwd_width_<w>``), all entry points, structures and pool types; and
    the query forward's by pool type and copy unit (``query_unit_f32_16``)
    and its backward's (``query_bwd_unit_f32_16``); and ``repoint``, the re-points: construct_tree's launches, box-free or
    fused with the points' leaf box (construct_tree_aabb)."""
    counts = {name: k.launches for name, k in COUNTERS.items()}
    counts.update({f"bwd_width_{w}": n for w, n in tape_ops.BWD_WIDTH_LAUNCHES.items()})
    counts.update({f"fwd_width_{w}": n for w, n in tape_ops.FWD_WIDTH_LAUNCHES.items()})
    counts.update({f"march_width_{w}": n for w, n in render_ops.FWD_WIDTH_LAUNCHES.items()})
    counts.update({f"march_bwd_width_{w}": n for w, n in render_ops.MARCH_BWD_WIDTH_LAUNCHES.items()})
    counts.update({f"mf_fwd_width_{w}": n for w, n in aux_ops.MF_FWD_WIDTH_LAUNCHES.items()})
    counts.update({f"mf_bwd_width_{w}": n for w, n in aux_ops.MF_BWD_WIDTH_LAUNCHES.items()})
    counts.update({f"query_unit_{u.replace(' ', '_')}": n for u, n in query_ops.QUERY_FWD_UNIT_LAUNCHES.items()})
    counts.update({f"query_bwd_unit_{u.replace(' ', '_')}": n for u, n in query_ops.QUERY_BWD_UNIT_LAUNCHES.items()})
    counts["repoint"] = counts["construct_tree"] + counts["construct_tree_aabb"]
    return counts


def check_query_units(counts: dict, what: str) -> None:
    """On an SH9 path (D = 28, contiguous pools) every query forward launch
    copies in the widest unit the row takes: 16 bytes for a float32 pool, 8
    for a bf16 one (`ops/query.py` `query_unit`); and every query backward
    launch moves the gradients in 16-byte units (float32) or 8-byte ones
    (bf16, 4 values), added as float4s (`query_bwd_unit`)."""
    for name, kind, unit in (("query_fwd", "f32", 16), ("query_fwd_bf16", "bf16", 8)):
        check(counts[f"query_unit_{kind}_{unit}"] == counts[name],
              f"{what}: {counts[name]} {name} launches, {counts[f'query_unit_{kind}_{unit}']} of them in "
              f"{unit}-byte units")
    for name, kind, unit in (("query_bwd", "f32", 16), ("query_bwd_bf16", "bf16", 8)):
        check(counts[f"query_bwd_unit_{kind}_{unit}"] == counts[name],
              f"{what}: {counts[name]} {name} launches, {counts[f'query_bwd_unit_{kind}_{unit}']} of them in "
              f"{unit}-byte units")


def check_bwd_widths(counts: dict, what: str) -> None:
    """On an SH9 path (D = 28, contiguous pools) every K13d and K13e launch
    is the 16-byte vector instance."""
    n_bwd = sum(counts[k] for k in ("tape_replay_bwd", "tape_replay_bwd_bf16", "tape_replay_bwd_frames",
                                     "tape_replay_bwd_frames_bf16"))
    check(n_bwd > 0 and counts["bwd_width_4"] == n_bwd,
          f"{what}: {n_bwd} tape backward launches, {counts['bwd_width_4']} of them the vector instance")


def check_fwd_widths(counts: dict, what: str) -> None:
    """On an SH9 path (D = 28, aligned pools) every launch of K13c and of
    its frame axis (every pool type) is the 16-byte vector instance."""
    n_fwd = sum(counts[k] for k in TAPE_KERNELS if k.startswith("tape_replay_fwd"))
    check(n_fwd > 0 and counts["fwd_width_4"] == n_fwd,
          f"{what}: {n_fwd} tape forward launches, {counts['fwd_width_4']} of them the vector instance")


def check_march_widths(counts: dict, what: str) -> None:
    """On an SH9 path (D = 28, aligned pools and rotations) every K2 launch,
    nearest and interp (K2+K4; either structure, every pool type), is the
    16-byte vector instance."""
    n = sum(v for k, v in counts.items() if k.startswith("render_fwd"))
    check(n > 0 and counts["march_width_4"] == n,
          f"{what}: {n} forward-march launches, {counts['march_width_4']} of them the vector instance")


def check_march_bwd_widths(counts: dict, what: str) -> None:
    """On an SH9 training path (D = 28, aligned pools and rotations) every
    K3 launch, nearest and interp (K3+K4; either structure, float32 and
    bf16 pools), is the 16-byte vector instance."""
    n = sum(v for k, v in counts.items() if k.startswith("render_bwd"))
    check(n > 0 and counts["march_bwd_width_4"] == n,
          f"{what}: {n} backward-march launches, {counts['march_bwd_width_4']} of them the vector instance")


def check_mf_widths(counts: dict, what: str) -> None:
    """On a path with the aux scene's LBS tables (4 bones, Kd 16, aligned
    tables and rows) every K9c and K9d launch (either structure, nearest
    and interp, every pool type) is the vector instance, width 4."""
    for name in ("mf_fwd", "mf_bwd"):
        n = sum(v for k, v in counts.items() if k.startswith(name) and "_width_" not in k)
        check(n > 0 and counts[f"{name}_width_4"] == n and counts[f"{name}_width_1"] == 0,
              f"{what}: {n} {name} launches, {counts[f'{name}_width_4']} of them the vector instance")


def k3_width_check(spec, pool, origins, dirs, g_out, opt, out_res, what: str) -> tuple:
    """K3 (K3+K4 under interp) at every width the row takes (4 and 1 for the
    three-colour rows with no spare column, `render_ops._fwd_width`; else 1),
    each launched by hand, against one call of its plain version on the same
    inputs: within ATOMIC_RTOL * max(1, max|plain|), and a gradient in the
    plain version's rows and no other. Returns (the worst error, the plain
    ms, the rows with a gradient, the widths)."""
    g_p, p_ms = timed_once_ms(lambda: render_ops.volume_render_backward_plain(
        spec, pool, origins, dirs, dirs, g_out, opt, out_res=out_res))
    rows = (g_p != 0).any(dim=1)
    widths = (4, 1) if render_ops._fwd_width(spec, pool, opt) == 4 else (1,)
    worst = 0.0
    for w in widths:
        g_k = render_ops.volume_render_backward_cuda(spec, pool, origins, dirs, dirs, g_out, opt,
                                                     out_res=out_res, width=w)
        worst = max(worst, atomic_err(g_k, g_p, f"render_bwd {what} width {w}"))
        check(torch.equal((g_k != 0).any(dim=1), rows), f"render_bwd {what} width {w}: rows with a gradient differ")
        del g_k
    n_rows = int(rows.sum())
    check(n_rows > 0, f"render_bwd {what}: zero gradient")
    return worst, p_ms, n_rows, widths


# ptxas's lines in the build log: a kernel's entry and its registers and spills.
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_USED = re.compile(r"Used (\d+) registers")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# The tape replay's kernel instances (K13c: fwd; K13d / K13e: bwd): format,
# basis capacity, rotation, width.
REPLAY_INSTANCE = re.compile(r"replay_(fwd|bwd)_kernel(?:_wide)?ILi(\d+)ELi(\d+)ELb([01])ELi(\d+)E")
# K2's kernel instances: structure, format, basis capacity, rotation,
# weights, width.
MARCH_INSTANCE = re.compile(
    r"render_fwd_kernel(?:_wide)?IN4svox\d+(TreeWalk|Baked)ELi(\d+)ELi(\d+)ELb([01])ELb([01])ELi(\d+)E")
# K3's kernel instances: structure, format, basis capacity, rotation, width.
BWD_INSTANCE = re.compile(r"render_bwd_kernelIN4svox\d+(TreeWalk|Baked)ELi(\d+)ELi(\d+)ELb([01])ELi(\d+)E")
# K9c and K9d: (kernel, Kd capacity, vector instance).
MF_INSTANCE = re.compile(r"(mf_fwd|mf_bwd)_kernel(?:_7)?ILi(\d+)ELb([01])E")
# An H100 SM: 65,536 registers (allocated per warp in units of 256, so a
# thread's count rounds up to a multiple of 8) and 2,048 threads.
SM_REGISTERS, SM_THREADS, N_SMS = 65536, 2048, 132


def blocks_per_sm(regs: int, threads: int = 128) -> int:
    """Resident blocks of ``threads`` threads an SM holds at ``regs``
    registers a thread (no shared memory)."""
    return min(SM_THREADS // threads, SM_REGISTERS // (-(-regs // 8) * 8 * threads))


def ptxas_summary(log: str) -> dict:
    """Print the registers and spills of the tape forward's and backward's
    instances, of K2's and of K3's by vector width (each compile unit: the
    range over formats and bases, and the SH9 instances with their blocks an
    SM), of K9c's and K9d's by Kd capacity and of K14c's, from the build
    log. Fails if a tape forward instance or a nearest K2 instance spills.
    Returns {(K2 or K3 unit, width): registers of its plain SH9 instance (no
    rotation, no weights)} and {(render_aux unit, "mf_fwd" or "mf_bwd"):
    registers of its JOINT_DIM vector instance}."""
    unit, entry, spill = None, None, None
    rows = []
    for line in log.splitlines():
        if line.startswith("== "):
            unit = line[3:].split(" (")[0]
        elif (m := PTXAS_ENTRY.search(line)):
            entry = m.group(1)
        elif (m := PTXAS_SPILL.search(line)):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := PTXAS_USED.search(line)) and entry is not None:
            rows.append((unit, entry, int(m.group(1)), spill or 0))
            entry = spill = None
    fwd_spill = fwd_n = 0
    for u in sorted({r[0] for r in rows if r[0] and "tape_replay_" in r[0]}):
        for w in (1, 4):
            got = [(r[2], r[3], b_) for r in rows if r[0] == u
                   for b_ in [REPLAY_INSTANCE.search(r[1])] if b_ and int(b_.group(5)) == w]
            if not got:
                continue
            sh9 = [f"{'rot ' if b_.group(4) == '1' else ''}{r_} regs, {sp} B spilled" for r_, sp, b_ in got
                   if b_.group(2) == "1" and b_.group(3) == "9"]
            where = "the row in registers, n_color 3" if w > 1 else "scalar"
            if got[0][2].group(1) == "fwd":
                fwd_n += len(got)
                fwd_spill += sum(g[1] for g in got)
            print(f"  ptxas {u} width {w} ({where}): {len(got)} instances, {min(g[0] for g in got)}-"
                  f"{max(g[0] for g in got)} registers, {sum(g[1] for g in got)} bytes spilled in all; SH9: "
                  + "; ".join(sh9))
    if log:
        check(fwd_n > 0 and fwd_spill == 0, f"ptxas: {fwd_n} tape forward instances, {fwd_spill} bytes spilled")
    for r in rows:
        if r[0] and "tape_subset" in r[0] and "sgd_f32_kernel" in r[1]:
            print(f"  ptxas {r[0]} {r[1]}: {r[2]} registers, {r[3]} bytes spilled")
    march_spill = march_n = 0
    sh9_regs = {}
    for u in sorted({r[0] for r in rows if r[0] and r[0].startswith("render_fwd")}):
        for w in (1, 4):
            got = [(r[2], r[3], m) for r in rows if r[0] == u
                   for m in [MARCH_INSTANCE.search(r[1])] if m and int(m.group(6)) == w]
            if not got:
                continue
            sh9 = []
            for r_, sp, m in got:
                if m.group(2) == "1" and m.group(3) == "9":
                    sh9.append(f"{'rot ' if m.group(4) == '1' else ''}{'weights ' if m.group(5) == '1' else ''}"
                               f"{r_} regs ({blocks_per_sm(r_)} blocks/SM), {sp} B spilled")
                    if m.group(4) == m.group(5) == "0":
                        sh9_regs[u, w] = r_
            if "_interp" not in u:
                march_n += len(got)
                march_spill += sum(g[1] for g in got)
            where = "the row in registers, n_color 3" if w > 1 else "scalar"
            print(f"  ptxas {u} width {w} ({where}): {len(got)} instances, {min(g[0] for g in got)}-"
                  f"{max(g[0] for g in got)} registers, {sum(g[1] for g in got)} bytes spilled in all; SH9: "
                  + "; ".join(sh9))
    if log:
        check(march_n > 0 and march_spill == 0,
              f"ptxas: {march_n} nearest K2 instances, {march_spill} bytes spilled")
    # K3 and K3+K4 by width: the SH9 instances' registers and spills.
    for u in sorted({r[0] for r in rows if r[0] and r[0].startswith("render_bwd")}):
        for w in (1, 4):
            got = [(r[2], r[3], m) for r in rows if r[0] == u
                   for m in [BWD_INSTANCE.search(r[1])] if m and int(m.group(5)) == w]
            if not got:
                continue
            sh9 = []
            for r_, sp, m in got:
                if m.group(2) == "1" and m.group(3) == "9":
                    sh9.append(f"{'rot ' if m.group(4) == '1' else ''}{r_} regs ({blocks_per_sm(r_)} blocks/SM), "
                               f"{sp} B spilled")
                    if m.group(4) == "0":
                        sh9_regs[u, w] = r_
            where = "the row in registers, vector atomics" if w > 1 else "scalar"
            print(f"  ptxas {u} width {w} ({where}): {len(got)} instances, {min(g[0] for g in got)}-"
                  f"{max(g[0] for g in got)} registers, {sum(g[1] for g in got)} bytes spilled in all; SH9: "
                  + "; ".join(sh9))
    # K9c and K9d by Kd capacity; the main path's is 16.
    for u in sorted({r[0] for r in rows if r[0] and r[0].startswith("render_aux")}):
        got = [(m.group(1), int(m.group(2)), m.group(3) == "1", r[2], r[3]) for r in rows if r[0] == u
               for m in [MF_INSTANCE.search(r[1])] if m]
        for name, kd, vec, r_, sp in got:
            if kd == JOINT_DIM and vec:
                sh9_regs[u, name] = r_
        print(f"  ptxas {u} K9c, K9d (Kd capacity, V: the vector instance: registers, bytes spilled): "
              + "; ".join(f"{name}<{kd}{', V' if vec else ''}> {r_}, {sp}" for name, kd, vec, r_, sp in sorted(got)))
    return sh9_regs


def k2_width_check(cases, what: str) -> int:
    """K2's width 4 (the row in vectors; on the bake with a float32 pool the
    next lookup ahead) against its width 1 (the earlier loop) bit for bit:
    each (label, spec, pool, renderer, origins, dirs) of ``cases``, exact
    and fast, without and with weights (those at the atomic tolerance),
    both widths launched by hand.
    Returns the number of comparisons."""
    n = 0
    with torch.no_grad():
        for label, spec, pool, rend, o, d in cases:
            for fast in (False, True):
                opt = rend._get_options(fast)
                for weights in (False, True):
                    got = [render_ops.volume_render_with_weight_accum_cuda(spec, pool, o, d, d, opt, width=w)
                           if weights else (render_ops.volume_render_cuda(spec, pool, o, d, d, opt, width=w), None)
                           for w in (4, 1)]
                    mode = f"{what} {label} {'fast' if fast else 'exact'}{' weights' if weights else ''}"
                    check(torch.equal(got[0][0], got[1][0]), f"render_fwd {mode}: widths 4 and 1 differ")
                    if weights:
                        atomic_err(got[0][1], got[1][1], f"render_fwd {mode}: width 4 weights vs width 1")
                    n += 1
    return n


def skeleton(rng: np.random.RandomState, M: int, device):
    """(joints (N_JOINTS, 3) inside the shell, joint features
    (N_JOINTS, JOINT_DIM), skinning weights (M, N_BONES) whose rows sum to
    1 with some bones 0, joint indices (M, N_BONES) int32)."""
    joints = (0.3 + 0.4 * rng.rand(N_JOINTS, 3)).astype(np.float32)
    jf = rng.randn(N_JOINTS, JOINT_DIM).astype(np.float32)
    w = rng.rand(M, N_BONES).astype(np.float32)
    w[w < 0.25] = 0.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-6)
    ji = rng.randint(0, N_JOINTS, (M, N_BONES)).astype(np.int32)
    return joints, torch.from_numpy(jf).to(device), torch.from_numpy(w).to(device), \
        torch.from_numpy(ji).to(device)


def _lookup_loads(spec, pos, cells, cells_fh, mark, mark_fh):
    """The leaves of the lookups at ``pos`` and each one's table loads: on
    the tree its descent levels, on a bake its top entry and, under a
    brick pointer, its brick (and mid) entry. Marks the entries that the
    ``mark`` and ``mark_fh`` lookups touch in ``cells`` and ``cells_fh``."""
    leaf = render_ops._locate(spec, pos)
    if isinstance(spec, bake_ops.BakedTree):
        p = traversal.clamp_coord(pos)
        R = spec.R
        tc = torch.clamp((p * R).to(torch.int32), max=R - 1)
        top = (tc[:, 0] * R + tc[:, 1]) * R + tc[:, 2]
        deep = leaf.node_flat >= spec.top.numel()
        levels = 1.0 + deep.double() + (leaf.node_flat >= spec.top.numel() + spec.n_mid).double() * (
            spec.mid is not None)
        for marks, m in ((cells, mark), (cells_fh, mark_fh)):
            marks[top[m].long()] = True
            marks[leaf.node_flat[m & deep].long()] = True
    else:
        levels = torch.round(torch.log2(leaf.cube_sz) / float(np.log2(spec.N))).double()
        cells[leaf.node_flat[mark].long()] = True
        cells_fh[leaf.node_flat[mark_fh].long()] = True
    return leaf, levels


def march_census(spec, feats, origins, dirs, opt) -> dict:
    """What this run's data makes a march do, under the forward's rules
    with exact options: rays that hit, samples, lookups and their table
    loads, contributing samples and the distinct rows and structure
    entries they touch; the same up to each ray's first hit. On the tree
    a lookup's loads are its descent levels and an entry is a leaf cell
    (a child and a data entry); on a bake the rays are culled as its
    march culls them, a lookup loads its top entry and, under a brick
    pointer, its brick entry, and an entry is one int32 of the tables.
    In nearest mode a sample makes one lookup and contributes where its
    own row is resident and its sigma > 0; ``rows`` counts those rows.
    Under ``opt.interp`` (K4) no ray is culled, a sample makes 9 lookups
    (its own and its 8 corners') and contributes where the corners' sigma
    is > 0: ``rows`` counts the corner rows of contributing samples (whose
    colors the march reads), ``rows_sigma`` the corner rows whose sigma it
    reads, ``own_rows`` the own rows of contributing samples that have one
    (the LBS rows), and the first hit is the first contributing sample
    with an own row, ``rows_fh`` the corner rows read up to it; ``k4_loads``
    counts the table loads of K2+K4's lookups as its width-4 kernel makes
    them (`ops/corner_lookup.py`'s mirror: the own lookup and the 7 other
    corners, reusing the own row and, on the tree walk, the own path),
    ``k4_lookups`` those lookups, ``k4_loads_own`` the loads with the own row
    alone reused, ``k4_loads_root`` of 9 lookups from the root (a tree
    walk's load is a child-table level or its data entry, one data entry a
    lookup; a bake's a table entry); ``contrib_corners`` counts the
    contributing samples' corners that have a row (each takes the sample's
    gradient row, K3+K4; in nearest mode it is ``contrib``). Only the bounds and the census
    lines read it. Per ray (K2's one-wave question): the samples of each
    ray that marches (max, p99) and of each hitting ray, one with a
    contributing sample (max, p99, median), and the 128-ray blocks (K2's)
    that hold a marching or a hitting ray."""
    baked = isinstance(spec, bake_ops.BakedTree)
    o, d, invdir, _, tmin, tmax, hit = render_ops._ray_setup(spec, origins, dirs, opt)
    M = feats.shape[0]
    n_cells = spec.src_map.numel() if baked else spec.data_flat.numel()
    dev = origins.device
    cells, cells_fh = (torch.zeros(n_cells, dtype=torch.bool, device=dev) for _ in range(2))
    # One more slot than rows: M marks "no row".
    rows, rows_sigma, own, rows_fh = (torch.zeros(M + 1, dtype=torch.bool, device=dev) for _ in range(4))
    n = {k: torch.zeros((), dtype=torch.float64, device=dev)
         for k in ("samples", "levels", "contrib", "fh_samples", "fh_levels", "k4_loads", "k4_lookups",
                   "k4_loads_own", "k4_loads_root", "contrib_corners")}
    t, active, searching = tmin, hit.clone(), hit.clone()
    per_ray = torch.zeros(origins.shape[0], dtype=torch.int32, device=dev)
    hits_ray = torch.zeros(origins.shape[0], dtype=torch.bool, device=dev)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        per_ray += active.int()
        fh = searching & active
        pos = render_ops.sample_position(o, t, d)
        leaf, levels = _lookup_loads(spec, pos, cells, cells_fh, active, fh)
        dt = render_ops._step(leaf, invdir, opt.step_size, 0)
        idx = leaf.data_idx
        res = (idx >= 0) & (idx < M)
        own_row = torch.where(res, idx, M).long()
        if opt.interp:
            points, w = render_ops.corner_points(pos, leaf.cube_sz)
            # K2+K4's table loads (corner_lookup's mirror of its lookups):
            # the width-4 kernel's, with lever 1 alone, and 9 from the root.
            cl = corner_lookup.corner_lookups(spec, pos[active], leaf.cube_sz[active])
            n["k4_loads"] += cl.loads.sum()
            n["k4_lookups"] += cl.lookups.sum()
            n["k4_loads_own"] += cl.loads_own.sum()
            n["k4_loads_root"] += cl.loads_root.sum()
            sigma = torch.zeros_like(t)
            sample_rows = []
            for p_c, w_c in zip(points, w):
                leaf_c, lv_c = _lookup_loads(spec, p_c, cells, cells_fh, active, fh)
                levels = levels + lv_c
                r_c = leaf_c.data_idx
                ok = (r_c >= 0) & (r_c < M)
                r_c = torch.where(ok, r_c, M).long()
                sigma = sigma + torch.where(ok, w_c * feats[torch.clamp(r_c, max=M - 1), -1], 0.0)
                sample_rows.append(r_c)
            contrib = active & (sigma > 0)
            fh_read = fh
        else:
            sigma = torch.where(res, feats[torch.clamp(own_row, max=M - 1), -1], 0.0)
            sample_rows = [own_row]
            contrib = active & res & (sigma > 0)
            fh_read = fh & contrib
        for r in sample_rows:
            rows_sigma[r[active]] = True
            rows[r[contrib]] = True
            rows_fh[r[fh_read]] = True
            n["contrib_corners"] += (r[contrib] < M).sum()
        own[own_row[contrib]] = True
        hits_ray |= contrib
        n["samples"] += active.sum()
        n["levels"] += levels[active].sum()
        n["contrib"] += contrib.sum()
        n["fh_samples"] += fh.sum()
        n["fh_levels"] += levels[fh].sum()
        searching = searching & ~(contrib & res)
        t = torch.where(active, t + dt, t)
        active = active & (t < tmax)
    out = {k: int(v.item()) for k, v in n.items()}
    out.update(rays=origins.shape[0], hits=int(hit.sum()), cells=int(cells.sum()),
               rows=int(rows[:M].sum()), cells_fh=int(cells_fh.sum()), rows_fh=int(rows_fh[:M].sum()),
               rows_sigma=int(rows_sigma[:M].sum()), own_rows=int(own[:M].sum()),
               lookups=(9 if opt.interp else 1) * out["samples"], baked=baked, interp=bool(opt.interp))
    marching = per_ray > 0
    n_blocks = -(-origins.shape[0] // 128)

    def blocks(mask):
        padded = torch.zeros(n_blocks * 128, dtype=torch.bool, device=dev)
        padded[:mask.numel()] = mask
        return int(padded.view(n_blocks, 128).any(1).sum())

    def q(x, p_):
        return int(torch.quantile(x.double(), p_)) if x.numel() else 0

    s_m, s_h = per_ray[marching], per_ray[hits_ray]
    out.update(marching=int(marching.sum()), hitting=int(hits_ray.sum()),
               samples_max=int(s_m.max()) if s_m.numel() else 0, samples_p99=q(s_m, 0.99),
               samples_hit_max=int(s_h.max()) if s_h.numel() else 0, samples_hit_p99=q(s_h, 0.99),
               samples_hit_median=q(s_h, 0.5), blocks=n_blocks, blocks_marching=blocks(marching),
               blocks_hit=blocks(hits_ray))
    return out


def skip_exits(spec, feats, origins, dirs, opt) -> int:
    """Samples of a march on a bake, up to each ray's first sample with
    density, whose leaf is a skip-box code of nonzero extent: samples
    that the march steps across a skip box. Only a check reads it."""
    skip_base = render_ops.effective_skip_base(spec, opt)
    o, d, invdir, _, tmin, tmax, hit = render_ops._ray_setup(spec, origins, dirs, opt)
    M = feats.shape[0]
    t, active = tmin, hit.clone()
    n = torch.zeros((), dtype=torch.int64, device=origins.device)
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        leaf = render_ops._locate(spec, render_ops.sample_position(o, t, d))
        idx = leaf.data_idx
        bits = idx - skip_base
        n += (active & (bits > 0) & (bits < bake_ops._SKIP_BITS_SPAN)).sum()
        res = (idx >= 0) & (idx < M)
        sigma = torch.where(res, feats[torch.where(res, idx, 0).long(), -1], 0.0)
        t = torch.where(active, t + render_ops._step(leaf, invdir, opt.step_size, skip_base), t)
        active = active & ~(res & (sigma > 0)) & (t < tmax)
    return int(n)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bounds(work: dict) -> dict:
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        ms, by = bound(n_bytes, n_ops)
        out[name] = dict(bound_ms=ms, bound_by=by, bound_bytes=n_bytes, bound_ops=n_ops)
    return out


def march_bounds(c: dict, M: int, D: int, kind: str = "f32") -> dict:
    """bound_ms and bound_by of the march kernels at the main path's
    shapes, from the census `c` of the SH9 camera march on one structure
    (the tree's kernels, or with ``c["baked"]`` their baked instances),
    for a pool of type ``kind`` (K5: the instances named with _bf16 or
    _i8; a pool value is 4, 2 or 1 bytes, and an int8 pool adds its scale
    and zero, 8 bytes a column). Each input is read once and each output
    written once: rays 12 bytes per vector; a march reads the rows and
    structure entries that its samples touch (a tree cell is a child and a
    data entry, 8 bytes; a baked entry 4); gradients of the pool are
    float32 (M, D) outputs whatever its type."""
    B, R, C = c["rays"], c["rows"], c["cells"]
    e, q = POOL_ELEM[kind], 8 * D if kind == "i8" else 0
    psfx = "" if kind == "f32" else "_" + kind
    if c["baked"]:
        cell_b, sfx = 4, "_baked"
        march_ops = OPS_RAY * c["hits"] + (OPS_LOOKUP + OPS_SAMPLE) * c["samples"]
        fh_ops = OPS_RAY * c["hits"] + (OPS_LOOKUP + OPS_SAMPLE) * c["fh_samples"]
    else:
        cell_b, sfx = 8, ""
        march_ops = OPS_RAY * c["hits"] + OPS_LEVEL * c["levels"] + OPS_SAMPLE * c["samples"]
        fh_ops = OPS_RAY * c["hits"] + OPS_LEVEL * c["fh_levels"] + OPS_SAMPLE * c["fh_samples"]
    lbs_row = e + N_BONES * 8  # sigma, skinning weights and joint indices
    jtab = N_JOINTS * JOINT_DIM * 4
    return _bounds({k + psfx: v for k, v in {
        "render_fwd" + sfx: (B * 36 + B * 16 + R * D * e + q + C * cell_b,
                             march_ops + OPS_FWD_SH9 * c["contrib"]),
        "render_bwd" + sfx: (B * 36 + 2 * B * 16 + R * D * e + q + C * cell_b + M * D * 4,
                             march_ops + OPS_BWD_SH9 * c["contrib"]),
        "opacity_bwd" + sfx: (B * 24 + 2 * B * 4 + R * e + q + C * cell_b + M * D * 4,
                              march_ops + OPS_OPACITY_BWD * c["contrib"]),
        "first_hit" + sfx: (B * 24 + c["rows_fh"] * e + q + c["cells_fh"] * cell_b + B * 21, fh_ops),
        "mf_fwd" + sfx: (B * 24 + R * lbs_row + q + C * cell_b + jtab + B * JOINT_DIM * 4,
                         march_ops + OPS_MF_FWD * c["contrib"]),
        "mf_bwd" + sfx: (B * 24 + B * JOINT_DIM * 4 + R * lbs_row + q + C * cell_b + 2 * jtab,
                         march_ops + OPS_MF_BWD * c["contrib"]),
    }.items()})


def interp_bounds(c: dict, M: int, D: int, kind: str = "f32", nine: bool = False) -> dict:
    """bound_ms and bound_by of the six trilinear (K4) march instances on
    one structure, from its interp `march_census` ``c``, as `march_bounds`
    counts them (a pool of type ``kind`` as there): the sigma of every
    corner row read, the rest of the rows of contributing samples'
    corners, the LBS tables of their own rows; a lookup's ops per
    child-table level on the tree (OPS_LEVEL) and per lookup on the bake
    (OPS_LOOKUP), plus OPS_CORNERS per sample. The lookups are those the
    kernels make: the forward's (K2+K4), the backward's (K3+K4), the
    opacity VJP's (K9a+K4) and the motion-feature passes' (K9c+K4, K9d+K4),
    which find their corners as K2+K4 does at width 4 (``k4_loads``,
    ``k4_lookups``; on the tree walk its child-table levels are its loads
    less one data load a lookup), or with ``nine`` 9 from the root as well,
    as the earlier kernels made them. K9b+K4 (`first_hit`) counts the
    lookups its kernel makes up to each ray's first hit (``k9b_loads``,
    ``k9b_lookups`` from `ops/first_hit_path.py`'s census: the own lookup
    and the corners as K2+K4 finds them), or with ``nine`` 9 from the root,
    as the earlier kernel made them."""
    B = c["rays"]
    e, q = POOL_ELEM[kind], 8 * D if kind == "i8" else 0
    psfx = "" if kind == "f32" else "_" + kind
    if c["baked"]:
        cell_b, sfx = 4, "_baked_interp"
        look_ops, fh_look = OPS_LOOKUP * c["lookups"], OPS_LOOKUP * 9 * c["fh_samples"]
        fwd_look = OPS_LOOKUP * c["k4_lookups"]
        if not nine:
            fh_look = OPS_LOOKUP * c["k9b_lookups"]
    else:
        cell_b, sfx = 8, "_interp"
        look_ops, fh_look = OPS_LEVEL * c["levels"], OPS_LEVEL * c["fh_levels"]
        fwd_look = OPS_LEVEL * (c["k4_loads"] - c["k4_lookups"])
        if not nine:
            fh_look = OPS_LEVEL * (c["k9b_loads"] - c["k9b_lookups"])
    march_ops = OPS_RAY * c["hits"] + look_ops + (OPS_SAMPLE + OPS_CORNERS) * c["samples"]
    k4_ops = march_ops if nine else march_ops - look_ops + fwd_look
    fh_ops = OPS_RAY * c["hits"] + fh_look + (OPS_SAMPLE + OPS_CORNERS) * c["fh_samples"]
    rows_b = c["rows_sigma"] * e + c["rows"] * (D - 1) * e + q
    sig_b = c["rows_sigma"] * e + q
    table_b = c["cells"] * cell_b
    lbs_b = c["own_rows"] * N_BONES * 8
    jtab = N_JOINTS * JOINT_DIM * 4
    return _bounds({k + psfx: v for k, v in {
        "render_fwd" + sfx: (B * 36 + B * 16 + rows_b + table_b,
                             k4_ops + OPS_FWD_SH9_INTERP * c["contrib"]),
        "render_bwd" + sfx: (B * 36 + 2 * B * 16 + rows_b + table_b + M * D * 4,
                             k4_ops + OPS_BWD_SH9_INTERP * c["contrib"]),
        "opacity_bwd" + sfx: (B * 24 + 2 * B * 4 + sig_b + table_b + M * D * 4,
                              k4_ops + OPS_OPACITY_BWD_INTERP * c["contrib"]),
        "first_hit" + sfx: (B * 24 + c["rows_fh"] * e + q + c["cells_fh"] * cell_b + B * 21, fh_ops),
        "mf_fwd" + sfx: (B * 24 + sig_b + lbs_b + table_b + jtab + B * JOINT_DIM * 4,
                         k4_ops + OPS_MF_FWD * c["contrib"]),
        "mf_bwd" + sfx: (B * 24 + B * JOINT_DIM * 4 + sig_b + lbs_b + table_b + 2 * jtab,
                         k4_ops + OPS_MF_BWD * c["contrib"]),
    }.items()})


def k9b_census_line(c: dict, label: str, card: str) -> str:
    """The `K9b census` line of `first_hit_path.first_hit_census`'s counts
    on one structure: the own lookups' loads from the root (the shipped
    kernel's) against those of the designs that lost (`tools/first_hit_ab.py`:
    the tree walk's path-started descents, ``path``; the bake's samples in
    their previous top or mid cell, ``top``), and under interp the lookups
    of 9 from the root against the kernel's (`corners_keep`)."""
    s = max(c["samples"], 1)
    line = (f"K9b census ({label}{', interp' if c['interp'] else ''}): {c['hits']} rays hit the cube, "
            f"{c['found']} found, {c['samples']} samples; own lookups' loads from the root {c['root_loads']} "
            f"({c['root_loads'] / s:.3f} a sample)")
    if c["baked"]:
        line += (f"; in the previous top cell (the top design's reuse) {c['same_top'] / s:.3f} of the "
                 f"samples, mid cell {c['same_mid'] / s:.3f}")
    else:
        line += (f"; the path design's, started on the previous sample's path, {c['path_loads']} "
                 f"({c['path_loads'] / s:.3f}; {c['root_loads'] / max(c['path_loads'], 1):.3f}x fewer)")
    if c["interp"]:
        line += (f"; lookups a sample: 9 from the root ({c['loads_9'] / s:.3f} loads), the kernel's "
                 f"{c['lookups_keep'] / s:.3f} ({c['loads_keep'] / s:.3f} loads)")
    return line + f" [{card}]"


def query_fwd_work(Q: int, M: int, D: int, itemsize: int, q_levels: int) -> tuple:
    """(bytes, operations) of the query forward on Q points that descend
    q_levels levels in all: each point (12 bytes) and its leaf's child and
    data entries (8) in, at most min(Q, M) rows of D values of itemsize
    bytes in, the (Q, D) values and the two (Q,) id columns out."""
    return (Q * 12 + Q * 8 + min(Q, M) * D * itemsize + Q * D * itemsize + Q * 8, OPS_LEVEL * q_levels)


def kernel_bounds(M: int, D: int, n_cells: int, Q: int, q_levels: int, e: dict) -> dict:
    """bound_ms and bound_by of the point kernels for Q points that
    descend q_levels levels in all (construct_tree, query and
    points_leaf_aabb, which reads the child table and writes 24 bytes,
    and the two fused, construct_tree_aabb: construct_tree's bytes with the
    union's 24 read and the box's 24 written, both's operations),
    and of the tree-editing kernels on the editing path's work ``e``:
    calc_corners of e["rows"] (Q, 4) rows (16 bytes in, 12 out) walking
    e["steps"] steps in all through the parent links of e["nodes"] nodes (8
    bytes each), 6 operations a step (3 adds, 3 divisions); assign of
    e["points"] points descending e["levels"] levels (a point and its
    leaf's child and data entries in; each element of the new (M, D)
    pool reads one of its old value and its winner's value, and is
    written once); unique_leaf_nodes of e["ids"] ids into as many 16-byte rows
    (its flags are scratch, and it does no float operation). The bf16
    query (K5) reads and writes 2-byte values and adds into a float32
    gradient."""
    return _bounds({
        "construct_tree": (Q * 12 + Q * 4 + 2 * n_cells * 4, OPS_LEVEL * q_levels),
        "query_fwd": query_fwd_work(Q, M, D, 4, q_levels),
        "query_bwd": (Q * 4 + Q * D * 4 + M * D * 4, Q * D),
        "query_fwd_bf16": query_fwd_work(Q, M, D, 2, q_levels),
        "query_bwd_bf16": (Q * 4 + Q * D * 2 + M * D * 4, Q * D),
        "points_aabb": (Q * 12 + n_cells * 4 + 24, OPS_LEVEL * q_levels + 9 * Q),
        "construct_tree_aabb": (Q * 12 + Q * 4 + 2 * n_cells * 4 + 48, OPS_LEVEL * q_levels + 9 * Q),
        "calc_corners": (e["rows"] * 28 + e["nodes"] * 8, 6 * e["steps"]),
        "assign": (e["points"] * (12 + 8) + 2 * M * D * 4, OPS_LEVEL * e["levels"]),
        "unique_leaf": (e["ids"] * 4 + e["ids"] * 16 + 4, 0),
    })


def bake_bounds(n_points: int, n_baked: int, n_top_mid: int, R_grow: int) -> dict:
    """bound_ms and bound_by of the bake's kernels: the lookup of
    n_points points (12 bytes in, 24 out: row, cube, fraction, cell; the
    entries it reads are counted with the points' tables, not here),
    refresh of n_baked cells (src_map, depth_parts and one gathered index
    entry in, the new entry out, and the old top or mid entry of the
    n_top_mid cells that may point at bricks), and the skip-box regrowth
    on an R_grow^3 top grid (the grid in and out, 8 bytes per cell). The
    regrowth is a Chebyshev distance transform capped at 15 cells, which
    a linear-time separable transform computes in a forward and a
    backward scan per axis at about 10 operations per cell each, plus the
    pack's ~10: 70 per cell, below the bytes."""
    n3 = R_grow ** 3
    return _bounds({
        "bake_lookup": (n_points * 36, n_points * OPS_LOOKUP),
        "bake_refresh": (n_baked * 16 + n_top_mid * 4, n_baked * 3),
        "grow_boxes": (n3 * 8, n3 * (3 * 2 * 10 + 10)),
    })


def p2v_census(points, grid) -> dict:
    """What this run's cloud makes a voxelize do, summed over all points:
    kept window indices per axis, (x, y) rows and voxels of the window
    walked, and voxels within the radius; only the bounds read it."""
    lo, hi = p2v_ops._windows(points, grid)
    kept = torch.clamp(hi - lo + 1, max=grid.W)
    within = sum(int(valid.sum()) for _, _, valid, _, _ in p2v_ops._walk(points, grid))
    return dict(points=points.shape[0], axis=int(kept.sum()),
                rows=int((kept[:, 0] * kept[:, 1]).sum()), walked=int(kept.prod(dim=1).sum()),
                within=within)


def dynamic_bounds(Q: int, nb: int, J: int, F: int, n: int, c: dict, touched: int) -> dict:
    """bound_ms and bound_by of the warp and voxelize kernels for Q points
    of nb bones over J joints, an n^3 grid, the census ``c`` and the
    ``touched`` voxels of a splat. Bytes: the warp forward reads x, w and
    j and writes the warped point and the blend (T is J x 64 bytes); its
    backward also reads both output gradients and writes dx and dw (the
    dT table is J x 64 bytes); voxelize reads each point and its density
    and writes the grid; its backward reads the gradient at the touched
    voxels and writes both input gradients, d_features (Q, F) whole."""
    walk_ops = (OPS_P2V_POINT * c["points"] + OPS_P2V_AXIS * c["axis"]
                + OPS_P2V_ROW * c["rows"] + OPS_P2V_VOXEL * c["walked"])
    work = {
        "warp_fwd": (Q * (12 + 8 * nb) + Q * 76 + J * 64, Q * OPS_WARP_FWD),
        "warp_bwd": (Q * (12 + 8 * nb + 76) + Q * (12 + 4 * nb) + 2 * J * 64, Q * OPS_WARP_BWD),
        "voxelize_fwd": (Q * 16 + n ** 3 * 4, walk_ops + OPS_P2V_FWD * c["within"]),
        "voxelize_bwd": (Q * 16 + touched * 4 + Q * 12 + Q * F * 4,
                         walk_ops + OPS_P2V_BWD * c["within"]),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        ms, by = bound(n_bytes, n_ops)
        out[name] = dict(bound_ms=ms, bound_by=by, bound_bytes=n_bytes, bound_ops=n_ops)
    return out


def pool_of(kind: str, feats: torch.Tensor):
    """(the float32 pool ``feats`` as a pool of type ``kind``, the float32
    pool its kernels read: bf16 widened exactly, int8 dequantized with the
    kernels' two roundings)."""
    if kind == "bf16":
        p = feats.to(torch.bfloat16)
        return p, p.float()
    q = stt.quantize_features(feats)
    return q, q.dequantize()


def stack_of(kind: str, frames: list):
    """The (N, M, D) stack of float32 pools ``frames`` as a stack of type
    ``kind`` (an int8 stack: each frame quantized on its own, q (N, M, D),
    scale and zero (N, D)) and its frames as single pools."""
    if kind == "i8":
        qs = [stt.quantize_features(f) for f in frames]
        return stt.QuantizedFeatures(*(torch.stack(x).contiguous() for x in zip(*qs))), qs
    stack = torch.stack(frames).to(torch.bfloat16 if kind == "bf16" else torch.float32)
    return stack, list(stack.unbind(0))


def bf16_cast_err(got32: torch.Tensor, want32: torch.Tensor, what: str) -> float:
    """A float32 gradient sum held to another after both are cast to bf16:
    each element within one bf16 ulp of the larger plus the two sums'
    difference (the cast adds at most one ulp to it). Returns the largest
    bf16 difference."""
    a, b = got32.to(torch.bfloat16).float(), want32.to(torch.bfloat16).float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    over = (a - b).abs() - (ulp + (got32 - want32).abs())
    check(not bool((over > 0).any()), f"{what}: bf16 casts more than one ulp apart")
    return float((a - b).abs().max())


def bf16_grad_err(got: torch.Tensor, want32: torch.Tensor, what: str) -> float:
    """A bf16 gradient (a float32 sum cast once) held to another float32
    sum: within one bf16 ulp plus the atomic tolerance of the sum. Returns
    the largest difference."""
    a, b = got.float(), want32.to(torch.bfloat16).float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    tol = ATOMIC_RTOL * max(1.0, float(want32.abs().max()))
    check(bool(torch.isfinite(a).all()) and not bool(((a - b).abs() > ulp + tol).any()),
          f"{what}: more than one bf16 ulp and the atomic tolerance apart")
    return float((a - b).abs().max())


def pool_kernel_phase(specs: dict, feats, jf, origins, dirs, renderers: dict, kernels: dict,
                      dev) -> dict:
    """Phase 3f (K5): every bf16 and int8 march instance on all of the aux
    scene's camera rays, on both structures (``specs``: "" the tree walk,
    "_baked" the bake) and both interp modes (``renderers``: "" nearest,
    "_interp"), exact. The forwards (K2, K9b, K9c) equal the float32
    kernels on the widened pool bit for bit; each instance against its
    plain version on the same rays (the bf16 backward and opacity VJP as
    float32 sums, and after their cast to bf16, and the backward also
    against the float32 kernel); the two structures' exact renders and
    depths with each pool bit for bit. Returns each instance's plain ms."""
    B = origins.shape[0]
    rng = np.random.RandomState(8)
    plain_ms, renders = {}, {}
    t0 = time.perf_counter()
    for kind in POOL_KINDS:
        pool, wide = pool_of(kind, feats)
        check(bool(((wide[:, -1] > 0) == (feats[:, -1] > 0)).all()),
              f"{kind} pool: a sigma changed sign (the march census would differ)")
        for isfx, r in renderers.items():
            opt = r._get_options(False)
            for ssfx, spec in specs.items():
                sfx = ssfx + isfx + "_" + kind
                err = {}
                with torch.no_grad():
                    out = render_ops.volume_render_cuda(spec, pool, origins, dirs, dirs, opt)
                    ok_, w_k = render_ops.volume_render_with_weight_accum_cuda(
                        spec, pool, origins, dirs, dirs, opt)
                    _, w_r = render_ops.volume_render_with_weight_accum_cuda(
                        spec, wide, origins, dirs, dirs, opt)
                    check(torch.equal(out, render_ops.volume_render_cuda(spec, wide, origins, dirs, dirs, opt))
                          and torch.equal(ok_, out), f"render_fwd{sfx}: not the float32 kernel's output")
                    atomic_err(w_k, w_r, f"render_fwd{sfx} weights vs the float32 kernel")
                    hit = aux_ops.first_hit_cuda(spec, pool, origins, dirs, opt)
                    hit_r = aux_ops.first_hit_cuda(spec, wide, origins, dirs, opt)
                    check(all(torch.equal(a, b_) for a, b_ in zip(hit, hit_r)),
                          f"first_hit{sfx}: not the float32 kernel's hits")
                    mf = aux_ops.motion_feature_forward_cuda(spec, jf, pool, origins, dirs, opt)
                    check(torch.equal(mf, aux_ops.motion_feature_forward_cuda(spec, jf, wide, origins,
                                                                              dirs, opt)),
                          f"mf_fwd{sfx}: not the float32 kernel's output")
                    renders[(kind, isfx, ssfx)] = (out, aux_ops.render_depth(spec, pool, origins, dirs, opt))
                    # Against the plain versions on the same rays.
                    out_p, plain_ms["render_fwd" + sfx] = timed_once_ms(
                        lambda: render_ops.volume_render_plain(spec, pool, origins, dirs, dirs, opt))
                    err["render_fwd"] = float((out - out_p).abs().max())
                    check(err["render_fwd"] <= RENDER_ATOL, f"render_fwd{sfx}: kernel vs plain {err['render_fwd']}")
                    del out_p
                    h_p, plain_ms["first_hit" + sfx] = timed_once_ms(
                        lambda: aux_ops.first_hit_plain(spec, pool, origins, dirs, opt))
                    check(all(torch.equal(a, b_) for a, b_ in zip(hit[:3], h_p[:3])),
                          f"first_hit{sfx}: found, t_hit or rows differ from plain")
                    err["first_hit"] = float((hit[3] - h_p[3]).abs().max())
                    check(err["first_hit"] <= RENDER_ATOL and int(hit[0].sum()) > 0, f"first_hit{sfx}: frac")
                    del h_p
                    m_p, plain_ms["mf_fwd" + sfx] = timed_once_ms(
                        lambda: aux_ops.motion_feature_render_plain(spec, jf, pool, origins, dirs, opt))
                    err["mf_fwd"] = float((mf - m_p).abs().max())
                    check(err["mf_fwd"] <= RENDER_ATOL, f"mf_fwd{sfx}: kernel vs plain {err['mf_fwd']}")
                g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
                b_k = aux_ops.motion_feature_backward_cuda(spec, jf, pool, origins, dirs, g_m, opt)
                b_p, plain_ms["mf_bwd" + sfx] = timed_once_ms(
                    lambda: aux_ops.motion_feature_backward_plain(spec, jf, pool, origins, dirs, g_m, opt))
                err["mf_bwd"] = atomic_err(b_k, b_p, f"mf_bwd{sfx}")
                check(float(b_k.abs().max()) > 0, f"mf_bwd{sfx}: zero gradient")
                e_1 = mf_width_check(spec, jf, pool, origins, dirs, opt, mf, m_p, g_m, b_p, sfx)
                err["mf_fwd"], err["mf_bwd"] = max(err["mf_fwd"], e_1[0]), max(err["mf_bwd"], e_1[1])
                del m_p
                cast = {}
                if kind == "bf16":
                    g_out = torch.from_numpy(rng.randn(B, 4).astype(np.float32)).to(dev)
                    g_k = render_ops.volume_render_backward_cuda(spec, pool, origins, dirs, dirs, g_out, opt,
                                                                 out)
                    g_p, plain_ms["render_bwd" + sfx] = timed_once_ms(
                        lambda: render_ops.volume_render_backward_plain(spec, pool, origins, dirs, dirs,
                                                                        g_out, opt, out))
                    err["render_bwd"] = atomic_err(g_k, g_p, f"render_bwd{sfx}")
                    cast["render_bwd"] = bf16_cast_err(g_k, g_p, f"render_bwd{sfx}")
                    check(g_k.dtype == torch.float32 and float(g_k.abs().max()) > 0, f"render_bwd{sfx}: gradient")
                    # The earlier loop (width 1) on the same inputs, and the
                    # rows that take a gradient at both widths.
                    g_1 = render_ops.volume_render_backward_cuda(spec, pool, origins, dirs, dirs, g_out, opt,
                                                                 out, width=1)
                    err["render_bwd"] = max(err["render_bwd"], atomic_err(g_1, g_p, f"render_bwd{sfx} width 1"))
                    rows_p = (g_p != 0).any(dim=1)
                    check(torch.equal((g_k != 0).any(dim=1), rows_p) and torch.equal((g_1 != 0).any(dim=1), rows_p),
                          f"render_bwd{sfx}: rows with a gradient differ from plain")
                    del g_p, g_1
                    atomic_err(g_k, render_ops.volume_render_backward_cuda(spec, wide, origins, dirs, dirs,
                                                                           g_out, opt, out),
                               f"render_bwd{sfx} vs the float32 kernel")
                    # Fast mode (two passes) at both widths.
                    f_opt = r._get_options(True)
                    with torch.no_grad():
                        out_f = render_ops.volume_render_cuda(spec, pool, origins, dirs, dirs, f_opt)
                    e_, _, _, _ = k3_width_check(spec, pool, origins, dirs, g_out, f_opt, out_f, f"{sfx} fast")
                    err["render_bwd"] = max(err["render_bwd"], e_)
                    del out_f
                    alpha = out[:, -1:].contiguous()
                    g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
                    a_k = aux_ops.opacity_backward_cuda(spec, pool, origins, dirs, g_a, opt, out_res=alpha)
                    a_p, plain_ms["opacity_bwd" + sfx] = timed_once_ms(
                        lambda: aux_ops.opacity_backward_plain(spec, pool, origins, dirs, g_a, opt,
                                                               out_res=alpha))
                    err["opacity_bwd"] = atomic_err(a_k, a_p, f"opacity_bwd{sfx}")
                    cast["opacity_bwd"] = bf16_cast_err(a_k, a_p, f"opacity_bwd{sfx}")
                    del a_p
                for name, e in err.items():
                    kernels[name + sfx]["max_abs_err"] = e
                print(f"pool {sfx[1:]} ({B} rays, kernel and plain): forward, first hit and motion "
                      f"features equal to the float32 kernels on the widened pool bit for bit; vs plain "
                      f"max_abs_err {({k: float(f'{v:.3g}') for k, v in err.items()})}, bf16 casts "
                      f"{({k: float(f'{v:.3g}') for k, v in cast.items()})}; plain ms "
                      f"{({k: round(v, 1) for k, v in plain_ms.items() if k.endswith(sfx)})}")
        for isfx in renderers:
            a, b_ = renders[(kind, isfx, "")], renders[(kind, isfx, "_baked")]
            check(torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1]),
                  f"{kind}{isfx}: the backends' exact renders or depths differ")
    print(f"pool backends: exact colors, alpha and depth of the baked and tree instances equal bit "
          f"for bit with bf16 and int8 pools, nearest and interp; phase 3f "
          f"{time.perf_counter() - t0:.1f} s")
    return plain_ms


def query_bf16_check(spec, feats, points, kernels: dict, dev) -> None:
    """The bf16 point query (K5) against its plain version: values equal,
    the float32 gradient sum within the atomic tolerance and its bf16 cast
    within one ulp."""
    pool = feats.to(torch.bfloat16)
    v_k, n_k, d_k = query_ops.query_forward_cuda(spec, pool, points)
    (v_p, n_p, d_p), fwd_ms = timed_once_ms(lambda: query_ops.query_forward_plain(spec, pool, points))
    check(v_k.dtype == torch.bfloat16 and torch.equal(v_k, v_p) and torch.equal(n_k, n_p)
          and torch.equal(d_k, d_p), "query_fwd_bf16: kernel and plain version disagree")
    g_v = torch.from_numpy(np.random.RandomState(11).randn(*v_k.shape).astype(np.float32)).to(dev)
    g_v = g_v.to(torch.bfloat16)
    g_k = query_ops.query_backward_cuda(d_k, g_v, feats.shape[0])
    g_p, bwd_ms = timed_once_ms(lambda: query_ops.query_backward_plain(d_p, g_v, feats.shape[0]))
    err = atomic_err(g_k, g_p, "query_bwd_bf16")
    cast = bf16_cast_err(g_k, g_p, "query_bwd_bf16")
    kernels["query_fwd_bf16"]["max_abs_err"] = 0.0
    kernels["query_bwd_bf16"]["max_abs_err"] = err
    print(f"query bf16: {points.shape[0]} points, bf16 values and ids equal to plain, grad max_abs_err "
          f"{err:.3g} (bf16 cast {cast:.3g}); plain {fwd_ms:.2f} / {bwd_ms:.2f} ms")


def pool_path(backend: str, aux_state: dict, feats, jf, sw, ji, rig, cam_rays, c2w, dev) -> dict:
    """Phase 4k (K5), the main path with bf16 and int8 pools through the
    public entry points on ``backend``, on the aux scene (the canonical
    rows): bench.py's deep serving (`bench.py:583-632`:
    `VolumeRenderer(tree, step_size=1e-3)`, the pool cast to bf16, the
    exact 800x800 frame at fx 880, N_SUSTAIN frames per timed call, the
    least of 3; here in pixel order, `deep9_noplan_ms`) and its int8 form
    (`quantize_features`, and the int8
    render's largest error against the float32 render of the bf16 pool on
    8,192 seeded rays); a bf16 forward + backward; a bf16 training step
    (opacity mask, motion-feature and point-query losses, bf16 joint
    features) and first-hit depth; the aux passes on the int8 pool
    (opacity, depth, motion render, motion features with the joint
    features' gradient); one bf16 `render_dynamic_frames` call on the deep
    dynamic rig (``rig``: poses, src, points, weights, indices), equal bit
    for bit to the same call on the widened pool; and with
    interp="trilinear" a bf16 frame and training step and the int8 frame,
    depth and motion features. Returns the launch counts, the times and
    outputs."""
    tree = stt.tree_from_numpy(aux_state, device=dev)
    r = stt.VolumeRenderer(tree, backend=backend, step_size=1e-3)
    ri = stt.VolumeRenderer(tree, backend=backend, interp="trilinear")
    if backend == "baked":
        tree._baked_spec()
    B = cam_rays.origins.shape[0]
    o_b, d_b = render_ops.cam2world_rays(torch.as_tensor(orbit_camera(), device=dev), WIDTH, HEIGHT,
                                         BENCH_FX, BENCH_FX)
    bench_rays = stt.Rays(o_b.contiguous(), d_b.contiguous(), d_b.contiguous())
    dpool = feats.to(torch.bfloat16)
    res = dict(ms={})
    reset_counts()
    with torch.no_grad():
        # bench.py's deep9 keys: N_SUSTAIN frames of perturbed pools per
        # timed call (made before the clock starts), the least of 3.
        def sustained(pools):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total = float(sum(r(p_, bench_rays).sum() for p_ in pools))
            check(np.isfinite(total), "deep9: non-finite frame")
            return (time.perf_counter() - t0) * 1e3 / len(pools)

        r(dpool, bench_rays)
        stacks = [[(feats * (1.0 + 1e-2 * (i + 1) + 1e-3 * j)).to(torch.bfloat16) for j in range(N_SUSTAIN)]
                  for i in range(3)]
        res["ms"]["deep9_noplan_ms"] = min(sustained(st_) for st_ in stacks)
        del stacks
        q0 = stt.quantize_features(dpool.float())
        sel = torch.from_numpy(np.random.RandomState(0).choice(B, INT8_ERR_RAYS, replace=False)).to(dev)
        sel_rays = stt.Rays(*(x[sel].contiguous() for x in bench_rays))
        res["deep9_int8_max_err"] = float((r(q0, sel_rays) - r(dpool.float(), sel_rays)).abs().max())
        r(q0, bench_rays)
        qstacks = [[stt.quantize_features(dpool.float() * (1.0 + 1e-2 * (i + 1) + 1e-3 * j))
                    for j in range(N_SUSTAIN)] for i in range(3)]
        res["ms"]["deep9_int8_noplan_ms"] = min(sustained(st_) for st_ in qstacks)
        del qstacks
    # A bf16 forward + backward (CUDA events over KERNEL_REPS calls).
    g_img = torch.from_numpy(np.random.RandomState(9).randn(B, 4).astype(np.float32)).to(dev)
    fb_pool = dpool.clone().requires_grad_()

    def fwd_bwd():
        return torch.autograd.grad((r(fb_pool, cam_rays) * g_img).sum(), fb_pool)[0]

    g_fb = fwd_bwd()
    check(g_fb.dtype == torch.bfloat16 and bool(torch.isfinite(g_fb).all()) and float(g_fb.abs().max()) > 0,
          "bf16 fwd+bwd: bad gradient")
    res["ms"]["fwd_bwd_bf16_ms"] = time_ms(fwd_bwd, KERNEL_REPS)
    # A bf16 training step: opacity mask, motion features (bf16 joint
    # features) and a point-query prior; then the first-hit depth.
    with torch.no_grad():
        t_alpha = r.opacity_render(feats, cam_rays)
        t_mf = r.motion_feature_render(feats, jf, sw, ji, cam_rays)
    pool = dpool.clone().requires_grad_()
    jfb = jf.to(torch.bfloat16).requires_grad_()
    prior_pts = rig[2][torch.from_numpy(np.random.RandomState(10).permutation(rig[2].shape[0])[:N_PRIOR_POINTS]).to(dev)]
    loss = (MASK_WEIGHT * ((r.opacity_render(pool, cam_rays) - t_alpha) ** 2).mean()
            + ((r.motion_feature_render(pool, jfb, sw, ji, cam_rays) - t_mf) ** 2).mean()
            + PRIOR_WEIGHT * tree(pool, prior_pts)[:, -1].float().abs().mean())
    loss.backward()
    for name, x in (("pool", pool), ("joint features", jfb)):
        check(x.grad is not None and x.grad.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())
              and float(x.grad.float().abs().max()) > 0, f"bf16 training step: bad {name} gradient")
    with torch.no_grad():
        depth_b = r.render_depth(dpool, cam_rays)
        check(torch.equal(depth_b, r.render_depth(dpool.float(), cam_rays)), "bf16 depth: not the float32 kernel's")
        # The aux passes on the int8 pool.
        alpha_q = r.opacity_render(q0, cam_rays)
        depth_q = r.render_depth(q0, cam_rays)
        motion_q = r.motion_render(q0, cam_rays)
        wide_q = q0.dequantize()
        check(torch.equal(alpha_q, r.opacity_render(wide_q, cam_rays))
              and torch.equal(depth_q, r.render_depth(wide_q, cam_rays))
              and torch.equal(depth_q, motion_q[1]), "int8 aux passes: not the float32 kernels' outputs")
    x = jf.clone().requires_grad_()
    mf_q = r.motion_feature_render(q0, x, sw, ji, cam_rays)
    (g_x,) = torch.autograd.grad(((mf_q - t_mf) ** 2).mean(), x)
    check(bool(torch.isfinite(g_x).all()) and float(g_x.abs().max()) > 0, "int8 motion features: bad gradient")
    # One bf16 render_dynamic_frames call on the deep dynamic rig, and the
    # same call on the widened pool: equal bit for bit.
    dyn_tree = stt.tree_from_numpy(aux_state, device=dev)
    dyn_r = stt.VolumeRenderer(dyn_tree, backend=backend)
    if backend == "baked":
        dyn_tree._baked_spec()  # the host bake, at load: not part of the call's time
    dyn_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, viewdir_rotation=True, with_depth=True,
                  update_tree=False)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols, deps = dyn_r.render_dynamic_frames(dpool, *rig, **dyn_kw)
        torch.cuda.synchronize()
        res["ms"]["dynamic_bf16_call_ms"] = (time.perf_counter() - t0) * 1e3
        cols_w, deps_w = dyn_r.render_dynamic_frames(dpool.float(), *rig, **dyn_kw)
    check(torch.equal(cols, cols_w) and torch.equal(deps, deps_w),
          "bf16 render_dynamic_frames: not the float32 call on the widened pool")
    check(bool((cols[..., 3] > 0).any()), "bf16 render_dynamic_frames: no hit")
    # Trilinear: a bf16 frame and training step, depth; the int8 frame,
    # depth and motion features with the joint features' gradient.
    pool_i = dpool.clone().requires_grad_()
    jfb_i = jf.to(torch.bfloat16).requires_grad_()
    img = ri.render_persp(pool_i, c2w, WIDTH, HEIGHT, fx=FX)
    loss_i = ((img ** 2).mean() + MASK_WEIGHT * (ri.opacity_render(pool_i, cam_rays) ** 2).mean()
              + (ri.motion_feature_render(pool_i, jfb_i, sw, ji, cam_rays) ** 2).mean())
    loss_i.backward()
    check(pool_i.grad.dtype == torch.bfloat16 and float(pool_i.grad.float().abs().max()) > 0
          and jfb_i.grad.dtype == torch.bfloat16, "bf16 interp step: bad gradients")
    with torch.no_grad():
        di_b = ri.render_depth(dpool, cam_rays)
        img_q = ri(q0, cam_rays)
        di_q = ri.render_depth(q0, cam_rays)
        check(torch.equal(img_q, ri(wide_q, cam_rays)) and torch.equal(di_q, ri.render_depth(wide_q, cam_rays)),
              "int8 interp: not the float32 kernels' outputs")
    x_i = jf.clone().requires_grad_()
    (g_xi,) = torch.autograd.grad((ri.motion_feature_render(q0, x_i, sw, ji, cam_rays) ** 2).mean(), x_i)
    check(float(g_xi.abs().max()) > 0 and bool((di_b > 0).any()), "int8 interp: bad gradient or no depth")
    torch.cuda.synchronize()
    res["counts"] = read_counts()
    return res


def tape_kernel_phase(state, tree_spec, baked, feats, rot, origins, dirs, centers, skip_case, opts,
                      kernels, dev) -> dict:
    """Phase 3g (K13): the tape kernels against their plain versions on all
    of the depth-9 shell's camera rays, on both structures (``tree_spec``,
    ``baked``), exact and fast (``opts``), compacted and not: K13a's counts
    and K13b's streams exactly equal; K13c equal to K2 bit for bit (also
    with rotations, and with weights: the weights, atomic sums, at the
    atomic tolerance), and to plain at the march tolerance; the bf16 and
    int8 K13c equal to the float32 K13c on the widened or dequantized pool
    bit for bit; K13d against plain and K3 at the atomic tolerance (float32
    and bf16); K13f equal to its plain version and to K9b's render_depth
    bit for bit on every tape; K13e on a stack of N_STACK pools (float32
    and bf16) over the bake's compacted exact tape against its plain
    version and N_STACK K13d calls at the atomic tolerance; a fast frame
    whose march steps across skip boxes
    (``skip_case``: bench.py's frame 1 on its bake), K13c against K2 bit
    for bit and plain; an indirect tape replayed after a re-point equal to
    K2 on the re-pointed tree (tree walk), its depth (K13f through the
    table) to plain and K9b. Returns each kernel's plain ms
    and what the times and bounds read: the exact compacted tape, its
    sample counts, and the tapes' counts."""
    t_3g = time.perf_counter()
    M = feats.shape[0]
    rng = np.random.RandomState(13)
    plain_ms, err, stats, chunks = {}, {}, {}, {}

    def note(name, e):
        err[name] = max(err.get(name, 0.0), e)

    with torch.no_grad():
        for sfx, spec in (("_baked", baked), ("", tree_spec)):
            for fast in (False, True):
                opt = opts[fast]
                mode = "fast" if fast else "exact"
                n_occ, n_tot = tape_ops.count_samples_cuda(spec, M, origins, dirs, opt)
                (p_occ, p_tot), plain_ms["tape_count" + sfx, fast] = timed_once_ms(
                    lambda: tape_ops.count_samples_plain(spec, M, origins, dirs, opt))
                check(torch.equal(n_occ, p_occ) and torch.equal(n_tot, p_tot),
                      f"tape_count{sfx} {mode}: kernel and plain counts differ")
                out_k2, w_k2 = render_ops.volume_render_with_weight_accum_cuda(
                    spec, feats, origins, dirs, dirs, opt)
                for compact in (False, True):
                    label = f"{sfx or '_tree'} {mode} {'compact' if compact else 'full'}"
                    tp = tape_ops.record_tape(spec, M, origins, dirs, dirs, opt, compact=compact,
                                              record_t=True)
                    want, plain_ms["tape_record" + sfx, fast, compact] = timed_once_ms(
                        lambda: tape_ops.record_samples_plain(spec, M, origins, dirs, opt, tp.offsets,
                                                              compact, True, True, True))
                    check(torch.equal(tp.counts, n_occ if compact else n_tot),
                          f"tape {label}: counts are not K13a's")
                    for name, a, b_ in zip(("idx", "dt", "cell", "tval", "dscale"),
                                           (tp.idx, tp.dt, tp.cell, tp.tval, tp.dscale), want):
                        check(torch.equal(a, b_), f"tape_record {label}: kernel and plain {name} differ")
                    # The one walk (tape_stage, tape_copy) against the earlier
                    # pair: K13b at K13a's offsets.
                    pair = tape_ops.record_samples_cuda(spec, M, origins, dirs, opt, tp.offsets, compact, True,
                                                        True, True)
                    check(all(torch.equal(a, b_) for a, b_ in zip((tp.idx, tp.dt, tp.cell, tp.tval, tp.dscale),
                                                                   pair)),
                          f"tape {label}: the one-walk tape is not the count and record walks' bit for bit")
                    del pair
                    if compact and not fast:
                        # An arena of one chunk: the walk reruns with the
                        # capacity it reported, and the tape is the same.
                        reruns = tape_ops.ARENA_RERUNS["reruns"]
                        ov = tape_ops.record_streams(spec, M, origins, dirs, opt, True, True, True, True,
                                                     capacity=1)
                        check(tape_ops.ARENA_RERUNS["reruns"] == reruns + 1 and ov[2] == tp.S
                              and all(torch.equal(a, b_) for a, b_ in zip(
                                  ov[:2] + ov[3:], (tp.counts, tp.offsets, tp.idx, tp.dt, tp.cell, tp.tval,
                                                    tp.dscale))),
                              f"tape {label}: an arena of one chunk gives another tape")
                        del ov
                        st_p, plain_ms["tape_stage" + sfx] = timed_once_ms(
                            lambda: tape_ops.stage_samples_plain(spec, M, origins, dirs, opt, True, True, True,
                                                                 False))
                        cp_p, plain_ms["tape_copy" + sfx] = timed_once_ms(
                            lambda: tape_ops.copy_samples_plain(spec, opt, st_p, int(st_p.n_chunks[0]),
                                                                tp.offsets, tp.n_samples))
                        check(all(torch.equal(a, b_) for a, b_ in zip(cp_p[:3], (tp.idx, tp.dt, tp.cell))),
                              f"tape {label}: the plain walk and copy differ from the kernels' tape")
                        del st_p, cp_p
                    stats[sfx, fast, compact] = tp.n_samples
                    if compact and not fast:
                        chunks[sfx] = int(((tp.counts + tape_ops.ARENA_CHUNK - 1) // tape_ops.ARENA_CHUNK).sum())
                    out = tape_ops.replay_forward_cuda(tp, feats, opt, spec)[0]
                    check(torch.equal(out, out_k2), f"tape_replay_fwd {label}: not K2 bit for bit")
                    out_w, w = tape_ops.replay_forward_cuda(tp, feats, opt, spec, True)
                    check(torch.equal(out_w, out_k2), f"tape_replay_fwd {label} weights: outputs not K2's")
                    w_err = atomic_err(w, w_k2, f"tape_replay_fwd {label} weights vs K2")
                    # Width 1, the scalar row, with and without weights.
                    out_1, w_1 = tape_ops.replay_forward_cuda(tp, feats, opt, spec, True, width=1)
                    check(torch.equal(out_1, out_k2) and torch.equal(
                        tape_ops.replay_forward_cuda(tp, feats, opt, spec, width=1)[0], out_k2),
                          f"tape_replay_fwd {label} width 1: not K2 bit for bit")
                    w_err = max(w_err, atomic_err(w_1, w_k2, f"tape_replay_fwd {label} width 1 weights vs K2"))
                    (out_p, w_p), plain_ms["tape_replay_fwd", sfx, fast, compact] = timed_once_ms(
                        lambda: tape_ops.replay_forward_plain(tp, feats, opt, spec, True))
                    e = float((out - out_p).abs().max())
                    check(e <= RENDER_ATOL, f"tape_replay_fwd {label}: kernel vs plain {e}")
                    note("tape_replay_fwd", max(e, atomic_err(w, w_p, f"tape_replay_fwd {label} weights")))
                    line = (f"tape {label}: {tp.n_samples} samples (S {tp.S}), counts and streams equal to "
                            f"plain; replay (widths 4 and 1) equal to K2 bit for bit, weights vs K2 {w_err:.3g}, "
                            f"vs plain {e:.3g}")
                    # K13f: the depth replay equal to its plain version and to
                    # K9b's render_depth bit for bit.
                    dep = tape_ops.replay_depth_cuda(tp, feats, opt.sigma_thresh)
                    dep_p, plain_ms["tape_depth", sfx, fast, compact] = timed_once_ms(
                        lambda: tape_ops.replay_depth_plain(tp, feats, opt.sigma_thresh))
                    check(torch.equal(dep, dep_p), f"tape_depth {label}: kernel and plain differ")
                    check(torch.equal(dep, aux_ops.render_depth(spec, feats, origins, dirs, opt)),
                          f"tape_depth {label}: not K9b's render_depth bit for bit")
                    check(bool((dep > 0).any()), f"tape_depth {label}: no hit")
                    line += "; depth equal to plain and to K9b bit for bit"
                    if not fast:
                        rspec = spec.with_(transformation_matrices=rot)
                        k2_r = render_ops.volume_render_cuda(rspec, feats, origins, dirs, dirs, opt)
                        check(all(torch.equal(tape_ops.replay_forward_cuda(tp, feats, opt, rspec, width=w_)[0], k2_r)
                                  for w_ in (4, 1)),
                              f"tape_replay_fwd {label} with rotations: not K2 bit for bit")
                        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
                        kinds = (("", feats),) + ((("_bf16", feats.to(torch.bfloat16)),) if compact else ())
                        for psfx, pool in kinds:
                            g_k = tape_ops.replay_backward_cuda(tp, pool, opt, g, out, spec)
                            g_p, plain_ms["tape_replay_bwd" + psfx, sfx, compact] = timed_once_ms(
                                lambda: tape_ops.replay_backward_plain(tp, pool, opt, g, out, spec))
                            g_3 = render_ops.volume_render_backward_cuda(spec, pool, origins, dirs, dirs, g,
                                                                         opt, out_res=out)
                            eb = atomic_err(g_k, g_p, f"tape_replay_bwd{psfx} {label}")
                            e3 = atomic_err(g_k, g_3, f"tape_replay_bwd{psfx} {label} vs K3")
                            check(float(g_k.abs().max()) > 0, f"tape_replay_bwd{psfx} {label}: zero gradient")
                            # Width 1, the earlier scalar design, too.
                            eb = max(eb, atomic_err(
                                tape_ops.replay_backward_cuda(tp, pool, opt, g, out, spec, width=1), g_p,
                                f"tape_replay_bwd{psfx} {label} width 1"))
                            note("tape_replay_bwd" + psfx, eb)
                            line += f"; bwd{psfx} (widths 4, 1) vs plain {eb:.3g}, vs K3 {e3:.3g}"
                    if not fast and compact:
                        for kind in POOL_KINDS:
                            pool, wide = pool_of(kind, feats)
                            got = tape_ops.replay_forward_cuda(tp, pool, opt, spec)[0]
                            check(torch.equal(got, tape_ops.replay_forward_cuda(tp, wide, opt, spec)[0]),
                                  f"tape_replay_fwd_{kind} {label}: not the float32 kernel on the widened pool")
                            check(torch.equal(got, tape_ops.replay_forward_cuda(tp, pool, opt, spec, width=1)[0]),
                                  f"tape_replay_fwd_{kind} {label}: widths 4 and 1 differ")
                            check(torch.equal(got, render_ops.volume_render_cuda(spec, pool, origins, dirs, dirs,
                                                                                 opt)),
                                  f"tape_replay_fwd_{kind} {label}: not K2's {kind} instance bit for bit")
                            p_, plain_ms["tape_replay_fwd_" + kind, sfx] = timed_once_ms(
                                lambda: tape_ops.replay_forward_plain(tp, pool, opt, spec)[0])
                            e = float((got - p_).abs().max())
                            check(e <= RENDER_ATOL, f"tape_replay_fwd_{kind} {label}: kernel vs plain {e}")
                            note("tape_replay_fwd_" + kind, e)
                        line += ("; bf16 and int8 replays (widths 4 and 1) equal to the float32 kernel on the "
                                 "widened pools and to K2's pool instances")
                        if sfx == "_baked":
                            stats["tape"] = tp
                    print(line)
                    del tp, want
        # K13c's frame axis on N_STACK pools over the bake's compacted exact
        # tape, float32, bf16 and int8, each width against N_STACK single
        # K13c launches bit for bit and against its plain version; K13e on
        # the float32 and bf16 stacks against its plain version and against
        # N_STACK K13d calls.
        tp, opt = stats["tape"], opts[False]
        for psfx, kind in (("", "f32"), ("_bf16", "bf16"), ("_i8", "i8")):
            stack, frames = stack_of(kind, [feats * (1.0 + 0.1 * n) for n in range(N_STACK)])
            outs = torch.stack([tape_ops.replay_forward_cuda(tp, f, opt, baked)[0] for f in frames])
            check(all(torch.equal(tape_ops.replay_forward_frames_cuda(tp, stack, opt, baked, width=w_), outs)
                      for w_ in (4, 1)), f"tape_replay_fwd_frames{psfx}: not {N_STACK} K13c launches bit for bit")
            o_p, plain_ms["tape_replay_fwd_frames" + psfx] = timed_once_ms(
                lambda: tape_ops.replay_forward_frames_plain(tp, stack, opt, baked))
            e = float((outs - o_p).abs().max())
            check(e <= RENDER_ATOL and not torch.equal(outs[0], outs[-1]),
                  f"tape_replay_fwd_frames{psfx}: kernel vs plain {e}, or the frames are equal")
            note("tape_replay_fwd_frames" + psfx, e)
            print(f"tape_replay_fwd_frames{psfx} ({N_STACK} frames, {tp.n_samples} samples): widths 4 and 1 equal "
                  f"to {N_STACK} K13c launches bit for bit, vs plain {e:.3g}")
            if kind == "i8":
                continue
            g = torch.from_numpy(rng.randn(*outs.shape).astype(np.float32)).to(dev)
            g_k = tape_ops.replay_backward_frames_cuda(tp, stack, opt, g, outs, baked)
            g_p, plain_ms["tape_replay_bwd_frames" + psfx] = timed_once_ms(
                lambda: tape_ops.replay_backward_frames_plain(tp, stack, opt, g, outs, baked))
            eb = atomic_err(g_k, g_p, f"tape_replay_bwd_frames{psfx}")
            eb = max(eb, atomic_err(tape_ops.replay_backward_frames_cuda(tp, stack, opt, g, outs, baked, width=1),
                                    g_p, f"tape_replay_bwd_frames{psfx} width 1"))
            e_d = max(atomic_err(g_k[n], tape_ops.replay_backward_cuda(tp, stack[n], opt, g[n], outs[n], baked),
                                 f"tape_replay_bwd_frames{psfx} frame {n} vs K13d") for n in range(N_STACK))
            check(all(float(g_k[n].abs().max()) > 0 for n in range(N_STACK)),
                  f"tape_replay_bwd_frames{psfx}: a frame without gradient")
            note("tape_replay_bwd_frames" + psfx, eb)
            print(f"tape_replay_bwd_frames{psfx} ({N_STACK} frames, {tp.n_samples} samples): widths 4 and 1 "
                  f"vs plain {eb:.3g}, "
                  f"vs {N_STACK} K13d calls {e_d:.3g} (max|g| {float(g_p.abs().max()):.4g})")
            del stack, frames, outs, o_p, g, g_k, g_p
        # Fast mode across skip boxes: bench.py's frame 1 on its bake.
        gb_sp, gb_feats, gb_o, gb_d, gb_v, gb_opt = skip_case
        Mg = gb_feats.shape[0]
        n_occ, n_tot = tape_ops.count_samples_cuda(gb_sp, Mg, gb_o, gb_d, gb_opt)
        check(all(torch.equal(a, b_) for a, b_ in zip(
            (n_occ, n_tot), tape_ops.count_samples_plain(gb_sp, Mg, gb_o, gb_d, gb_opt))),
              "tape_count_baked across skip boxes: kernel and plain differ")
        for compact in (False, True):
            tp = tape_ops.record_tape(gb_sp, Mg, gb_o, gb_d, gb_v, gb_opt, compact=compact)
            want = tape_ops.record_samples_plain(gb_sp, Mg, gb_o, gb_d, gb_opt, tp.offsets, compact)
            check(all(torch.equal(a, b_) for a, b_ in zip((tp.idx, tp.dt, tp.cell, tp.dscale),
                                                          (want[0], want[1], want[2], want[4]))),
                  "tape_record_baked across skip boxes: kernel and plain differ")
            out = tape_ops.replay_forward_cuda(tp, gb_feats, gb_opt, gb_sp)[0]
            check(torch.equal(out, render_ops.volume_render_cuda(gb_sp, gb_feats, gb_o, gb_d, gb_v, gb_opt))
                  and torch.equal(out, tape_ops.replay_forward_cuda(tp, gb_feats, gb_opt, gb_sp, width=1)[0]),
                  "tape_replay_fwd across skip boxes (widths 4 and 1): not K2 bit for bit")
            e = float((out - tape_ops.replay_forward_plain(tp, gb_feats, gb_opt, gb_sp)[0]).abs().max())
            check(e <= RENDER_ATOL, f"tape_replay_fwd across skip boxes: kernel vs plain {e}")
            note("tape_replay_fwd", e)
            print(f"tape across skip boxes (bench.py's fast frame 1, {'compact' if compact else 'full'}): "
                  f"{tp.n_samples} samples; streams equal to plain, replay equal to K2 bit for bit, vs "
                  f"plain {e:.3g}")
        # An indirect tape replayed after a re-point (tree walk).
        itree = stt.tree_from_numpy(state, device=dev)
        ispec = itree._spec()
        opt = opts[False]
        tp = tape_ops.record_tape(ispec, M, origins, dirs, dirs, opt, indirect=True, record_t=True)
        itree.construct_tree(centers[torch.from_numpy(rng.permutation(M)).to(dev)])
        ispec2 = itree._spec()
        check(not torch.equal(ispec2.data_flat, ispec.data_flat), "the re-point changed no row")
        table = tape_ops.pack_index_table(ispec2.data_flat)
        out = tape_ops.replay_forward_cuda(tp, feats, opt, ispec2, False, table)[0]
        check(torch.equal(out, render_ops.volume_render_cuda(ispec2, feats, origins, dirs, dirs, opt))
              and torch.equal(out, tape_ops.replay_forward_cuda(tp, feats, opt, ispec2, False, table, width=1)[0]),
              "indirect tape replay after a re-point (widths 4 and 1): not K2 on the re-pointed tree bit for bit")
        e = float((out - tape_ops.replay_forward_plain(tp, feats, opt, ispec2, False, table)[0]).abs().max())
        check(e <= RENDER_ATOL, f"indirect tape replay: kernel vs plain {e}")
        note("tape_replay_fwd", e)
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
        note("tape_replay_bwd", atomic_err(
            tape_ops.replay_backward_cuda(tp, feats, opt, g, out, ispec2, table),
            tape_ops.replay_backward_plain(tp, feats, opt, g, out, ispec2, table), "indirect tape_replay_bwd"))
        # K13f through the table, on a pool whose every third sigma is
        # negative: the first hit moves with the frame.
        dpool = feats.clone()
        dpool[::3, -1] = -1.0
        dep = tape_ops.replay_depth_cuda(tp, dpool, opt.sigma_thresh, table)
        check(torch.equal(dep, tape_ops.replay_depth_plain(tp, dpool, opt.sigma_thresh, table)),
              "indirect tape_depth: kernel and plain differ")
        check(torch.equal(dep, aux_ops.render_depth(ispec2, dpool, origins, dirs, opt)),
              "indirect tape_depth: not K9b on the re-pointed tree bit for bit")
        print(f"indirect tape ({tp.n_samples} cells) after a re-point of {M} rows: replay equal to K2 on the "
              f"re-pointed tree bit for bit, vs plain {e:.3g}; depth equal to plain and to K9b bit for bit")
        del tp, itree, dpool
    for name in ("tape_stage", "tape_stage_baked", "tape_copy", "tape_copy_baked", "tape_count",
                 "tape_count_baked", "tape_record", "tape_record_baked", "tape_depth"):
        kernels[name]["max_abs_err"] = 0.0
    for name, e in err.items():
        kernels[name]["max_abs_err"] = e
    print(f"phase 3g {time.perf_counter() - t_3g:.1f} s")
    return dict(plain_ms=plain_ms, samples=stats, chunks=chunks)


def tape_path(backend: str, state: dict, frame_feats, true_pool, pool0, c2w, dev) -> dict:
    """Phase 4l (K13), the tape path through the public entry points on
    ``backend``: three frames of `render_persp_tape` (exact and fast) with
    the frames' pools, then two Adam steps through `render_persp_tape` +
    `backward()` toward a target image, the second inside
    `accumulate_weights()`. Launch counts are read around these; then the
    frames are checked equal to `render_persp` bit for bit. The first frame's
    pool also renders as bf16 and int8, and a bf16 pool takes a gradient.
    Returns the counts, the losses and the host ms of the frames."""
    tree = stt.tree_from_numpy(state, device=dev)
    r = stt.VolumeRenderer(tree, backend=backend)
    if backend == "baked":
        tree._baked_spec()
    frames, frame_ms = [], []
    reset_counts()
    with torch.no_grad():
        for f in frame_feats:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append([r.render_persp_tape(f, c2w, WIDTH, HEIGHT, fx=FX, fast=fast)
                           for fast in (False, True)])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        target = r.render_persp_tape(true_pool, c2w, WIDTH, HEIGHT, fx=FX)
        # The bf16 and int8 pools' replays (K5 instances of K13c).
        pools = {"bf16": frame_feats[0].to(torch.bfloat16), "i8": stt.quantize_features(frame_feats[0])}
        pool_frames = {k: r.render_persp_tape(p_, c2w, WIDTH, HEIGHT, fx=FX) for k, p_ in pools.items()}
    # A bf16 pool's gradient through the bf16 K13d.
    pool_b = pool0.to(torch.bfloat16).requires_grad_()
    ((r.render_persp_tape(pool_b, c2w, WIDTH, HEIGHT, fx=FX) - target) ** 2).mean().backward()
    pool = pool0.clone().requires_grad_()
    adam = torch.optim.Adam([pool], lr=LR)
    losses = []
    for step in range(2):
        with tree.accumulate_weights() if step else contextlib.nullcontext() as acc:
            img = r.render_persp_tape(pool, c2w, WIDTH, HEIGHT, fx=FX)
            loss = ((img - target) ** 2).mean()
            adam.zero_grad()
            loss.backward()
            adam.step()
        losses.append(float(loss.detach()))
    counts = read_counts()
    weights = acc.value
    check(losses[1] < losses[0], f"tape steps: the loss did not fall {losses}")
    for x in (pool, pool_b):
        check(x.grad.dtype == x.dtype and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0,
              f"tape step: bad {x.dtype} gradient")
    alpha_sum = float(img.detach()[..., -1].sum())
    check(abs(float(weights.sum()) - alpha_sum) <= 1e-4 * alpha_sum,
          f"tape step: weights sum {float(weights.sum())} != alpha sum {alpha_sum}")
    with torch.no_grad():
        for f, (img_e, img_f) in zip(frame_feats, frames):
            check(torch.equal(img_e, r.render_persp(f, c2w, WIDTH, HEIGHT, fx=FX)),
                  f"render_persp_tape ({backend}) is not render_persp bit for bit")
            check(torch.equal(img_f, r.render_persp(f, c2w, WIDTH, HEIGHT, fx=FX, fast=True)),
                  f"fast render_persp_tape ({backend}) is not render_persp bit for bit")
        for k, p_ in pools.items():
            check(torch.equal(pool_frames[k], r.render_persp(p_, c2w, WIDTH, HEIGHT, fx=FX)),
                  f"{k} render_persp_tape ({backend}) is not render_persp bit for bit")
    return dict(counts=counts, losses=losses, frame_ms=frame_ms)


def tape_times(backend: str, scenes: dict, dev, card: str) -> dict:
    """bench.py's tape keys (`bench.py:173-282`, `:634-665`) on ``backend``,
    each beside the march on the same rays, made once (as bench.py's
    `fwd_sustained` marches them). Its headline configuration
    (`bench.py:40-59`): `build_shell_tree(depth=7)`, SH9,
    `VolumeRenderer(tree, step_size=1e-3)`, the orbit camera at 800x800, fx
    880: `tape_record_ms` (a second `record_persp` after a warm one, host
    clock, synchronized); `fwd_tape_ms`, `render_tape` of N_SUSTAIN
    perturbed pools per timed call, the least of 3, beside
    `fwd_march_noplan_ms`, the renderer's `forward` on the tape's rays in
    pixel order timed the same way; `tape_fwd_bwd_seq_ms`, a forward and
    backward per pool in turn, beside `fwd_bwd_seq_ms`, the march's. The
    deep configuration (`bench.py:583-665`): the depth-9 shell, its pool in
    bf16: `deep9_tape_ms`, `deep9_tape_mrays_s` and, on its int8 form,
    `deep9_tape_int8_mrays_s`, beside `deep9_noplan_ms`. (bench.py's `fwd_ms`
    and `deep9_ms` march cost-ordered rays: `plan_times`.) ``scenes``: depth
    -> (tree state, float32 pool)."""
    res = {}
    B = WIDTH * HEIGHT

    def sustained(render, pools):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = float(sum(render(p_).sum() for p_ in pools))
        check(np.isfinite(total), "non-finite frame")
        return (time.perf_counter() - t0) * 1e3 / len(pools)

    def least(render, make):
        render(make(0, 0))
        return min(sustained(render, [make(i + 1, j) for j in range(N_SUSTAIN)]) for i in range(3))

    def seq(render, make):
        def run(pools):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p_ in pools:
                x = p_.clone().requires_grad_()
                torch.autograd.grad(render(x).sum(), x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / len(pools)
        run([make(0, 0)])
        return min(run([make(i + 1, j) for j in range(N_SUSTAIN)]) for i in range(3))

    for depth in (7, DEPTH):
        st_, f_np = scenes[depth]
        tree = stt.tree_from_numpy(st_, device=dev)
        r = stt.VolumeRenderer(tree, backend=backend, step_size=1e-3)
        f0 = torch.from_numpy(f_np).to(dev)
        if depth == DEPTH:
            f0 = f0.to(torch.bfloat16)
        persp = dict(c2w=orbit_camera(), width=WIDTH, height=HEIGHT, fx=BENCH_FX)
        make = lambda i, j: f0 * (1.0 + 1e-2 * i + 1e-3 * j)  # noqa: E731
        with torch.no_grad():
            tape = r.record_persp(features=f0, **persp)
            rays = stt.Rays(tape.origins, tape.dirs, tape.vdirs)
            if depth == 7:
                r._tape_cache.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tape = r.record_persp(features=f0, **persp)
                torch.cuda.synchronize()
                res["tape_record_ms"] = (time.perf_counter() - t0) * 1e3
                res["fwd_tape_ms"] = least(lambda p_: r.render_tape(tape, p_), make)
                res["fwd_march_noplan_ms"] = least(lambda p_: r(p_, rays), make)
            else:
                res["deep9_tape_ms"] = least(lambda p_: r.render_tape(tape, p_), make)
                res["deep9_noplan_ms"] = least(lambda p_: r(p_, rays), make)
                res["deep9_tape_int8_ms"] = least(
                    lambda p_: r.render_tape(tape, p_),
                    lambda i, j: stt.quantize_features(f0.float() * (1.0 + 1e-2 * i + 1e-3 * j)))
        if depth == 7:
            res["tape_fwd_bwd_seq_ms"] = seq(lambda x: r.render_tape(tape, x), make)
            res["fwd_bwd_seq_ms"] = seq(lambda x: r(x, rays), make)
        del tree, r, f0, tape, rays
    for k in ("deep9_tape", "deep9_tape_int8", "deep9_noplan", "fwd_march_noplan"):
        res[k + "_mrays_s"] = B / res[k + "_ms"] / 1e3
    print(f"bench.py tape keys ({LABEL[backend]}; host clock, synchronized, {N_SUSTAIN} frames per timed "
          f"call, least of 3; the march on the tape's rays, made once): tape_record_ms "
          f"{res['tape_record_ms']:.4f}, fwd_tape_ms {res['fwd_tape_ms']:.4f} (march in pixel order "
          f"fwd_march_noplan_ms {res['fwd_march_noplan_ms']:.4f}, fwd_march_noplan_mrays_s "
          f"{res['fwd_march_noplan_mrays_s']:.3f}), tape_fwd_bwd_seq_ms {res['tape_fwd_bwd_seq_ms']:.4f} (march "
          f"{res['fwd_bwd_seq_ms']:.4f}); deep9_tape_ms {res['deep9_tape_ms']:.4f}, deep9_tape_mrays_s "
          f"{res['deep9_tape_mrays_s']:.3f}, deep9_tape_int8_mrays_s {res['deep9_tape_int8_mrays_s']:.3f} "
          f"(march in pixel order deep9_noplan_ms {res['deep9_noplan_ms']:.4f}, "
          f"{res['deep9_noplan_mrays_s']:.3f} Mrays/s) [{card}]")
    return res


def dynamic_tape_path(backend: str, state: dict, feats, rig, c2w, dev) -> dict:
    """Phase 4m (K13e, K13f), the temporal tape path through the public
    entry points on ``backend``, on the deep dynamic scene (``rig``: the
    leaf centres skinned to the seeded skeleton, N_FRAMES poses):
    `record_dynamic_persp` (compacted and not, with t), then
    `render_dynamic_tape_frames` exact, fast and uncompacted, each with
    rotations and depth; a two-frame pool stack through
    `render_tape_frames` (float32 and bf16 with gradients, K13c's frame axis
    and K13e; int8 forward only); a 3-view 800x800 rig tape
    frame (`render_persp_rig_tape`). Launch counts are read around these;
    then the frames are checked against `render_dynamic_frames` on the same
    inputs (uncompacted exact bit for bit, compacted within 2e-6, depths
    bit for bit; fast mode against the fused loop with the box advance and
    skip boxes off), the gradients against per-frame K13d calls, and each
    rig view against `render_persp` bit for bit. Then the host ms of a
    frame with the tape passed in and through the cache key (the
    animation's tensors keyed by identity and version), and of a
    `record_dynamic_persp` call that hits the cache. Returns the counts, the exact outputs, the
    times and the compacted tape with frame 0's index table."""
    tree = stt.tree_from_numpy(state, device=dev)
    r = stt.VolumeRenderer(tree, backend=backend)
    if backend == "baked":
        tree._baked_spec()
    kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, update_tree=False, with_depth=True)
    cams = np.stack([orbit_camera(theta=t) for t in (0.5, 2.6, 4.7)])
    stack2 = torch.stack([feats, feats * 1.05])
    g2 = torch.from_numpy(np.random.RandomState(15).randn(2, WIDTH * HEIGHT, 4).astype(np.float32)).to(dev)
    res, out, grads = {}, {}, {}
    reset_counts()
    reruns = tape_ops.ARENA_RERUNS["reruns"]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tape = r.record_dynamic_persp(c2w, *rig, WIDTH, HEIGHT, FX, record_t=True)
        torch.cuda.synchronize()
        res["record_ms"] = (time.perf_counter() - t0) * 1e3
        r.record_dynamic_persp(c2w, *rig, WIDTH, HEIGHT, FX, compact=False, record_t=True)
        for name, fast, compact in (("exact", False, True), ("fast", True, True), ("full", False, False)):
            out[name] = r.render_dynamic_tape_frames(feats, *rig, fast=fast, compact=compact, **kw)
        st_tape = r.record_persp(c2w, WIDTH, HEIGHT, FX, features=feats)
        rig_img = r.render_persp_rig_tape(feats, cams, WIDTH, HEIGHT, FX)
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = stack2.to(dtype).detach().requires_grad_()
        o = r.render_tape_frames(st_tape, x)
        (o * g2).sum().backward()
        grads[kind] = (x.detach(), o.detach(), x.grad)
    with torch.no_grad():
        q_stack, q_frames = stack_of("i8", list(stack2.unbind(0)))
        q_out = r.render_tape_frames(st_tape, q_stack)
    counts = read_counts()
    sfx = SUFFIX[backend]
    n_fr = N_FRAMES
    want = {"tape_replay_fwd": 3 * n_fr + 1, "tape_replay_fwd_bf16": 0, "tape_replay_fwd_frames": 1,
            "tape_replay_fwd_frames_bf16": 1, "tape_replay_fwd_frames_i8": 1, "tape_depth": 3 * n_fr,
            "tape_replay_bwd_frames": 1, "tape_replay_bwd_frames_bf16": 1, "tape_replay_bwd": 0,
            "warp_fwd": 2 * n_fr + 3 * n_fr, "repoint": 2 * n_fr + 3 * n_fr,
            "tape_stage" + sfx: 4 + tape_ops.ARENA_RERUNS["reruns"] - reruns, "tape_copy" + sfx: 4,
            "render_fwd" + sfx: 0, "first_hit" + sfx: 0}
    for k, n in want.items():
        check(counts[k] == n, f"dynamic tape path ({backend}): {k} launched {counts[k]} times, not {n}")
    check_bwd_widths(counts, f"dynamic tape path ({backend})")
    check_fwd_widths(counts, f"dynamic tape path ({backend})")
    if backend == "baked":
        check(counts["construct_tree_aabb"] == 2 * n_fr and counts["points_aabb"] == 0
              and counts["bake_refresh"] == 2,
              "dynamic tape path: the union pre-pass did not refresh the bake once per record, its box "
              "from the fused re-point")
    else:
        check_bake_counts(counts, backend, 0)
    with torch.no_grad():
        fused = r.render_dynamic_frames(feats, *rig, **kw)
        check(torch.equal(out["full"][0], fused[0]) and torch.equal(out["full"][1], fused[1]),
              f"uncompacted dynamic tape ({backend}): not render_dynamic_frames bit for bit")
        e_c = float((out["exact"][0] - fused[0]).abs().max())
        check(e_c <= 2e-6 and torch.equal(out["exact"][1], fused[1]),
              f"compacted dynamic tape ({backend}): {e_c} from render_dynamic_frames, or depths differ")
        r_nb = stt.VolumeRenderer(tree, backend=backend)
        r_nb.box_advance = r_nb.skip_boxes = 0
        fused_f = r_nb.render_dynamic_frames(feats, *rig, fast=True, **kw)
        e_f = float((out["fast"][0] - fused_f[0]).abs().max())
        check(e_f <= 2e-6 and torch.equal(out["fast"][1], fused_f[1]),
              f"fast dynamic tape ({backend}): {e_f} from the fused loop without box advance, or depths differ")
        cols, deps = out["exact"]
        check(tuple(cols.shape) == (N_FRAMES, HEIGHT, WIDTH, 4) and tuple(deps.shape) == (N_FRAMES, HEIGHT, WIDTH, 1)
              and bool(torch.isfinite(cols).all()) and bool((deps > 0).any()) and bool((cols[..., 3] == 0).any()),
              "dynamic tape frames: shapes, non-finite values, or no hit or no miss")
        opt = r._get_options(False)
        spec = r._render_spec()
        e_g = {}
        for kind, (x, o, gx) in grads.items():
            check(all(torch.equal(o[n], tape_ops.replay_forward_cuda(st_tape, x[n], opt, spec)[0]) for n in range(2)),
                  f"render_tape_frames {kind}: a frame is not K13c's bit for bit")
            check(gx.dtype == x.dtype and float(gx.float().abs().max()) > 0, f"{kind} stack gradient")
            err = atomic_err if kind == "f32" else bf16_grad_err
            e_g[kind] = max(err(gx[n], tape_ops.replay_backward_cuda(st_tape, x[n], opt, g2[n], o[n], spec),
                                f"render_tape_frames {kind} frame {n} vs K13d") for n in range(2))
        check(all(torch.equal(q_out[n], tape_ops.replay_forward_cuda(st_tape, q_frames[n], opt, spec)[0])
                  for n in range(2)), "render_tape_frames int8: a frame is not K13c's bit for bit")
        for v in range(len(cams)):
            check(torch.equal(rig_img[v], r.render_persp(feats, cams[v], WIDTH, HEIGHT, fx=FX)),
                  f"rig tape view {v} ({backend}): not render_persp bit for bit")
    print(f"main path, dynamic tapes ({LABEL[backend]}): launches {nonzero(counts)}; record "
          f"{res['record_ms']:.3f} ms ({tape.n_samples} cells of {tape.n_rays} rays); uncompacted frames equal "
          f"to render_dynamic_frames bit for bit, compacted {e_c:.3g}, fast {e_f:.3g} from it, depths bit for "
          f"bit; two-frame stacks' forwards (float32, bf16, int8; one launch each) equal to K13c per frame bit "
          f"for bit, gradients vs K13d {e_g['f32']:.3g} (bf16 {e_g['bf16']:.3g}); {len(cams)}-view "
          f"rig frame equal to render_persp bit for bit")
    # Host ms per frame, least of 3 calls: the tape passed in, and the way
    # bench.py calls it (recorded already: a cache hit, the animation's
    # tensors keyed by identity and version); and the host ms of one
    # `record_dynamic_persp` call that hits the cache (its key alone).
    with torch.no_grad():
        for label, fast, tp in (("explicit", False, tape), ("cached", False, None), ("cached_fast", True, None)):
            dts = []
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render_dynamic_tape_frames(feats * (1.0 + 1e-3 * i), *rig, tape=tp, fast=fast, **kw)
                torch.cuda.synchronize()
                dts.append((time.perf_counter() - t0) * 1e3 / N_FRAMES)
            res[label + "_frame_ms"] = min(dts[1:])
        dts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hit = r.record_dynamic_persp(c2w, *rig, WIDTH, HEIGHT, FX, record_t=True)
            torch.cuda.synchronize()
            dts.append((time.perf_counter() - t0) * 1e3)
            check(hit is tape, f"dynamic tapes ({backend}): record_dynamic_persp missed its cache")
        res["key_ms"] = min(dts[1:])
        tk = stt.get_transformation_matrix(rig[1], rig[0][0])
        warped, _ = stt.warp_vertices(tk, *rig[2:])
        table = tape_ops.pack_index_table(query_ops.construct_tree(tree._spec(), warped))
    print(f"main path, dynamic tapes ({LABEL[backend]}): host ms per frame (least of 3 calls of {N_FRAMES} frames, "
          f"exact, rotations and depth) with the tape passed in {res['explicit_frame_ms']:.4f}, through the cache "
          f"key {res['cached_frame_ms']:.4f} (fast {res['cached_fast_frame_ms']:.4f}); a record_dynamic_persp "
          f"call that hits the cache {res['key_ms']:.4f} ms")
    return dict(counts=counts, exact=out["exact"], ms=res, depth_case=(tape, table))


def dynamic_tape_times(make_bench_tree, bench_cloud, deep_state, bench7, c2w, dev, card) -> dict:
    """bench.py's temporal tape keys on the default bake, as bench.py times
    them (host clock, `float(outs.sum())` per call, least of 3 after a warm
    call, per frame). bench.py's dynamic cloud (`bench.py:676-772`,
    ``make_bench_tree`` its tree, baked as bench.py's fused frames leave
    it): `dynamic_tape_record_s` (a first `record_dynamic_persp`) and
    `dynamic_tape_record_warm_s` (again after clearing the cache);
    `dynamic_tape_frame_ms` and `dynamic_tape_fast_frame_ms` (four frames of
    `render_dynamic_tape_frames` per call). Its deep cloud (`bench.py:791-846`,
    `bench_deep_dynamic_cloud`: the depth-9 shell, its table reset and
    pointed at 40,000 points, step 1e-3): `deep9_dyn_record_s` (which bakes the
    re-pointed tree on the host, as bench.py's does), `deep9_dyn_tape_frame_ms`,
    `deep9_dyn_tape_mrays_s`. The headline depth-7 scene (``bench7``):
    `tape_fwd_bwd_ms`, a 16-frame stack's gradient through
    `replay_render_frames` (one launch of K13c's frame axis, one of K13e) per call, / 16, and
    `tape_fwd_bwd_mrays_s` (`bench.py:204-265`). The animation's arrays are
    NumPy, as bench.py passes them."""
    res = {}
    B = WIDTH * HEIGHT
    persp = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=BENCH_FX, update_tree=False)

    def timed_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def least(run):
        run(0)
        return min(timed_s(lambda: run(i + 1)) for i in range(3))

    args = [bench_cloud[k] for k in ("poses", "src_pose", "points", "skinning_weights", "joint_index")]
    n_fr = args[0].shape[0]
    feats = torch.from_numpy(bench_cloud["features"]).to(dev)
    tree = make_bench_tree()
    tree._baked_spec()
    r = stt.VolumeRenderer(tree)
    with torch.no_grad():
        rec = lambda: r.record_dynamic_persp(c2w, *args, WIDTH, HEIGHT, BENCH_FX)  # noqa: E731
        res["dynamic_tape_record_s"] = timed_s(rec)
        r._tape_cache.clear()
        res["dynamic_tape_record_warm_s"] = timed_s(rec)
        for fast, key in ((False, "dynamic_tape_frame_ms"), (True, "dynamic_tape_fast_frame_ms")):
            res[key] = least(lambda i: float(r.render_dynamic_tape_frames(
                feats * (1.0 + 1e-3 * i), *args, fast=fast, **persp).sum())) * 1e3 / n_fr
        deep = bench_deep_dynamic_cloud()
        dargs = [deep[k] for k in ("poses", "src_pose", "points", "skinning_weights", "joint_index")]
        dfeats = torch.from_numpy(deep["features"]).to(dev)
        dtree = stt.tree_from_numpy(dict(deep_state, data=np.full_like(deep_state["data"], stt.DATA_SENTINEL)),
                                    device=dev)
        dtree.construct_tree(deep["points"])
        dr = stt.VolumeRenderer(dtree, step_size=1e-3)
        res["deep9_dyn_record_s"] = timed_s(lambda: dr.record_dynamic_persp(c2w, *dargs, WIDTH, HEIGHT, BENCH_FX))
        dd_s = least(lambda i: float(dr.render_dynamic_tape_frames(
            dfeats * (1.0 + 1e-3 * i), *dargs, **persp).sum())) / dargs[0].shape[0]
        res["deep9_dyn_tape_frame_ms"] = dd_s * 1e3
        res["deep9_dyn_tape_mrays_s"] = B / dd_s / 1e6
        del dtree, dr
    t7 = stt.tree_from_numpy(bench7[0], device=dev)
    r7 = stt.VolumeRenderer(t7, step_size=1e-3)
    f7 = torch.from_numpy(bench7[1]).to(dev)
    tp7 = r7.record_persp(c2w, WIDTH, HEIGHT, BENCH_FX, features=f7, group_size=1)
    opt7 = r7._get_options(False)
    n_bwd = 16
    scales = 1.0 + 1e-7 * torch.arange(n_bwd, dtype=torch.float32, device=dev)

    def fwd_bwd(i):
        fs = (f7 * (1.0 + 1e-7 * (i + 1)))[None] * scales[:, None, None]
        fs.requires_grad_()
        (g,) = torch.autograd.grad(tape_ops.replay_render_frames(tp7, fs, opt7).sum(), fs)
        return float(g.sum())

    before = tape_ops.TAPE_REPLAY_BWD_FRAMES.launches
    bwd_s = least(fwd_bwd) / n_bwd
    check(tape_ops.TAPE_REPLAY_BWD_FRAMES.launches - before == 4, "tape_fwd_bwd: not one K13e per call")
    res["tape_fwd_bwd_ms"] = bwd_s * 1e3
    res["tape_fwd_bwd_mrays_s"] = B / bwd_s / 1e6
    print(f"bench.py temporal tape keys (default bake; host clock, synchronized, least of 3 calls after a warm "
          f"one): dynamic_tape_record_s {res['dynamic_tape_record_s']:.4f}, dynamic_tape_record_warm_s "
          f"{res['dynamic_tape_record_warm_s']:.4f}, dynamic_tape_frame_ms {res['dynamic_tape_frame_ms']:.4f}, "
          f"dynamic_tape_fast_frame_ms {res['dynamic_tape_fast_frame_ms']:.4f}; deep9_dyn_record_s "
          f"{res['deep9_dyn_record_s']:.4f}, deep9_dyn_tape_frame_ms {res['deep9_dyn_tape_frame_ms']:.4f}, "
          f"deep9_dyn_tape_mrays_s {res['deep9_dyn_tape_mrays_s']:.3f}; tape_fwd_bwd_ms "
          f"{res['tape_fwd_bwd_ms']:.4f}, tape_fwd_bwd_mrays_s {res['tape_fwd_bwd_mrays_s']:.3f} [{card}]")
    return res


def depth_census(tp, feats, sigma_thresh: float, table=None) -> dict:
    """What K13f reads on tape ``tp``: per ray the samples up to its first
    hit (all of its run without one), the resident ones among them (a sigma
    value each), and its hits (a t value each)."""
    B, n = tp.n_rays, tp.n_samples
    dev = tp.device
    rows = tp.idx if table is None else tape_ops._resolve_cells(table.reshape(-1), tp.idx)
    ok = (rows >= 0) & (rows < feats.shape[0])
    sigma = feats[torch.where(ok, rows, 0).long(), -1].float()
    pos = torch.arange(n, device=dev)
    ray = torch.repeat_interleave(torch.arange(B, device=dev), tp.counts.long())
    first = torch.full((B,), n, dtype=torch.long, device=dev).scatter_reduce(
        0, ray, torch.where(ok & (sigma > sigma_thresh), pos, n), "amin")
    found = first < n
    read = pos < torch.where(found, first + 1, tp.offsets[1:].long())[ray]
    return dict(rays=B, read=int(read.sum()), resident=int((read & ok).sum()), hits=int(found.sum()),
                indirect=table is not None, elem=POOL_ELEM[render_ops.pool_kind(feats)])


def tape_frames_bounds(c_b: dict, n: int, M: int, D: int, dc: dict) -> dict:
    """bound_ms and bound_by of K13c's frame axis, K13e and K13f. Over
    N_STACK frames of the bake's compacted exact tape (``n`` samples;
    ``c_b`` the bake's census) each reads the streams once (offsets, row
    and step, dscale and the view direction); K13c's frame axis N_STACK
    times K13c's rows (int8: with each frame's scale and zero) and output,
    with N_STACK times K13c's operations; K13e N_STACK times K13d's rows,
    output, output gradient and (M, D) float32 gradient, with N_STACK times
    K13d's operations. K13f
    on the tape of ``dc`` (`depth_census`): the offsets and dscale, the
    idx stream up to each ray's hit with a table entry each on an indirect
    tape, a sigma value per resident sample read, a t value per hit, and
    the (B,) output; a compare per sample read and a multiply per hit."""
    R, B = c_b["rows"], c_b["rays"]
    stream = (B + 1) * 4 + n * 8 + B * 16
    out = {}
    for kind, e in POOL_ELEM.items():
        psfx = "" if kind == "f32" else "_" + kind
        q = 8 * D if kind == "i8" else 0
        out["tape_replay_fwd_frames" + psfx] = (stream + N_STACK * (R * D * e + q + B * 16),
                                                 N_STACK * OPS_FWD_SH9 * c_b["contrib"])
        if kind == "i8":
            continue
        out["tape_replay_bwd_frames" + psfx] = (
            stream + N_STACK * (2 * B * 16 + R * D * e + M * D * 4), N_STACK * OPS_BWD_SH9 * c_b["contrib"])
    Bd = dc["rays"]
    out["tape_depth"] = ((Bd + 1) * 4 + Bd * 4 + dc["read"] * (8 if dc["indirect"] else 4)
                         + dc["resident"] * dc["elem"] + dc["hits"] * 4 + Bd * 4, dc["read"] + dc["hits"])
    return _bounds(out)


def tape_bounds(c: dict, c_b: dict, n_samples: dict, M: int, D: int, chunks: dict) -> dict:
    """bound_ms and bound_by of the tape kernels, from the SH9 camera
    march's census on each structure (``c`` the tree walk, ``c_b`` the
    bake) and the exact tapes' sample counts (``n_samples``; (structure
    suffix, fast, compact) -> samples). Each input read once, each output
    written once: K13a walks as K2 (its rays and the structure entries its
    samples touch; operations as the march's walk) and writes 8 bytes a
    ray, K15 in exact mode the same walk and 4 bytes a ray (its fast mode:
    `cost_bound`); K13b walks again, reads the offsets, and writes the compacted
    tape as the timed call records it (row, step and cell: 12 bytes a
    sample) and dscale; the one walk (tape_stage) walks as K13a and writes
    the counts, dscale, the staged samples (12 bytes a sample) and 8
    bytes of owner a chunk (``chunks``: structure suffix -> the chunks of
    the exact compacted tape); its copy (tape_copy) reads the staged
    samples, the owners and the offsets and writes the tape (on the bake
    also reading a src_map entry a sample); K13c reads the offsets, the row and step streams,
    dscale and the view direction, the rows its samples touch, and writes
    the output, with K2's compositing operations per contributing sample;
    K13d also reads the output and its gradient and writes the float32
    (M, D) gradient. The replay's pool instances read 2 or 1 bytes a
    value (int8 adds 8 bytes of scale and zero a column)."""
    out = {}
    for sfx, cc in (("", c), ("_baked", c_b)):
        B = cc["rays"]
        cell_b = 4 if cc["baked"] else 8
        if cc["baked"]:
            walk_ops = OPS_RAY * cc["hits"] + (OPS_LOOKUP + OPS_SAMPLE) * cc["samples"]
        else:
            walk_ops = OPS_RAY * cc["hits"] + OPS_LEVEL * cc["levels"] + OPS_SAMPLE * cc["samples"]
        n = n_samples[sfx, False, True]
        out["tape_count" + sfx] = (B * 24 + cc["cells"] * cell_b + B * 8, walk_ops)
        # K15 exact: K13a's walk, one count written (no sigma read).
        out["march_cost" + sfx] = (B * 24 + cc["cells"] * cell_b + B * 4, walk_ops)
        out["tape_record" + sfx] = (B * 24 + (B + 1) * 4 + cc["cells"] * cell_b + n * 12 + B * 4, walk_ops)
        out["tape_stage" + sfx] = (B * 24 + cc["cells"] * cell_b + B * 12 + n * 12 + chunks[sfx] * 8, walk_ops)
        out["tape_copy" + sfx] = (n * 12 + chunks[sfx] * 8 + (B + 1) * 4 + n * 12 + (n * 4 if cc["baked"] else 0),
                                  0)
    n, R, B = n_samples["_baked", False, True], c_b["rows"], c_b["rays"]
    stream = (B + 1) * 4 + n * 8 + B * 16
    for kind, e in POOL_ELEM.items():
        psfx = "" if kind == "f32" else "_" + kind
        q = 8 * D if kind == "i8" else 0
        out["tape_replay_fwd" + psfx] = (stream + R * D * e + q + B * 16, OPS_FWD_SH9 * c_b["contrib"])
        if kind != "i8":
            out["tape_replay_bwd" + psfx] = (stream + 2 * B * 16 + R * D * e + M * D * 4,
                                             OPS_BWD_SH9 * c_b["contrib"])
    return _bounds(out)


def tape_kernel_times(tp, specs: dict, feats, origins, dirs, opt, plain_ms: dict, kernels: dict, dev,
                      card: str) -> None:
    """Times of the tape kernels (CUDA events over KERNEL_REPS calls) on the
    depth-9 shell's camera rays, exact: K13a and K13b on each structure
    (``specs``: "" the tree walk, "_baked" the bake; the compacted tape
    with cells, as `record_tape` records it), K13c and K13d on the
    compacted tape ``tp`` with each pool instance, each beside the march
    kernel on the same rays in the same turn (K2, K3) and beside its width-1
    instance in turns (K13c's: the scalar row, a column at a time; K13d's:
    the earlier design); plain: one call, phase 3g."""
    M = feats.shape[0]
    with torch.no_grad():
        for sfx, spec in specs.items():
            n_occ, _ = tape_ops.count_samples_cuda(spec, M, origins, dirs, opt)
            offsets = torch.zeros(n_occ.shape[0] + 1, dtype=torch.int32, device=dev)
            offsets[1:] = torch.cumsum(n_occ, 0)
            c_ms = time_ms(lambda: tape_ops.count_samples_cuda(spec, M, origins, dirs, opt), KERNEL_REPS)
            r_ms = time_ms(lambda: tape_ops.record_samples_cuda(spec, M, origins, dirs, opt, offsets, True,
                                                                True, True, False), KERNEL_REPS)
            k2_ms = time_ms(lambda: render_ops.volume_render_cuda(spec, feats, origins, dirs, dirs, opt),
                            KERNEL_REPS)
            kernels["tape_count" + sfx].update(ms=c_ms, plain_ms=plain_ms["tape_count" + sfx, False])
            kernels["tape_record" + sfx].update(ms=r_ms, plain_ms=plain_ms["tape_record" + sfx, False, True])
            print(f"time tape_count{sfx} / tape_record{sfx} (SH9 exact {WIDTH}x{HEIGHT}, compacted, "
                  f"{tp.n_samples} samples): kernel {c_ms:.4f} / {r_ms:.4f} ms (K2 on the same rays "
                  f"{k2_ms:.4f} ms), plain {plain_ms['tape_count' + sfx, False]:.1f} / "
                  f"{plain_ms['tape_record' + sfx, False, True]:.1f} ms (one call, phase 3g) [{card}]")
            # The one walk and its copy, each alone, and the whole recording
            # in turns with the earlier pair's as its record_tape launched
            # it, host reads included: CUDA events over wrapper calls
            # (tools/tape_record_ab.py times the kernels alone, L2 cold).
            st = tape_ops.stage_samples_cuda(spec, M, origins, dirs, opt, True)
            n_chunks, total = int(st.n_chunks[0]), int(offsets[-1])

            def pair_tape():
                n_o, _ = tape_ops.count_samples_cuda(spec, M, origins, dirs, opt)
                offs = torch.zeros(n_o.shape[0] + 1, dtype=torch.int64, device=dev)
                offs[1:] = torch.cumsum(n_o.long(), 0)
                tape_ops.record_samples_cuda(spec, M, origins, dirs, opt, offs.to(torch.int32), True)
                return int(n_o.max())

            def one_walk():
                return tape_ops.record_streams(spec, M, origins, dirs, opt, True)

            reruns = tape_ops.ARENA_RERUNS["reruns"]
            s_ms = time_ms(lambda: tape_ops.stage_samples_cuda(spec, M, origins, dirs, opt, True), KERNEL_REPS)
            cp_ms = time_ms(lambda: tape_ops.copy_samples_cuda(spec, opt, st, n_chunks, offsets, total),
                            KERNEL_REPS)
            new_ms, old_ms = in_turns(one_walk, pair_tape, lambda fn: time_ms(fn, KERNEL_REPS))
            check(tape_ops.ARENA_RERUNS["reruns"] == reruns, f"tape_stage{sfx}: the deep camera's arena ran short")
            kernels["tape_stage" + sfx].update(ms=s_ms, plain_ms=plain_ms["tape_stage" + sfx], prev_ms=old_ms)
            kernels["tape_copy" + sfx].update(ms=cp_ms, plain_ms=plain_ms["tape_copy" + sfx])
            print(f"time tape_stage{sfx} / tape_copy{sfx} (the same rays, {n_chunks} chunks of "
                  f"{tape_ops.ARENA_CHUNK}): kernel {s_ms:.4f} / {cp_ms:.4f} ms, plain "
                  f"{plain_ms['tape_stage' + sfx]:.1f} / {plain_ms['tape_copy' + sfx]:.1f} ms; a recording in turns "
                  f"(walk, cumsum, one host copy, copy against count, cumsum, record, three host reads): "
                  f"{new_ms:.4f} / {old_ms:.4f} ms ({old_ms / new_ms:.3f}x) [{card}]")
            del st
        spec = specs["_baked"]
        k2_ms = time_ms(lambda: render_ops.volume_render_cuda(spec, feats, origins, dirs, dirs, opt), KERNEL_REPS)
        out = tape_ops.replay_forward_cuda(tp, feats, opt, spec)[0]
        g = torch.from_numpy(np.random.RandomState(14).randn(*out.shape).astype(np.float32)).to(dev)
        for kind in ("f32", *POOL_KINDS):
            psfx = "" if kind == "f32" else "_" + kind
            pool = feats if kind == "f32" else pool_of(kind, feats)[0]
            f_ms, f1_ms = in_turns(lambda: tape_ops.replay_forward_cuda(tp, pool, opt, spec),
                                   lambda: tape_ops.replay_forward_cuda(tp, pool, opt, spec, width=1),
                                   lambda fn: time_ms(fn, KERNEL_REPS))
            m_ms = time_ms(lambda: render_ops.volume_render_cuda(spec, pool, origins, dirs, dirs, opt),
                           KERNEL_REPS)
            p_ms = plain_ms["tape_replay_fwd", "_baked", False, True] if kind == "f32" else \
                plain_ms["tape_replay_fwd" + psfx, "_baked"]
            kernels["tape_replay_fwd" + psfx].update(ms=f_ms, plain_ms=p_ms, prev_ms=f1_ms)
            line = (f"time tape_replay_fwd{psfx} (SH9 exact {WIDTH}x{HEIGHT}, {tp.n_samples} samples): kernel "
                    f"{f_ms:.4f} ms, its width-1 instance (the scalar row) {f1_ms:.4f} ms in turns "
                    f"({f1_ms / f_ms:.3f}x), K2 on the bake{psfx and ' ' + kind} {m_ms:.4f} ms in the same turn "
                    f"({m_ms / f_ms:.3f}x), plain {p_ms:.1f} ms")
            if kind != "i8":
                b_ms, b1_ms = in_turns(
                    lambda: tape_ops.replay_backward_cuda(tp, pool, opt, g, out, spec),
                    lambda: tape_ops.replay_backward_cuda(tp, pool, opt, g, out, spec, width=1),
                    lambda fn: time_ms(fn, KERNEL_REPS))
                k3_ms = time_ms(lambda: render_ops.volume_render_backward_cuda(
                    spec, pool, origins, dirs, dirs, g, opt, out_res=out), KERNEL_REPS)
                bp_ms = plain_ms["tape_replay_bwd" + psfx, "_baked", True]
                kernels["tape_replay_bwd" + psfx].update(ms=b_ms, plain_ms=bp_ms, prev_ms=b1_ms)
                line += (f"; tape_replay_bwd{psfx} kernel {b_ms:.4f} ms, its width-1 instance (the earlier "
                         f"design) {b1_ms:.4f} ms in turns ({b1_ms / b_ms:.3f}x), "
                         f"K3 {k3_ms:.4f} ms ({k3_ms / b_ms:.3f}x), plain {bp_ms:.1f} ms")
            print(line + f" (plain: one call, phase 3g) [{card}]")
        if tp.n_samples:
            full = tape_ops.record_tape(spec, M, origins, dirs, dirs, opt, compact=False)
            u_ms = time_ms(lambda: tape_ops.replay_forward_cuda(full, feats, opt, spec), KERNEL_REPS)
            print(f"time tape_replay_fwd on the uncompacted tape ({full.n_samples} samples): {u_ms:.4f} ms "
                  f"(K2 {k2_ms:.4f} ms) [{card}]")


def tape_frames_kernel_times(tp, spec, feats, origins, dirs, opt, depth_case, plain_ms: dict, kernels: dict,
                             dev, card: str) -> dict:
    """Times of K13c's frame axis, K13e and K13f (CUDA events over
    KERNEL_REPS calls). K13c's frame axis on N_STACK pools (float32, bf16,
    int8) over the bake's compacted exact tape ``tp``, beside its width-1
    instance (the scalar row) in turns and N_STACK single K13c calls
    in the same turn. K13e on
    N_STACK pools (float32, bf16) over the bake's compacted exact tape
    ``tp``, beside its width-1 instance (the earlier design) in turns,
    N_STACK K13d calls, one K13d call and one K3 call on the
    first pool in the same turn (K13d / K3 is the ratio that says whether
    the frame axis moved K13d). K13f on the main path's tape (``depth_case``:
    phase 4m's compacted dynamic tape on the bake and frame 0's index
    table), and on ``tp`` beside K9b's first-hit kernel on the same rays.
    Plain: one call (K13e's from phase 3g). Returns K13f's census on the
    main path's tape (`depth_census`)."""
    with torch.no_grad():
        for psfx, kind in (("", "f32"), ("_bf16", "bf16"), ("_i8", "i8")):
            stack, frames = stack_of(kind, [feats * (1.0 + 0.1 * n) for n in range(N_STACK)])
            a_ms, a1_ms = in_turns(lambda: tape_ops.replay_forward_frames_cuda(tp, stack, opt, spec),
                                   lambda: tape_ops.replay_forward_frames_cuda(tp, stack, opt, spec, width=1),
                                   lambda fn: time_ms(fn, KERNEL_REPS))
            n_ms = time_ms(lambda: [tape_ops.replay_forward_cuda(tp, f, opt, spec) for f in frames], KERNEL_REPS)
            p_ms = plain_ms["tape_replay_fwd_frames" + psfx]
            kernels["tape_replay_fwd_frames" + psfx].update(ms=a_ms, plain_ms=p_ms, prev_ms=a1_ms)
            print(f"time tape_replay_fwd_frames{psfx} (SH9 exact {WIDTH}x{HEIGHT}, {N_STACK} frames, "
                  f"{tp.n_samples} samples): kernel {a_ms:.4f} ms, its width-1 instance (the scalar row) "
                  f"{a1_ms:.4f} ms in turns ({a1_ms / a_ms:.3f}x), {N_STACK} K13c calls {n_ms:.4f} ms "
                  f"({n_ms / a_ms:.3f}x) in the same turn; plain {p_ms:.1f} ms (one call, phase 3g) [{card}]")
            del stack, frames
        for psfx, dtype in (("", torch.float32), ("_bf16", torch.bfloat16)):
            stack = torch.stack([feats * (1.0 + 0.1 * n) for n in range(N_STACK)]).to(dtype)
            outs = tape_ops.replay_forward_frames_cuda(tp, stack, opt, spec)
            g = torch.from_numpy(np.random.RandomState(16).randn(*outs.shape).astype(np.float32)).to(dev)
            e_ms, e1_ms = in_turns(
                lambda: tape_ops.replay_backward_frames_cuda(tp, stack, opt, g, outs, spec),
                lambda: tape_ops.replay_backward_frames_cuda(tp, stack, opt, g, outs, spec, width=1),
                lambda fn: time_ms(fn, KERNEL_REPS))
            d_ms = time_ms(lambda: [tape_ops.replay_backward_cuda(tp, stack[n], opt, g[n], outs[n], spec)
                                    for n in range(N_STACK)], KERNEL_REPS)
            one_ms = time_ms(lambda: tape_ops.replay_backward_cuda(tp, stack[0], opt, g[0], outs[0], spec),
                             KERNEL_REPS)
            k3_ms = time_ms(lambda: render_ops.volume_render_backward_cuda(
                spec, stack[0], origins, dirs, dirs, g[0], opt, out_res=outs[0]), KERNEL_REPS)
            p_ms = plain_ms["tape_replay_bwd_frames" + psfx]
            kernels["tape_replay_bwd_frames" + psfx].update(ms=e_ms, plain_ms=p_ms, prev_ms=e1_ms)
            print(f"time tape_replay_bwd_frames{psfx} (SH9 exact {WIDTH}x{HEIGHT}, {N_STACK} frames, "
                  f"{tp.n_samples} samples): kernel {e_ms:.4f} ms, its width-1 instance (the earlier design) "
                  f"{e1_ms:.4f} ms in turns ({e1_ms / e_ms:.3f}x), {N_STACK} K13d calls {d_ms:.4f} ms "
                  f"({d_ms / e_ms:.3f}x) in the same turn; one K13d {one_ms:.4f} ms, K3 {k3_ms:.4f} ms "
                  f"(K13d / K3 {one_ms / k3_ms:.4f}); plain {p_ms:.1f} ms (one call, phase 3g) [{card}]")
            del stack, outs, g
        dtp, table = depth_case
        d_ms = time_ms(lambda: tape_ops.replay_depth_cuda(dtp, feats, opt.sigma_thresh, table), KERNEL_REPS)
        _, dp_ms = timed_once_ms(lambda: tape_ops.replay_depth_plain(dtp, feats, opt.sigma_thresh, table))
        s_ms = time_ms(lambda: tape_ops.replay_depth_cuda(tp, feats, opt.sigma_thresh), KERNEL_REPS)
        fh_ms = time_ms(lambda: aux_ops.first_hit_cuda(spec, feats, origins, dirs, opt), KERNEL_REPS)
        kernels["tape_depth"].update(ms=d_ms, plain_ms=dp_ms)
        print(f"time tape_depth (exact {WIDTH}x{HEIGHT}): the main path's indirect tape ({dtp.n_samples} cells, "
              f"frame 0's table) kernel {d_ms:.4f} ms, plain {dp_ms:.1f} ms (one call); the bake's direct tape "
              f"({tp.n_samples} samples) {s_ms:.4f} ms, K9b's first hit on the bake's rays {fh_ms:.4f} ms in "
              f"the same turn, plain {plain_ms['tape_depth', '_baked', False, True]:.1f} ms (phase 3g) [{card}]")
        return depth_census(dtp, feats, opt.sigma_thresh, table)


def minibatch_scene(dev) -> dict:
    """bench.py's minibatch cell (`bench.py:314-336`) on its headline
    configuration (`bench.py:40-59`): the depth-7 SH9 shell under
    `VolumeRenderer(tree, step_size=1e-3)` (the default bake), a MB_VIEWS-view
    rig of `orbit_camera(theta=0.9 v, phi=0.3 + 0.1 v)` at WIDTH x HEIGHT, fx
    BENCH_FX, recorded by `record_persp_rig` (compacted), and the targets: the
    rig's replay of the true pool, its colour columns."""
    st_, f_np, _ = build_shell_tree(depth=7, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(st_, device=dev)
    r = stt.VolumeRenderer(tree, step_size=1e-3)
    f0 = torch.from_numpy(f_np).to(dev)
    c2ws = np.stack([orbit_camera(theta=0.9 * v, phi=0.3 + 0.1 * v) for v in range(MB_VIEWS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rig = r.record_persp_rig(c2ws, WIDTH, HEIGHT, fx=BENCH_FX, features=f0)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    spec, opt = r._render_spec(), r._get_options(False)
    with torch.no_grad():
        tgt = stt.replay_render(rig, f0, opt, spec)[:, :3].contiguous()
    return dict(tree=tree, r=r, f0=f0, c2ws=c2ws, rig=rig, spec=spec, opt=opt, tgt=tgt, record_s=record_s)


def grid_scene(centers_np, sigma_np, dev) -> dict:
    """K12 at full width: the depth-9 shell's sigma on its own (2^DEPTH)^3
    grid (`dense_density_grid`: each occupied leaf's sigma at its cell, 0
    elsewhere), the WIDTH x HEIGHT orbit camera at FX, exact options
    (step_size 1e-3, max_steps 1024), world space = grid space."""
    reso = 2 ** DEPTH
    data = torch.from_numpy(dense_density_grid(centers_np, sigma_np, reso)).to(dev)
    cam = stt.CameraSpec(c2w=torch.as_tensor(orbit_camera(), device=dev), fx=FX, fy=FX, width=WIDTH,
                         height=HEIGHT)
    opt = stt.RenderOptions(step_size=1e-3)
    offset = torch.zeros(3, device=dev)
    scaling = torch.ones(3, device=dev)
    origins, dirs = render_ops.cam2world_rays(cam.c2w, WIDTH, HEIGHT, FX, FX)
    return dict(data=data, cam=cam, opt=opt, offset=offset, scaling=scaling,
                origins=origins.contiguous(), dirs=dirs.contiguous(), shell=(centers_np, sigma_np))


def grid_ball_scene(g: dict, centers_np, sigma_np) -> dict:
    """``g`` (`grid_scene`) with a solid ball for its grid: every voxel whose
    centre lies within the shell's outer radius (the farthest occupied leaf
    centre from the grid's centre) at the shell's median sigma. A dense
    scene, where K12's occupancy mask saves little."""
    data = g["data"]
    reso = data.shape[0]
    r_out = float(np.linalg.norm(np.asarray(centers_np, np.float64) - 0.5, axis=1).max())
    c = (torch.arange(reso, dtype=torch.float32, device=data.device) + 0.5) / reso - 0.5
    d2 = (c[:, None, None] ** 2 + c[None, :, None] ** 2) + c[None, None, :] ** 2
    ball = torch.zeros_like(data)
    ball[d2 <= r_out ** 2] = float(np.median(sigma_np))
    return dict(g, data=ball)


def grid_nan_scene(g: dict) -> dict:
    """``g`` (`grid_scene`) with a seeded GRID_NAN_RESO^3 grid for its grid:
    3% of the voxels dense, 1% NaN, 1% -inf and 1% at the threshold (the
    edge bricks partial, the occupancy pass's scalar path)."""
    rng = np.random.RandomState(11)
    n = GRID_NAN_RESO
    data = np.where(rng.rand(n, n, n) < 0.03, rng.rand(n, n, n) * 50, 0).astype(np.float32)
    u = rng.rand(n, n, n)
    data[u < 0.01] = np.nan
    data[(u >= 0.01) & (u < 0.02)] = -np.inf
    data[(u >= 0.02) & (u < 0.03)] = g["opt"].sigma_thresh
    return dict(g, data=torch.from_numpy(data).to(g["data"].device))


def grid_census(g: dict) -> dict:
    """What K12 reads and does on ``g`` (`grid_scene`), from its masked
    march's mirror (`ops.grid.grid_march_mirror`, held to the plain
    version bit for bit): the rays, the samples taken, the distinct voxels
    they read, the sigma loads in marked bricks and their distinct voxels,
    the contributing samples, the marked bricks, the warps' iterations."""
    args = (g["data"], g["origins"], g["dirs"], g["offset"], g["scaling"], g["opt"])
    mw, mh, census = grid_ops.grid_march_mirror(*args, width=WIDTH)
    pw, ph = grid_ops.grid_weight_plain(*args)
    check(torch.equal(mw, pw) and torch.equal(mh, ph), "grid_march_mirror: not the plain version")
    return census


def subset_kernel_phase(mb: dict, g: dict, kernels: dict, dev, card: str) -> dict:
    """Phase 3h (K14, K12): each new kernel against its plain version at the
    main paths' shapes, then its time: the kernels' from the profiler
    with L2 flushed (`device_ms`; warm, and their CUDA-event time, the
    host's dispatch rate, printed beside it); the plain version's (one
    call) and, for K14c, the PyTorch call's (`pool.add_(grad,
    alpha=-lr)`, timed alike). K14a on a B_MB-ray with-replacement
    subset of the rig tape (duplicate ids included), compacted and not,
    with the cell stream, bit for bit (timed as training gathers: row and
    step streams); K14b on that subset's replay against the rig targets
    bit for bit (nonzero), its loss within LOSS_RTOL relative; K14c with
    K13d's float32 gradient of that loss and a seeded unit-scale one, bit
    for bit; K12 on ``g`` (`grid_scene`), both outputs bit for bit, timed
    alone by the profiler and with its outputs' zeroing by CUDA events.
    Returns the census of the bounds."""
    t_3h = time.perf_counter()
    rig, spec, opt, tgt, f0 = mb["rig"], mb["spec"], mb["opt"], mb["tgt"], mb["f0"]
    rng = np.random.RandomState(8)
    ids_np = rng.randint(0, rig.n_rays, B_MB)
    ids_np[:16] = ids_np[16:32]  # duplicates, certain
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    plain_ms = {}
    full = mb["r"].record_persp_rig(mb["c2ws"], WIDTH, HEIGHT, fx=BENCH_FX, features=f0, compact=False)
    for label, tp in (("compacted", rig), ("uncompacted", full)):
        src = subset_ops.TapeRowSource(tp, keep_cells=True)
        offsets = torch.from_numpy(subset_ops._subset_plan(src, ids_np)[1]).to(dev)
        got = subset_ops.subset_gather_cuda(tp, ids, offsets, False, True, True)
        want, p_ms = timed_once_ms(lambda: subset_ops.subset_gather_plain(tp, ids, offsets, False, True, True))
        for name, a, b_ in zip(got._fields, got, want):
            check((a is None) == (b_ is None) and (a is None or torch.equal(a, b_)),
                  f"subset_gather ({label}): {name} differs from plain")
        print(f"subset_gather ({label} rig tape, {tp.n_samples} samples; {B_MB} ids, duplicates included; "
              f"row, step and cell streams, rays): {got.idx.shape[0]} samples, equal to plain bit for bit")
        plain_ms[label] = p_ms
    del full, got, want
    src = subset_ops.TapeRowSource(rig)
    offsets_np = subset_ops._subset_plan(src, ids_np)[1]
    offsets = torch.from_numpy(offsets_np).to(dev)
    n_sub = int(offsets_np[-1])
    call = lambda: subset_ops.subset_gather_cuda(rig, ids, offsets, False, False, False, n_sub)  # noqa: E731
    k_ms, w_ms = device_ms(call, KERNEL_REPS, ("gather_kernel",)), \
        device_ms(call, KERNEL_REPS, ("gather_kernel",), cold=False)
    e_ms = time_ms(call, KERNEL_REPS)
    _, p_ms = timed_once_ms(lambda: subset_ops.subset_gather_plain(rig, ids, offsets, False, False, False))
    kernels["subset_gather"].update(ms=k_ms, plain_ms=p_ms, max_abs_err=0.0, library_ms=None)
    print(f"time subset_gather ({B_MB} rays, {n_sub} samples, row and step streams as training gathers): "
          f"kernel {k_ms:.4f} ms on the card (profiler, L2 cold; warm {w_ms:.4f}), {e_ms:.4f} ms a call back "
          f"to back (CUDA events), plain {p_ms:.2f} ms (one call) [{card}]")

    # K14b on the subset's replay; K14c with K13d's gradient of that loss.
    sub = subset_ops.subset_tape(src, ids_np, with_rays=False)
    pool = (f0 * 0.9).contiguous()
    with torch.no_grad():
        out = tape_ops.replay_forward_cuda(sub, pool, opt, spec)[0]
    W, inv_bw = 3, 1.0 / (B_MB * 3)
    g_k, l_k = subset_ops.l2_cotangent_cuda(out, tgt, ids, W, inv_bw)
    (g_p, l_p), p_ms = timed_once_ms(lambda: subset_ops.l2_cotangent_plain(out, tgt, ids, W, inv_bw))
    e = float((g_k - g_p).abs().max())
    l_err = abs(float(l_k) - float(l_p))
    check(torch.equal(g_k, g_p) and bool(g_p[:, :W].any()) and float(l_p) > 0
          and l_err <= LOSS_RTOL * float(l_p), f"l2_cotangent: grad {e}, loss {float(l_k)} vs {float(l_p)}")
    call = lambda: subset_ops.l2_cotangent_cuda(out, tgt, ids, W, inv_bw)  # noqa: E731
    names = ("cotangent_kernel", "loss_kernel")
    k_ms, w_ms = device_ms(call, KERNEL_REPS, names), device_ms(call, KERNEL_REPS, names, cold=False)
    e_ms = time_ms(call, KERNEL_REPS)
    kernels["l2_cotangent"].update(ms=k_ms, plain_ms=p_ms, max_abs_err=e, library_ms=None)
    print(f"l2_cotangent ({B_MB} rows, W {W}): grad max_abs_err {e:.3g}, loss {float(l_k):.8g} vs plain "
          f"{float(l_p):.8g}; kernels {k_ms:.4f} ms on the card (profiler, both passes, L2 cold; warm "
          f"{w_ms:.4f}), {e_ms:.4f} ms a call back to back, plain {p_ms:.2f} ms (one call) [{card}]")
    # K13d at the minibatch step's shape: the vector instance the step
    # launches and the width-1 one (the earlier design), each against plain
    # on a seeded unit-scale cotangent (the loss's own, g_k, is about 1e-8,
    # below the atomic tolerance's absolute floor), then timed in turns on
    # g_k, L2 cold and warm (a step finds the pool in L2).
    grad = tape_ops.replay_backward_cuda(sub, pool, opt, g_k, out, spec)
    g_c = torch.from_numpy(np.random.RandomState(11).randn(*out.shape).astype(np.float32)).to(dev)
    bwd_p, bp_ms = timed_once_ms(lambda: tape_ops.replay_backward_plain(sub, pool, opt, g_c, out, spec))
    check(float(bwd_p.abs().max()) > 0, "tape_replay_bwd (minibatch subset): zero plain gradient")
    e_b = max(atomic_err(tape_ops.replay_backward_cuda(sub, pool, opt, g_c, out, spec, width=w), bwd_p,
                         f"tape_replay_bwd width {w} (minibatch subset)") for w in (4, 1))
    mb_bwd = {}
    for cold in (True, False):
        mb_bwd[cold] = in_turns(lambda: tape_ops.replay_backward_cuda(sub, pool, opt, g_k, out, spec),
                                lambda: tape_ops.replay_backward_cuda(sub, pool, opt, g_k, out, spec, width=1),
                                lambda fn: device_ms(fn, KERNEL_REPS, ("replay_bwd_kernel",), cold=cold))
    print(f"time tape_replay_bwd at the minibatch step's shape ({B_MB} rays, {sub.n_samples} samples; widths 4 "
          f"and 1 vs plain {e_b:.3g} on a unit cotangent, max|plain| {float(bwd_p.abs().max()):.4g}): kernel "
          f"{mb_bwd[True][0]:.4f} ms on the card (profiler, L2 cold; warm "
          f"{mb_bwd[False][0]:.4f}), its width-1 instance (the earlier design) {mb_bwd[True][1]:.4f} (warm "
          f"{mb_bwd[False][1]:.4f}) in turns ({mb_bwd[True][1] / mb_bwd[True][0]:.3f}x cold, "
          f"{mb_bwd[False][1] / mb_bwd[False][0]:.3f}x warm); plain {bp_ms:.2f} ms (one call) [{card}]")
    del bwd_p, g_c
    # K13c at the minibatch step's shape: widths 4 and 1 equal to each other
    # and to the forward march K2 on the subset's rays bit for bit (float32,
    # bf16 and int8 pools), against plain; then timed in turns, L2 cold and
    # warm, beside the subset's byte bound (streams, the distinct rows it
    # reads, its rays' dscale and direction, its output).
    sub_r = subset_ops.subset_tape(src, ids_np)
    for kind, p_ in (("f32", pool), *((k_, pool_of(k_, pool)[0]) for k_ in POOL_KINDS)):
        o4 = tape_ops.replay_forward_cuda(sub_r, p_, opt, spec)[0]
        check(torch.equal(o4, tape_ops.replay_forward_cuda(sub_r, p_, opt, spec, width=1)[0])
              and torch.equal(o4, render_ops.volume_render_cuda(spec, p_, sub_r.origins, sub_r.dirs, sub_r.vdirs,
                                                                opt)),
              f"tape_replay_fwd {kind} (minibatch subset): widths 4 and 1 and K2 not equal bit for bit")
        check(torch.equal(o4, out) if kind == "f32" else True, "tape_replay_fwd (minibatch subset): not the step's")
    fwd_p, fp_ms = timed_once_ms(lambda: tape_ops.replay_forward_plain(sub, pool, opt, spec)[0])
    e_f = float((out - fwd_p).abs().max())
    check(e_f <= RENDER_ATOL, f"tape_replay_fwd (minibatch subset): kernel vs plain {e_f}")
    rows = sub.idx.long()
    rows = rows[(rows >= 0) & (rows < pool.shape[0])]
    n_rows = int(torch.unique(rows).numel())
    n_contrib = int((pool[rows, -1] > opt.sigma_thresh).sum())
    sub_bytes = (B_MB + 1) * 4 + sub.n_samples * 8 + B_MB * 16 + n_rows * pool.shape[1] * 4 + B_MB * 16
    sub_bound, sub_by = bound(sub_bytes, OPS_FWD_SH9 * n_contrib)
    mb_fwd = {}
    for cold in (True, False):
        mb_fwd[cold] = in_turns(lambda: tape_ops.replay_forward_cuda(sub, pool, opt, spec),
                                lambda: tape_ops.replay_forward_cuda(sub, pool, opt, spec, width=1),
                                lambda fn: device_ms(fn, KERNEL_REPS, ("replay_fwd_kernel",), cold=cold))
    print(f"time tape_replay_fwd at the minibatch step's shape ({B_MB} rays, {sub.n_samples} samples, {n_rows} "
          f"distinct rows; widths 4 and 1 equal bit for bit to each other and to K2 on the subset's rays, float32, "
          f"bf16 and int8; vs plain {e_f:.3g}): kernel {mb_fwd[True][0]:.4f} ms on the card (profiler, L2 cold; "
          f"warm {mb_fwd[False][0]:.4f}), its width-1 instance (the scalar row) {mb_fwd[True][1]:.4f} (warm "
          f"{mb_fwd[False][1]:.4f}) in turns ({mb_fwd[True][1] / mb_fwd[True][0]:.3f}x cold, "
          f"{mb_fwd[False][1] / mb_fwd[False][0]:.3f}x warm); bound {sub_bound:.5f} ms ({sub_by}; "
          f"{sub_bytes / 1e6:.2f} MB), {sub_bound / mb_fwd[True][0]:.3f} of it cold; plain {fp_ms:.2f} ms (one "
          f"call) [{card}]")
    del sub_r, fwd_p, rows
    # K13d's gradient of this loss is below a bf16 ulp of most rows, so a
    # seeded unit-scale gradient also runs, whose update moves every row.
    g_unit = torch.from_numpy(np.random.RandomState(10).randn(*pool.shape).astype(np.float32)).to(dev)
    for gg in (g_unit, grad):
        got = subset_ops.sgd_cuda(pool.clone(), gg, MB_LR)
        want, p_ms = timed_once_ms(lambda: subset_ops.sgd_plain(pool.clone(), gg, MB_LR))
        check(torch.equal(got, want), "sgd_update: kernel and plain differ")
        check(gg is grad or bool((got != pool).any()), "sgd_update: the unit gradient moved nothing")
    # K14c against the one PyTorch call of the same function in turns,
    # K14C_PAIRS rounds L2 cold and warm: the medians and the spread of the
    # rounds' ratios (the earlier scalar kernel is gone; its times stay in
    # PERF.md).
    work = pool.clone()
    call = lambda: subset_ops.sgd_cuda(work, grad, MB_LR)  # noqa: E731
    lib = lambda: work.add_(grad, alpha=-MB_LR)  # noqa: E731
    sgd = {}
    for cold in (True, False):
        pairs = paired_device_ms(call, lib, ("sgd_f32",), K14C_PAIRS, cold)
        ratios = sorted(k / lb for k, lb in pairs)
        sgd[cold] = (statistics.median(k for k, _ in pairs), statistics.median(lb for _, lb in pairs), ratios)
    (k_ms, lib_ms, r_cold), (w_ms, lw_ms, r_warm) = sgd[True], sgd[False]
    e_ms, le_ms = time_ms(call, KERNEL_REPS), time_ms(lib, KERNEL_REPS)
    kernels["sgd_update"].update(ms=k_ms, plain_ms=p_ms, max_abs_err=0.0, library_ms=lib_ms)
    spread = lambda r: (f"median {statistics.median(r):.3f}, rounds {r[0]:.3f}-{r[-1]:.3f}, "  # noqa: E731
                        f"{sum(x < 1 for x in r)} of {len(r)} below 1")
    print(f"time sgd_update (float32 pool {tuple(pool.shape)}): kernel {k_ms:.4f} ms on the card "
          f"(profiler, L2 cold, median of {K14C_PAIRS} rounds; warm {w_ms:.4f}), {e_ms:.4f} ms a call back to "
          f"back; pool.add_(grad, alpha=-lr) {lib_ms:.4f} ms (warm {lw_ms:.4f}; {le_ms:.4f} back to back); "
          f"kernel / pool.add_ in turns: {spread(r_cold)} cold; {spread(r_warm)} warm; plain {p_ms:.2f} ms "
          f"(one call) [{card}]")
    pool_elems = pool.numel()
    del sub, out, g_k, g_p, grad, got, want, work, g_unit

    # K12 on the depth-9 shell's density grid (a), a solid ball (b) and a
    # seeded grid with NaN and -inf sigmas: the occupancy pass and the
    # march, each against its plain version bit for bit.
    t_k12 = time.perf_counter()
    for label, gg in (("shell", g), ("ball", grid_ball_scene(g, *g["shell"])), ("nan", grid_nan_scene(g))):
        args = (gg["data"], gg["origins"], gg["dirs"], gg["offset"], gg["scaling"], gg["opt"])
        mask = grid_ops.grid_occupancy_cuda(gg["data"], gg["opt"].sigma_thresh)
        want_mask, mask_ms = timed_once_ms(lambda: grid_ops.grid_occupancy_plain(gg["data"], gg["opt"].sigma_thresh))
        check(torch.equal(mask, want_mask), f"grid_occupancy ({label}): kernel and plain differ")
        gw, gh = grid_ops.grid_weight_cuda(*args, width=WIDTH)
        (pw, ph), p_ms = timed_once_ms(lambda: grid_ops.grid_weight_plain(*args))
        check(torch.equal(gw, pw) and torch.equal(gh, ph), f"grid_weight ({label}): kernel and plain differ")
        n_marked = int((((mask.long() & 0xFFFFFFFF)[:, None] >> torch.arange(32, device=dev)) & 1).sum())
        print(f"grid_weight ({label}, {gg['data'].shape[0]}^3 grid, {gg['origins'].shape[0]} rays): mask "
              f"({n_marked} bricks of {grid_ops.GRID_BRICK}^3 marked) and weights and hits equal to plain bit "
              f"for bit ({int((gh > 0).sum())} voxels hit, {float(gh.sum()):.0f} hits, max weight "
              f"{float(gw.max()):.6f})")
        if label == "shell":
            call = lambda: grid_ops.grid_weight_cuda(*args, width=WIDTH)  # noqa: E731
            occ_ms = device_ms(call, KERNEL_REPS, ("occupancy_kernel",))
            k_ms = device_ms(call, KERNEL_REPS, ("grid_kernel",))
            both_ms = device_ms(call, KERNEL_REPS, ("occupancy_kernel", "grid_kernel"))
            z_ms = time_ms(call, KERNEL_REPS)
            whole_ms = queued_ms(call, KERNEL_REPS)
            kernels["grid_weight"].update(ms=k_ms, plain_ms=p_ms, max_abs_err=0.0, library_ms=None)
            kernels["grid_occupancy"].update(ms=occ_ms, plain_ms=mask_ms, max_abs_err=0.0, library_ms=None)
            print(f"grid_weight (shell): occupancy pass {occ_ms:.4f} ms, march {k_ms:.4f} ms, the two {both_ms:.4f} "
                  f"ms on the card (profiler, L2 cold); a call with the outputs' zero fill {whole_ms:.4f} ms (CUDA "
                  f"events behind a busy stream, L2 cold), {z_ms:.4f} ms back to back; plain {mask_ms:.1f} ms and "
                  f"{p_ms:.1f} ms (one call each) [{card}]")
        del gw, gh, pw, ph, mask, want_mask
    print(f"K12 checks: {time.perf_counter() - t_k12:.1f} s")
    gc = grid_census(g)
    gb = grid_bounds(gc)["grid_pass"]
    print(f"bound grid_pass (a wrapper call: fill, occupancy pass, march): {gb['bound_bytes'] / 1e6:.2f} MB, "
          f"{gb['bound_ops'] / 1e9:.4f} Gop -> {gb['bound_ms']:.5f} ms ({gb['bound_by']}); the call {whole_ms:.4f} "
          f"ms, {gb['bound_ms'] / whole_ms:.3f} of the bound [{card}]")
    census = dict(B=B_MB, n_sub=n_sub, C=4, W=W, pool=pool_elems, grid=gc)
    print(f"census (K14 on the rig tape, K12 on the grid): {census}; phase 3h {time.perf_counter() - t_3h:.1f} s")
    return census


def subset_gather_bytes(B: int, n: int, t: bool = False, cell: bool = False, rays: bool = False) -> int:
    """Bytes K14a must move for B ids and n gathered samples: the ids, new
    offsets and each chosen ray's two source offsets read; each sample's row
    and step (and t, cell where copied) read and written, 4 bytes each way;
    each ray's view direction and dscale read and written, its count
    written (and its origin and direction read and written with ``rays``)."""
    return B * 4 + (B + 1) * 4 + B * 8 + n * 8 * (2 + t + cell) + B * 16 + B * 20 + rays * B * 48


def minibatch_bounds(c: dict) -> dict:
    """bound_ms and bound_by of K14 and K12 at phase 3h's timed shapes
    (``c``, its census). K14a as training gathers: the ids, new offsets and
    each chosen ray's two source offsets read, its run of row and step
    streams read and written (8 bytes a sample each way), its view
    direction and dscale read and written and its count written. K14b: the
    replay rows, target rows and ids read, the cotangent rows written; 5
    operations per loss element. K14c: the float32 pool and gradient read,
    the pool written; 2 operations per value. K12's two kernels:
    `grid_bounds`."""
    B, n = c["B"], c["n_sub"]
    out = _bounds({
        "subset_gather": (subset_gather_bytes(B, n), 0),
        "l2_cotangent": (B * c["C"] * 4 + B * c["W"] * 4 + B * 4 + B * c["C"] * 4, 5 * B * c["W"]),
        "sgd_update": (c["pool"] * 12, 2 * c["pool"]),
    })
    grid = grid_bounds(c["grid"])
    out.update(grid_occupancy=grid["grid_occupancy"], grid_weight=grid["grid_weight"])
    return out


def grid_bounds(gc: dict) -> dict:
    """bound_ms and bound_by of K12 from its census ``gc`` (`grid_census`).
    ``grid_pass``, the whole function (a wrapper call: the outputs' zero
    fill, the occupancy pass, the march): the rays read, the sigma of every
    distinct voxel its samples land in read, both (reso^3) float32 grids
    written; OPS_GRID_SAMPLE per sample and OPS_GRID_CONTRIB per
    contributing sample. Its two kernels: ``grid_occupancy``, the grid read,
    the mask written, a comparison a voxel; ``grid_weight``, the march: the
    rays and the mask read, the sigma of the distinct voxels its samples
    land in within marked bricks read, and the two output words of each
    distinct voxel a contributing sample lands in read and written by its
    atomics (the wrapper's fill writes the rest of the grids, outside the
    kernel); the whole's operations."""
    reso3 = gc["reso"] ** 3
    ops = OPS_GRID_SAMPLE * gc["samples"] + OPS_GRID_CONTRIB * gc["contrib"]
    mask_bytes = grid_ops.mask_words(gc["reso"], gc["brick"]) * 4
    return _bounds({
        "grid_pass": (gc["rays"] * 24 + gc["voxels"] * 4 + 2 * reso3 * 4, ops),
        "grid_occupancy": (reso3 * 4 + mask_bytes, reso3),
        "grid_weight": (gc["rays"] * 24 + mask_bytes + gc["voxels_marked"] * 4 + gc["voxels_contrib"] * 16, ops),
    })


def eager_chain(f_start, n_steps: int, err_fn, n_terms: int, lr=None):
    """(features, losses, lr) after ``n_steps`` of f - lr * g from
    ``f_start``, g the autograd gradient of sum(err_fn(f, n)^2) / n_terms at
    step n (the losses in float64). ``lr`` None: chosen at the first step so
    that the largest entry of the first step is UPDATE_MOVE * max|f_start|."""
    f, losses = f_start, []
    for n in range(n_steps):
        ff = f.clone().requires_grad_()
        err = err_fn(ff, n)
        g, = torch.autograd.grad((err * err).sum() / n_terms, ff)
        losses.append(float((err.detach().double() ** 2).sum() / n_terms))
        if lr is None:
            lr = UPDATE_MOVE * float(f_start.abs().max()) / float(g.abs().max())
        f = f - lr * g
    return f, losses, lr


def hold_losses(what: str, got, want) -> None:
    """Each step's loss ``got`` within LOSS_RTOL of the eager chain's."""
    for n, w in enumerate(want):
        check(abs(float(got[n]) - w) <= LOSS_RTOL * abs(w), f"{what} step {n}: loss {float(got[n])} vs the "
              f"eager chain's {w}")


def hold_update(what: str, f_k, f_e, f_start) -> float:
    """The chain's update f_k - f_start against the eager chain's f_e -
    f_start: the largest difference over the eager update's largest entry,
    checked against UPDATE_RTOL (a chain that moves nothing fails)."""
    d_e = f_e - f_start
    scale = float(d_e.abs().max())
    err = float(((f_k - f_start) - d_e).abs().max())
    check(scale > 0 and err <= UPDATE_RTOL * scale,
          f"{what}: update off the eager chain's by {err} (its largest entry {scale})")
    return err / scale


def minibatch_path(mb: dict, dev, card: str) -> dict:
    """Phase 4n (K14), minibatch tape training through the public entry
    points on ``mb`` (`minibatch_scene`), timed as bench.py times it
    (`bench.py:284-407`; host clock, least of 3 calls, each call followed
    by the next pack's prep, overlapped with the card, and a read of the
    result): `minibatch_source_s` (the `TapeRowSource`), `minibatch_step_ms`
    and `minibatch_fwd_bwd_mrays_s` (N_MB steps of B_MB with-replacement ids
    from seed 7), `minibatch256k_*` (N_MB2 steps of B_MB2),
    `tape_train_chain_step_ms` and `tape_train_chain_mrays_s` (`train_steps`,
    N_CHAIN steps on the 640,000-ray tape of the orbit camera), each from
    pool * 0.9 at lr MB_LR. Launch counts are read around these. Then one
    random-batch SGD step through the march (`VolumeRenderer.forward` +
    `backward()` on B_MB rig rays, least of 3), and the trainers held to
    eager chains (`eager_chain`) of `replay_render_rows` (N_EAGER steps of
    B_MB rays) or `replay_render` (`train_steps`, 2 steps): at MB_LR the
    losses within LOSS_RTOL relative and `train_minibatches`' features
    within 1e-5 * max(1, max|f|); at an lr that moves the pool the update
    itself (`hold_update`)."""
    r, rig, spec, opt, tgt, f0 = mb["r"], mb["rig"], mb["spec"], mb["opt"], mb["tgt"], mb["f0"]
    n_rig = rig.n_rays
    res = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = stt.TapeRowSource(rig)
    res["minibatch_source_s"] = time.perf_counter() - t0
    rng_mb = np.random.RandomState(7)

    def least(n_steps, batch):
        def prep():
            return subset_ops.prep_minibatches(src, rng_mb.randint(0, n_rig, size=(n_steps, batch)))

        pack = prep()
        f_out, losses, _ = stt.train_minibatches(src, pack, tgt, f0 * 0.9, opt, lr=MB_LR, spec=spec)
        check(bool(torch.isfinite(losses).all()) and bool(torch.isfinite(f_out).all()),
              "train_minibatches: non-finite losses or features")
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f_out, losses, _ = stt.train_minibatches(src, pack, tgt, f0 * (0.9 + 1e-6 * i), opt, lr=MB_LR,
                                                     spec=spec)
            pack = prep()
            float(f_out.sum())
            times.append(time.perf_counter() - t0)
        return min(times) / n_steps

    step_s = least(N_MB, B_MB)
    res["minibatch_step_ms"] = step_s * 1e3
    res["minibatch_fwd_bwd_mrays_s"] = B_MB / step_s / 1e6
    step_s = least(N_MB2, B_MB2)
    res["minibatch256k_step_ms"] = step_s * 1e3
    res["minibatch256k_fwd_bwd_mrays_s"] = B_MB2 / step_s / 1e6
    tape_tr = r.record_persp(orbit_camera(), WIDTH, HEIGHT, fx=BENCH_FX, features=f0)
    with torch.no_grad():
        tgt_chain = stt.replay_render(tape_tr, f0, opt, spec)[:, :3].contiguous()

    def chain_run(i):
        f_out, losses, _ = stt.train_steps(tape_tr, tgt_chain, f0 * (0.9 + 1e-6 * i), opt, N_CHAIN, lr=MB_LR,
                                           spec=spec)
        float(f_out.sum())
        return losses

    # At bench.py's lr the steps move this loss (about 5.6e-6) by less than
    # its float32 resolution: it must stay finite and must not rise.
    losses = chain_run(0)
    check(bool(torch.isfinite(losses).all()) and float(losses[-1]) <= float(losses[0]),
          f"train_steps: losses {losses.tolist()}")
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        chain_run(i + 1)
        times.append(time.perf_counter() - t0)
    chain_s = min(times) / N_CHAIN
    res["tape_train_chain_step_ms"] = chain_s * 1e3
    res["tape_train_chain_mrays_s"] = tape_tr.n_rays / chain_s / 1e6
    counts = read_counts()

    # One random-batch SGD step through the march on B_MB rig rays.
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, n_rig, B_MB)).to(dev)
    rays = stt.Rays(rig.origins[ids].contiguous(), rig.dirs[ids].contiguous(), rig.vdirs[ids].contiguous())
    tgt_b = tgt[ids]
    pool = (f0 * 0.9).requires_grad_()

    def march_step():
        loss = ((r(pool, rays)[:, :3] - tgt_b) ** 2).sum() / (B_MB * 3)
        pool.grad = None
        loss.backward()
        with torch.no_grad():
            pool.sub_(MB_LR * pool.grad)

    march_step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        march_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res["march_minibatch_step_ms"] = min(times) * 1e3

    # train_minibatches and train_steps against eager chains of the public
    # calls: at MB_LR the features and losses, at an lr that moves the pool
    # the update itself.
    ids_e = np.random.RandomState(9).randint(0, n_rig, (N_EAGER, B_MB))
    rows = [torch.from_numpy(ids_n).to(dev) for ids_n in ids_e]
    f_start = f0 * 0.9

    def mb_err(ff, n):
        return stt.replay_render_rows(src, ids_e[n], ff, opt, spec)[:, :3] - tgt[rows[n]]

    def chain_err(ff, n):
        return stt.replay_render(tape_tr, ff, opt, spec)[:, :3] - tgt_chain

    f_e, l_e, _ = eager_chain(f_start, N_EAGER, mb_err, B_MB * 3, MB_LR)
    f_k, l_k, _ = stt.train_minibatches(src, ids_e, tgt, f_start, opt, lr=MB_LR, spec=spec)
    hold_losses("train_minibatches", l_k, l_e)
    e = float((f_k - f_e).abs().max())
    check(e <= 1e-5 * max(1.0, float(f_e.abs().max())), f"train_minibatches vs the eager chain: {e}")
    f_e, _, lr_u = eager_chain(f_start, N_EAGER, mb_err, B_MB * 3)
    f_k, _, _ = stt.train_minibatches(src, ids_e, tgt, f_start, opt, lr=lr_u, spec=spec)
    e_u = hold_update("train_minibatches", f_k, f_e, f_start)
    _, l_e, _ = eager_chain(f_start, 2, chain_err, tape_tr.n_rays * 3, MB_LR)
    hold_losses("train_steps", stt.train_steps(tape_tr, tgt_chain, f_start, opt, 2, lr=MB_LR, spec=spec)[1], l_e)
    f_e, _, lr_c = eager_chain(f_start, 2, chain_err, tape_tr.n_rays * 3)
    f_k = stt.train_steps(tape_tr, tgt_chain, f_start, opt, 2, lr=lr_c, spec=spec)[0]
    e_c = hold_update("train_steps", f_k, f_e, f_start)
    print(f"train_minibatches ({N_EAGER} steps of {B_MB} rays) vs the eager chain of replay_render_rows, "
          f"autograd and f - lr * g: at lr {MB_LR} features max_abs_err {e:.3g}, losses "
          f"{[round(float(x), 9) for x in l_k]} within {LOSS_RTOL} relative; at lr {lr_u:.6g} the update off by "
          f"{e_u:.3g} of its largest entry; train_steps (2 steps, {tape_tr.n_rays} rays) losses within "
          f"{LOSS_RTOL} relative, at lr {lr_c:.6g} the update off by {e_c:.3g} of its largest entry")
    return dict(counts=counts, ms=res)


def grid_path(g: dict) -> dict:
    """Phase 4o (K12): `grid_weight_render` through the public entry point
    on ``g`` (`grid_scene`), launch counts read around it and host ms,
    synchronized; the outputs' shape, bounds (weights in [0, 1]) and
    support (hits only on voxels whose sigma exceeds the threshold).
    The occupancy pass and the march each launch once."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gw, gh = stt.grid_weight_render(g["data"], g["cam"], g["opt"], g["offset"], g["scaling"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    reso = g["data"].shape[0]
    check(gw.shape == gh.shape == (reso,) * 3, "grid_weight_render: wrong output shape")
    check(float(gw.min()) >= 0.0 and float(gw.max()) <= 1.0 + 1e-5 and float(gh.sum()) > 0,
          "grid_weight_render: weights outside [0, 1] or no hits")
    check(not bool(gh[g["data"] <= g["opt"].sigma_thresh].any()), "grid_weight_render: a hit on an empty voxel")
    print(f"main path, grid_weight_render ({reso}^3, {WIDTH}x{HEIGHT}): {int((gh > 0).sum())} voxels hit of "
          f"{int((g['data'] > 0).sum())} occupied, max weight {float(gw.max()):.6f}, host ms {ms:.3f}, "
          f"launches {nonzero(counts)}")
    return dict(counts=counts, ms=ms)


def cost_census(spec, origins, dirs, opt, sigmas, M: int) -> dict:
    """What K15's walk does on this run's data under ``opt`` (its bound):
    the rays that take a step, the samples, their lookups' table loads and
    the distinct structure entries they touch (as `march_census` counts
    them), and with a sigma column (``sigmas``, used when stop_thresh > 0)
    the distinct rows whose sigma the walk reads and the samples that change
    the transmittance."""
    baked = isinstance(spec, bake_ops.BakedTree)
    o, d, invdir, ds, tmin, tmax, hit = render_ops._ray_setup(spec, origins, dirs, opt)
    skip = render_ops.effective_skip_base(spec, opt)
    n_cells = spec.src_map.numel() if baked else spec.data_flat.numel()
    dev = origins.device
    cells, unused = (torch.zeros(n_cells, dtype=torch.bool, device=dev) for _ in range(2))
    rows = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    use_stop = opt.stop_thresh > 0 and sigmas is not None
    n = {k: torch.zeros((), dtype=torch.float64, device=dev) for k in ("samples", "levels", "contrib")}
    t, active = tmin, hit & (tmin < tmax)
    L = torch.ones_like(t)
    steppers = int(active.sum())
    for _ in range(opt.max_steps):
        if not bool(active.any()):
            break
        leaf, levels = _lookup_loads(spec, render_ops.sample_position(o, t, d), cells, unused, active,
                                     active)
        dt = render_ops._step(leaf, invdir, opt.step_size, skip)
        if use_stop:
            idx = leaf.data_idx
            occ = active & (idx >= 0) & (idx < M)
            rows[torch.where(occ, idx, M).long()] = True
            sig = torch.where(occ, sigmas[torch.where(occ, idx, 0).long()], 0.0)
            contrib = occ & (sig > opt.sigma_thresh)
            L = torch.where(contrib, L * torch.exp(-dt * ds * sig), L)
            n["contrib"] += contrib.sum()
        n["samples"] += active.sum()
        n["levels"] += levels[active].sum()
        t = torch.where(active, t + dt, t)
        active = active & (t < tmax)
        if use_stop:
            active = active & (L > opt.stop_thresh)
    out = {k: int(v.item()) for k, v in n.items()}
    out.update(rays=origins.shape[0], hits=steppers, cells=int(cells.sum()), sigma_rows=int(rows[:M].sum()),
               baked=baked)
    return out


def cost_bound(c: dict) -> dict:
    """bound_ms and bound_by of K15 from its census ``c``: the rays read
    once (24 bytes), the structure entries the walk touches (a tree cell 8
    bytes, a baked entry 4), the sigma of each distinct row read (4 bytes)
    and the counts written (4 bytes a ray); operations as the march's walk,
    plus OPS_COST_STOP a sample that changes the transmittance."""
    cell_b = 4 if c["baked"] else 8
    if c["baked"]:
        ops = OPS_RAY * c["hits"] + (OPS_LOOKUP + OPS_SAMPLE) * c["samples"]
    else:
        ops = OPS_RAY * c["hits"] + OPS_LEVEL * c["levels"] + OPS_SAMPLE * c["samples"]
    B = c["rays"]
    return _bounds({"k15": (B * 24 + c["cells"] * cell_b + c["sigma_rows"] * 4 + B * 4,
                            ops + OPS_COST_STOP * c["contrib"])})["k15"]


def cost_kernel_phase(specs: dict, feats, origins, dirs, opts: dict, kernels: dict) -> dict:
    """Phase 3i (K15): the cost walk against its plain version on all of
    the depth-9 shell's camera rays, on both structures (``specs``), exact,
    fast without and with the pool's sigma column (the predicted early
    stop): the counts equal on every ray but those whose transmittance comes
    within 1e-6 of stop_thresh, which are counted and printed with how many
    of them differ. Returns the plain ms of each case and K15's census in
    fast mode with sigmas (its bound)."""
    t_3i = time.perf_counter()
    M = feats.shape[0]
    sig = feats[:, -1].contiguous()
    plain_ms, census, near = {}, {}, {}
    with torch.no_grad():
        for sfx, spec in specs.items():
            for mode, opt, s in (("exact", opts[False], None), ("fast", opts[True], None),
                                 ("fast+sigma", opts[True], sig)):
                got = sched_ops.ray_costs(spec, origins, dirs, opt, M, s)
                args = (spec, origins, dirs, render_ops.effective_skip_base(spec, opt), M, opt.step_size,
                        opt.max_steps, opt.interp, opt.box_advance, opt.sigma_thresh, opt.stop_thresh, s)
                (want, margin), plain_ms[sfx, mode] = timed_once_ms(
                    lambda: sched_ops.march_cost_plain(*args, return_margin=True))
                close = margin <= 1e-6
                differ = got != want
                n_far = int((differ & ~close).sum())
                check(n_far == 0, f"march_cost{sfx} {mode}: {n_far} rays differ from plain away from the stop")
                near[sfx, mode] = (int(close.sum()), int(differ.sum()))
                print(f"march_cost{sfx} {mode}: {origins.shape[0]} rays, counts equal to plain on every ray "
                      f"away from the stop; {near[sfx, mode][0]} rays within 1e-6 of stop_thresh, "
                      f"{near[sfx, mode][1]} of them differ; {int((got > 0).sum())} rays take a step, "
                      f"{int(got.sum())} steps, most {int(got.max())}")
            census[sfx] = cost_census(spec, origins, dirs, opts[True], sig, M)
            print(f"census (K15 fast with sigmas{sfx and ', bake' or ', tree walk'}): {census[sfx]}")
            kernels["march_cost" + sfx]["max_abs_err"] = float(max(near[sfx, m][1] for m in
                                                                   ("exact", "fast", "fast+sigma")))
    print(f"phase 3i {time.perf_counter() - t_3i:.1f} s")
    return dict(plain_ms=plain_ms, census=census)


def cost_kernel_times(specs: dict, feats, origins, dirs, opts: dict, cost_res: dict, kernels: dict,
                      card: str) -> None:
    """Times of K15 (CUDA events over KERNEL_REPS calls) on the depth-9
    shell's camera rays before its re-points, on each structure: exact
    (the kernels line) and fast with the pool's sigma column (the predicted
    stop; kept in ``cost_res["fast_ms"]``), beside K13a, the same walk, in the
    same turn. Plain: one call, phase 3i."""
    M = feats.shape[0]
    sig = feats[:, -1].contiguous()
    cost_res["fast_ms"] = {}
    with torch.no_grad():
        for sfx, spec in specs.items():
            ms = {}
            for mode, opt, s_ in (("exact", opts[False], None), ("fast+sigma", opts[True], sig)):
                args = (spec, origins, dirs, render_ops.effective_skip_base(spec, opt), M, opt.step_size,
                        opt.max_steps, opt.interp, opt.box_advance, opt.sigma_thresh, opt.stop_thresh, s_)
                ms[mode] = time_ms(lambda: sched_ops.march_cost_cuda(*args), KERNEL_REPS)
            k13a = time_ms(lambda: tape_ops.count_samples_cuda(spec, M, origins, dirs, opts[False]), KERNEL_REPS)
            plain = cost_res["plain_ms"]
            kernels["march_cost" + sfx].update(ms=ms["exact"], plain_ms=plain[sfx, "exact"])
            cost_res["fast_ms"][sfx] = ms["fast+sigma"]
            print(f"time march_cost{sfx} ({WIDTH}x{HEIGHT} SH9 camera rays): kernel exact {ms['exact']:.4f} ms, "
                  f"fast with sigmas {ms['fast+sigma']:.4f} ms (K13a, the same walk, {k13a:.4f} ms in the same "
                  f"turn); plain {plain[sfx, 'exact']:.1f} / {plain[sfx, 'fast+sigma']:.1f} ms (one call, "
                  f"phase 3i) [{card}]")


def plan_path(backend: str, state: dict, frame_feats, true_pool, pool0, feats, rig, c2w, dev) -> dict:
    """Phase 4p (K15), the planning path through the public entry points on
    ``backend``: three frames of `render_persp(schedule="cost")` (exact and
    fast) with the frames' pools, whose first call per mode makes and caches
    its plan (`plan_persp`, block 4); one Adam step through the planned
    `render_persp` + `backward()` toward the planned target; one
    `render_dynamic_frames(schedule="union")` call on the deep dynamic scene
    (``rig``, rotations and depth), which plans against the animation's union
    occupancy. Launch counts are read around these; then every output is
    checked equal to the tile order's bit for bit and the planned gradient
    against the tile order's at the atomic tolerance, and the dynamic call
    is timed under both schedules in turns (host clock, synchronized).
    Returns the counts and the host ms of the frames (the first of each
    mode plans)."""
    tree = stt.tree_from_numpy(state, device=dev)
    r = stt.VolumeRenderer(tree, backend=backend)
    if backend == "baked":
        tree._baked_spec()
    dyn_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, update_tree=False, with_depth=True)
    frames, frame_ms = [], []
    reset_counts()
    with torch.no_grad():
        for f in frame_feats:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append([r.render_persp(f, c2w, WIDTH, HEIGHT, fx=FX, fast=fast, schedule="cost")
                           for fast in (False, True)])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        target = r.render_persp(true_pool, c2w, WIDTH, HEIGHT, fx=FX, schedule="cost")
        dyn = r.render_dynamic_frames(feats, *rig, schedule="union", **dyn_kw)
    pool = pool0.clone().requires_grad_()
    adam = torch.optim.Adam([pool], lr=LR)
    loss = ((r.render_persp(pool, c2w, WIDTH, HEIGHT, fx=FX, schedule="cost") - target) ** 2).mean()
    adam.zero_grad()
    loss.backward()
    adam.step()
    counts = read_counts()
    sfx = SUFFIX[backend]
    other = "_baked" if backend == "tree" else ""
    want = {"march_cost" + sfx: 3, "march_cost" + other: 0, "render_fwd" + sfx: 2 * N_FRAMES + 2 + N_FRAMES,
            "render_bwd" + sfx: 1}
    for k, n in want.items():
        check(counts[k] == n, f"plan path ({backend}): {k} launched {counts[k]} times, not {n}")
    check(len(r._plan_cache) == 3, f"plan path ({backend}): {len(r._plan_cache)} plans cached, not 3")
    with torch.no_grad():
        for f, (img_e, img_f) in zip(frame_feats, frames):
            check(torch.equal(img_e, r.render_persp(f, c2w, WIDTH, HEIGHT, fx=FX)),
                  f"render_persp(schedule='cost') ({backend}) is not the tile order's image bit for bit")
            check(torch.equal(img_f, r.render_persp(f, c2w, WIDTH, HEIGHT, fx=FX, fast=True)),
                  f"fast render_persp(schedule='cost') ({backend}) is not the tile order's bit for bit")
        tile = r.render_dynamic_frames(feats, *rig, **dyn_kw)
        check(torch.equal(dyn[0], tile[0]) and torch.equal(dyn[1], tile[1]),
              f"render_dynamic_frames(schedule='union') ({backend}) is not the tile order's bit for bit")

        def call_ms(schedule):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_dynamic_frames(feats, *rig, schedule=schedule, **dyn_kw)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        turn = [call_ms(k) for k in ("tile", "union", "union", "tile")]
    pool_t = pool0.clone().requires_grad_()
    ((r.render_persp(pool_t, c2w, WIDTH, HEIGHT, fx=FX) - target) ** 2).mean().backward()
    g_err = atomic_err(pool.grad, pool_t.grad, f"planned gradient ({backend}) vs the tile order's")
    check(float(pool.grad.abs().max()) > 0, f"plan path ({backend}): zero gradient")
    print(f"main path, planning ({LABEL[backend]}): launches {nonzero(counts)}; loss {float(loss.detach()):.8f}; "
          f"frames and the union dynamic call equal to the tile order bit for bit, the planned gradient within "
          f"{g_err:.3g}; host ms per frame (exact + fast; the first plans both) "
          f"{[round(x, 3) for x in frame_ms]}; a {N_FRAMES}-frame render_dynamic_frames call in turns (tile, "
          f"union, union, tile; the union plan cached, keyed by the animation tensors' identities): tile "
          f"{min(turn[0], turn[3]):.3f} ms, union {min(turn[1], turn[2]):.3f} ms")
    return dict(counts=counts, frame_ms=frame_ms)


def plan_times(bench7, deep, dev, card: str) -> dict:
    """bench.py's planning keys (`bench.py:65-82`, `:413-455`, `:476-573`,
    `:583-632`) on the default bake, each plan timed as bench.py times it
    (a warm call, then the least of two, host clock, synchronized) and each
    march as `tape_times` times one (N_SUSTAIN perturbed pools per call, the
    least of 3). The headline scene (``bench7``: the depth-7 SH9 shell,
    `VolumeRenderer(tree, step_size=1e-3)`, the orbit camera at 800x800, fx
    880, rays in 32x32 tile order as bench.py makes them): `plan_exact_ms` and
    `plan_fast_ms` (`cost_order` with the pool's sigma column) and the march
    on the rays in plan order, `fwd_ms` / `fwd_march_mrays_s` and
    `fast_mode_ms` / `fast_mode_mrays_s`; its opaque form
    (`build_opaque_tree`): `plan_opaque_ms`, `opaque_fast_ms` /
    `opaque_fast_mrays_s`; the block plan through `plan_persp` (block 4):
    `plan_block_ms` and `fwd_march_blockplan_mrays_s`; a 32-camera orbit 2
    degrees apart with one block plan made inside the timing
    (`orbit32_planned_frame_ms` / `_mrays_s`) and with cached per-camera
    plans, each group of 4 cameras under its first camera's plan
    (`orbit32_cached_*`). The deep scene (``deep``: the depth-9 shell and
    its pool, in bf16): `plan_deep_ms`, `deep9_ms` / `deep9_mrays_s` and the
    int8 form `deep9_int8_ms` / `deep9_int8_mrays_s` on the planned rays.
    Beside them, in turns with the planned march (pixel order, plan, plan,
    pixel order), the exact march in pixel order on the same scenes: the
    A/B of whether the cost order pays on the card."""
    res = {}
    B = WIDTH * HEIGHT
    c2w = orbit_camera()
    o_px, d_px = render_ops.cam2world_rays(torch.as_tensor(c2w, device=dev), WIDTH, HEIGHT, BENCH_FX, BENCH_FX)
    # bench.py's tile order (32x32: the renderer's chunk_size 1024).
    tile = renderer_mod._tile_order(stt.RenderOptions(chunk_size=1024), WIDTH, HEIGHT, dev)
    o_t, d_t = o_px.index_select(0, tile).contiguous(), d_px.index_select(0, tile).contiguous()
    pixel_rays = stt.Rays(o_px.contiguous(), d_px.contiguous(), d_px.contiguous())

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def plan_ms(fn):
        fn()
        (out, a), (_, b_) = host_ms(fn), host_ms(fn)
        return out, min(a, b_)

    def in_order(order):
        o_, d_ = o_t.index_select(0, order), d_t.index_select(0, order)
        return stt.Rays(o_, d_, d_)

    def sustained(render, pools):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = float(sum(render(p_).sum() for p_ in pools))
        check(np.isfinite(total), "non-finite frame")
        return (time.perf_counter() - t0) * 1e3 / len(pools)

    def least(render, make):
        render(make(0, 0))
        return min(sustained(render, [make(i + 1, j) for j in range(N_SUSTAIN)]) for i in range(3))

    def turns(planned, plain, make):
        """(planned ms, pixel-order ms), each the least of its two turns."""
        t = [least(plain, make), least(planned, make), least(planned, make), least(plain, make)]
        return min(t[1], t[2]), min(t[0], t[3])

    ab = {}
    with torch.no_grad():
        # The headline scene, exact and fast, and its opaque form.
        for name, (st_, f_np) in (("shell", bench7), ("opaque", build_opaque_tree(depth=7)[:2])):
            tree = stt.tree_from_numpy(st_, device=dev)
            r = stt.VolumeRenderer(tree, step_size=1e-3)
            baked = tree._baked_spec()
            f0 = torch.from_numpy(f_np).to(dev)
            make = lambda i, j: f0 * (1.0 + 1e-2 * i + 1e-3 * j)  # noqa: E731
            for fast in ((False, True) if name == "shell" else (True,)):
                opt = r._get_options(fast)
                key = "opaque" if name == "opaque" else ("fast" if fast else "exact")
                order, res[f"plan_{key}_ms"] = plan_ms(
                    lambda: sched_ops.cost_order(baked, o_t, d_t, opt, f0.shape[0], f0[:, -1]))
                rays = in_order(order)
                if key == "exact":
                    res["fwd_ms"], ab["fwd"] = turns(lambda p_: r(p_, rays), lambda p_: r(p_, pixel_rays),
                                                     make)
                else:
                    res[f"{'opaque_fast' if name == 'opaque' else 'fast_mode'}_ms"] = least(
                        lambda p_: r(p_, rays, fast=True), make)
            if name == "opaque":
                continue
            # The block plan through the renderer, and the orbit.
            r.plan_persp(c2w, WIDTH, HEIGHT, fx=BENCH_FX, features=f0)
            r._plan_cache.clear()
            (perm_b, _), res["plan_block_ms"] = host_ms(
                lambda: r.plan_persp(c2w, WIDTH, HEIGHT, fx=BENCH_FX, features=f0))
            block_rays = stt.Rays(*(x.index_select(0, perm_b) for x in pixel_rays))
            res["fwd_march_blockplan_mrays_s"] = B / least(lambda p_: r(p_, block_rays), make) / 1e3
            cams = [torch.as_tensor(orbit_camera(theta=0.5 + i * np.deg2rad(2.0)), device=dev)
                    for i in range(32)]

            def orbit(perm_of, pool):
                acc = torch.zeros((), device=dev)
                for i, cam in enumerate(cams):
                    o_, d_ = render_ops.cam2world_rays(cam, WIDTH, HEIGHT, BENCH_FX, BENCH_FX)
                    p_ = perm_of(i)
                    o_, d_ = o_.index_select(0, p_), d_.index_select(0, p_)
                    acc = acc + r(pool * (1.0 + 1e-7 * (i // 4)), stt.Rays(o_, d_, d_)).sum()
                return float(acc)

            def planned_orbit():
                r._plan_cache.clear()
                perm = r.plan_persp(cams[0], WIDTH, HEIGHT, fx=BENCH_FX, features=f0)[0]
                return orbit(lambda i: perm, f0)

            planned_orbit()
            _, ms = host_ms(planned_orbit)
            res["orbit32_planned_frame_ms"] = ms / 32
            perms = [r.plan_persp(cam, WIDTH, HEIGHT, fx=BENCH_FX, features=f0, block=1)[0] for cam in cams]
            orbit(lambda i: perms[i - i % 4], f0)
            _, ms = host_ms(lambda: orbit(lambda i: perms[i - i % 4], f0 * 1.01))
            res["orbit32_cached_frame_ms"] = ms / 32
            del tree, r, baked, f0, rays, block_rays, perms
        # The deep scene, bf16 and its int8 form.
        tree = stt.tree_from_numpy(deep[0], device=dev)
        r = stt.VolumeRenderer(tree, step_size=1e-3)
        baked = tree._baked_spec()
        f32 = torch.from_numpy(deep[1]).to(dev)
        f0 = f32.to(torch.bfloat16)
        opt = r._get_options(False)
        order, res["plan_deep_ms"] = plan_ms(
            lambda: sched_ops.cost_order(baked, o_t, d_t, opt, f0.shape[0], f0[:, -1]))
        rays = in_order(order)
        make = lambda i, j: (f32 * (1.0 + 1e-2 * i + 1e-3 * j)).to(torch.bfloat16)  # noqa: E731
        res["deep9_ms"], ab["deep9"] = turns(lambda p_: r(p_, rays), lambda p_: r(p_, pixel_rays), make)
        res["deep9_int8_ms"] = least(lambda p_: r(p_, rays),
                                     lambda i, j: stt.quantize_features(f32 * (1.0 + 1e-2 * i + 1e-3 * j)))
        del tree, r, baked, f0, f32, rays
    for k in ("fwd", "fast_mode", "opaque_fast", "deep9", "deep9_int8", "orbit32_planned_frame",
              "orbit32_cached_frame"):
        res[k.replace("_frame", "") + "_mrays_s"] = B / res[k + "_ms"] / 1e3
    res["fwd_march_mrays_s"] = res.pop("fwd_mrays_s")
    print("bench.py planning keys (default bake; plans: host clock, synchronized, least of 2 after a warm "
          "call; marches: N_SUSTAIN frames per timed call, least of 3): "
          + ", ".join(f"{k} {v:.4f}" for k, v in res.items()) + f" [{card}]")
    print(f"cost order against pixel order in turns (pixel, plan, plan, pixel; least of each): headline exact "
          f"{res['fwd_ms']:.4f} vs {ab['fwd']:.4f} ms ({ab['fwd'] / res['fwd_ms']:.3f}x), deep9 bf16 "
          f"{res['deep9_ms']:.4f} vs {ab['deep9']:.4f} ms ({ab['deep9'] / res['deep9_ms']:.3f}x) [{card}]")
    return res


def train(tree, true_pool, pool0, centers, perms, prior_points, steps,
          width=WIDTH, height=HEIGHT, fx=FX, accumulate_at=-1, after_step=None,
          backend="baked"):
    """`steps` Adam steps on a copy of ``pool0`` (canonical leaf order)
    toward the image that ``true_pool`` renders with the tree pointed at
    ``centers``. Step k points the tree at ``centers[perms[k]]``, so that
    frame's pool is ``pool[perms[k]]``: every frame shows each leaf its
    own canonical row. Step ``accumulate_at`` renders inside
    `N3Tree.accumulate_weights()`; ``after_step()``, if given, is called
    after every step. On the baked backend the tree is baked first, as at
    load, so that every re-point refreshes the bake.

    :return: (pool, losses, image losses, host ms per step, weights from
        the accumulated step)
    """
    renderer = stt.VolumeRenderer(tree, backend=backend)
    if backend == "baked":
        tree._baked_spec()
    c2w = orbit_camera()
    tree.construct_tree(centers)
    with torch.no_grad():
        target = renderer.render_persp(true_pool, c2w, width, height, fx=fx)
    pool = pool0.clone().requires_grad_()
    opt = torch.optim.Adam([pool], lr=LR)
    sync = torch.cuda.synchronize if pool.is_cuda else (lambda: None)
    losses, image_losses, step_ms, weights = [], [], [], None
    for k in range(steps):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        tree.construct_tree(centers[perms[k]])
        frame_pool = pool[perms[k]]
        accumulate = tree.accumulate_weights() if k == accumulate_at else contextlib.nullcontext()
        with accumulate as acc:
            img = renderer.render_persp(frame_pool, c2w, width, height, fx=fx)
        image_loss = ((img - target) ** 2).mean()
        prior = tree(frame_pool, prior_points)[:, -1].abs().mean()
        loss = image_loss + PRIOR_WEIGHT * prior
        loss.backward()
        opt.step()
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        image_losses.append(image_loss.item())
        if acc is not None:
            weights = acc()
        if after_step is not None:
            after_step()
    return pool, losses, image_losses, step_ms, weights


def train_aux(tree, true_pool, pool0, true_jf, jf0, sw, ji, centers, perms, rays, steps,
              width=WIDTH, height=HEIGHT, fx=FX, backend="baked"):
    """`steps` Adam steps over a copy of ``pool0`` and of ``jf0`` on the aux
    path: each step re-points the tree at ``centers[perms[k]]`` and takes
    an image MSE of `render_persp`, an opacity mask loss of
    `opacity_render` and an MSE of `motion_feature_render` on ``rays``,
    against targets that ``true_pool`` and ``true_jf`` give with the tree
    pointed at ``centers``. ``sw``/``ji`` are per canonical row.

    :return: (pool, joint features, losses, host ms per step)
    """
    renderer = stt.VolumeRenderer(tree, backend=backend)
    if backend == "baked":
        tree._baked_spec()
    c2w = orbit_camera()
    tree.construct_tree(centers)
    with torch.no_grad():
        t_img = renderer.render_persp(true_pool, c2w, width, height, fx=fx)
        t_alpha = renderer.opacity_render(true_pool, rays)
        t_mf = renderer.motion_feature_render(true_pool, true_jf, sw, ji, rays)
    pool = pool0.clone().requires_grad_()
    jf = jf0.clone().requires_grad_()
    opt = torch.optim.Adam([pool, jf], lr=LR)
    losses, step_ms = [], []
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        perm = perms[k]
        tree.construct_tree(centers[perm])
        frame_pool = pool[perm]
        img = renderer.render_persp(frame_pool, c2w, width, height, fx=fx)
        alpha = renderer.opacity_render(frame_pool, rays)
        mf = renderer.motion_feature_render(frame_pool, jf, sw[perm], ji[perm], rays)
        loss = (((img - t_img) ** 2).mean() + MASK_WEIGHT * ((alpha - t_alpha) ** 2).mean()
                + ((mf - t_mf) ** 2).mean())
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    return pool, jf, losses, step_ms


def edit_path(tree, pool, rng, width=WIDTH, height=HEIGHT, fx=FX) -> dict:
    """The tree-editing main path through the public entry points (the
    prune/refine half of training), on ``tree`` with the pool ``pool``:

      1. ``t[:].corners_local`` and ``t[:].lengths_local`` of every leaf;
      2. `N3Tree.set` of a seeded pool block at the leaf centres, read back
         through the point query;
      3. the point query with ``want_leaf_node`` on the centres plus a
         seeded duplicated fifth of them, in a seeded order;
      4. a frame rendered inside `accumulate_weights()`, `merge` of a
         seeded choice among the frontier nodes that took no weight (a
         tenth of the frontier, or all of them if fewer), and
         `shrink_to_fit`; then, from a second weighted frame,
         ``t[mask].refine()`` of the ~1% of leaves with the most weight.

    The kernels' results are held against their plain versions (which
    launch nothing), exactly. After each edit of step 4 the tree is baked
    again and a frame rendered exact on both backends, bit for bit equal,
    and every leaf centre must find its own leaf again.

    :return: dict: host ms per step (``ms``), the plain versions' device
        ms (``plain_ms``), the kernels' arguments at the main path's shapes
        and the work counts of the bounds.
    """
    dev = pool.device
    sync = torch.cuda.synchronize if pool.is_cuda else (lambda: None)
    ms = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def plain_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    c2w = orbit_camera()
    tree.features = pool
    spec = tree._spec()
    L, N3 = tree.n_leaves, tree.N ** 3
    leaves = torch.as_tensor(tree._all_leaves(), dtype=torch.int32, device=dev)
    res = dict(ms=ms, plain_ms={})

    # 1. Corners and lengths of every leaf.
    corners, lengths = timed("corners", lambda: (tree[:].corners_local, tree[:].lengths_local))
    want, res["plain_ms"]["calc_corners"] = plain_ms(lambda: query_ops.calc_corners_plain(spec, leaves))
    check(torch.equal(corners, want), "calc_corners: kernel and plain differ")
    centres = tree.tree2world(corners + 0.5 * lengths[:, None]).contiguous()
    depth = spec.parent_depth[leaves[:, 0].long(), 1]
    res["calc_corners_args"] = (spec, leaves)
    res["corner_steps"] = int((depth + 1).sum())

    # 2. set at the leaf centres, and the values read back.
    vals = seeded_pool(rng, L, pool.shape[1], dev)
    old = tree.features
    timed("set", lambda: tree.set(centres, vals))
    want, res["plain_ms"]["assign"] = plain_ms(lambda: query_ops.assign_plain(spec, old, centres, vals))
    check(torch.equal(tree.features, want), "assign: kernel and plain differ")
    back, rows = tree(tree.features, centres, want_data_ids=True)
    occ = rows < tree.features.shape[0]
    check(bool(occ.any()) and torch.equal(back[occ], vals[occ]) and not bool(back[~occ].any()),
          "set: the values do not read back")
    leaf = traversal.descend(spec, traversal.world2tree(centres, spec.offset, spec.scaling))
    res["assign_args"] = (spec, old, centres, vals)
    res["assign_levels"] = int(torch.round(torch.log2(leaf.cube_sz) / float(np.log2(tree.N))).sum())
    res["occupied"] = int(occ.sum())

    # 3. The distinct leaves of the centres plus a duplicated fifth.
    dup = centres[torch.from_numpy(rng.choice(L, L // 5, replace=False)).to(dev)]
    pts = torch.cat([centres, dup])[torch.from_numpy(rng.permutation(L + L // 5)).to(dev)]
    _, ids, found = timed("unique", lambda: tree(tree.features, pts, want_node_ids=True,
                                                 want_leaf_node=True))
    n_cells = spec.data_flat.numel()
    (want, count), res["plain_ms"]["unique_leaf"] = plain_ms(
        lambda: query_ops.unique_leaf_nodes_plain(ids, tree.N, n_cells=n_cells))
    check(int(count) == L and torch.equal(found, want[:L]), "unique_leaf_nodes: kernel and plain differ")
    check(np.array_equal(found.cpu().numpy(), tree._all_leaves()),
          "the unique leaves of the centres are not every leaf in packed-id order")
    res["unique_args"] = (ids, tree.N, n_cells)

    # 4. Prune and refine, with a re-bake and renders after each edit.
    def weighted_frame():
        with torch.no_grad(), tree.accumulate_weights() as acc:
            stt.VolumeRenderer(tree).render_persp(tree.features, c2w, width, height, fx=fx)
        return acc

    def check_edit(what):
        timed(f"bake after {what}", tree._baked_spec)
        with torch.no_grad():
            imgs = {b: stt.VolumeRenderer(tree, backend=b).render_persp(
                tree.features, c2w, width, height, fx=fx) for b in BACKENDS}
        img = imgs["baked"]
        check(torch.equal(img, imgs["tree"]), f"after {what}: the backends' exact frames differ")
        a = img[..., 3]
        check(bool(torch.isfinite(img).all() and (a >= 0).all() and (a <= 1).all()
                   and (a > 0).any() and (a == 0).any()), f"after {what}: bad frame")
        cen = tree.tree2world(tree.corners_local + 0.5 * tree.lengths_local[:, None])
        _, lf = tree(tree.features, cen, want_leaf_node=True)
        check(np.array_equal(lf.cpu().numpy(), tree._all_leaves()), f"after {what}: a centre left its leaf")
        res[f"hits after {what}"] = float((a > 0).float().mean())

    tree._baked_spec()
    acc = weighted_frame()
    w = acc()
    check(tuple(w.shape) == (L,) and float(w.sum()) > 0, "no accumulated weight")
    front = tree._frontier
    fw = acc.value[torch.as_tensor(front, device=dev)].reshape(len(front), -1).sum(dim=1)
    idle = np.flatnonzero((fw == 0).cpu().numpy())
    check(len(idle) > 0, "every frontier node took weight")
    sel = np.sort(rng.choice(idle, min(len(idle), max(1, len(front) // 10)), replace=False))
    before = tree.n_leaves
    check(timed("merge", lambda: tree.merge(sel)) and tree._n_free == len(sel), "merge freed no node")
    check(timed("shrink_to_fit", tree.shrink_to_fit) and tree._n_free == 0, "shrink_to_fit kept freed nodes")
    check(tree.n_leaves == before - len(sel) * (N3 - 1), "merge: wrong leaf count")
    res.update(merged=len(sel), frontier=len(front), idle_frontier=len(idle))
    check_edit("merge + shrink_to_fit")

    w = weighted_frame()()
    k = min(tree.n_leaves // 100, int((w > 0).sum()))
    mask = torch.zeros(tree.n_leaves, dtype=torch.bool, device=dev)
    mask[torch.topk(w, k).indices] = True
    before = tree.n_leaves
    timed("refine", lambda: tree[mask].refine())
    check(tree.n_leaves == before + k * (N3 - 1), "refine: wrong leaf count")
    res.update(refined=k, leaves_after=tree.n_leaves)
    check_edit("refine")
    return res


def main() -> None:
    # 1. Device
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. Build
    b = _build.build()
    build_s = b.seconds
    print(f"build: {build_s:.1f} s on {os.cpu_count()} CPUs, one nvcc per source -> {b.path.name}")
    for line in b.log.splitlines():
        if line.startswith("== ") or "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())
    march_regs = ptxas_summary(b.log)

    # Scenes (NumPy, seeded) and device tables
    t0 = time.perf_counter()
    state, feats_np, centers_np = build_shell_tree(depth=DEPTH, data_format="SH9", data_dim=28)
    rgba_state, rgba_np, _ = build_shell_tree(depth=DEPTH, data_format="RGBA", data_dim=4)
    M = feats_np.shape[0]
    print(f"scene: depth {DEPTH}, {state['child'].shape[0]} nodes, {M} leaves, "
          f"{time.perf_counter() - t0:.1f} s to build")
    rng = np.random.RandomState(0)
    centers = torch.from_numpy(centers_np).to(dev)
    origins, dirs = camera_rays(dev)
    B = origins.shape[0]
    kernels = {
        "construct_tree": dict(route="cuda", source="svox_t_tpu_torch/csrc/construct_tree.cu",
                               replaces="svox_t_tpu/ops/query.py:130"),
        "render_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_fwd.cu",
                           replaces="svox_t_tpu/ops/render.py:851"),
        "render_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd.cu",
                           replaces="svox_t_tpu/ops/render.py:1296"),
        "query_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/query.cu",
                          replaces="svox_t_tpu/ops/query.py:46"),
        "query_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/query.cu",
                          replaces="svox_t_tpu/ops/query.py:76"),
        "opacity_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd.cu",
                            replaces="svox_t_tpu/ops/render_aux.py:58"),
        "first_hit": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                          replaces="svox_t_tpu/ops/render_aux.py:217"),
        "mf_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                       replaces="svox_t_tpu/ops/render_aux.py:403"),
        "mf_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux.cu",
                       replaces="svox_t_tpu/ops/render_aux.py:526"),
        "warp_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/warp.cu",
                         replaces="svox_t_tpu/ops/warp.py:53"),
        "warp_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/warp.cu",
                         replaces="svox_t_tpu/ops/warp.py:53"),
        "voxelize_fwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/p2v.cu",
                             replaces="svox_t_tpu/ops/p2v.py:37"),
        "voxelize_bwd": dict(route="cuda", source="svox_t_tpu_torch/csrc/p2v.cu",
                             replaces="svox_t_tpu/ops/p2v.py:37"),
        "render_fwd_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_fwd_baked.cu",
                                 replaces="svox_t_tpu/ops/render.py:851"),
        "render_bwd_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd_baked.cu",
                                 replaces="svox_t_tpu/ops/render.py:1296"),
        "opacity_bwd_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_bwd_baked.cu",
                                  replaces="svox_t_tpu/ops/render_aux.py:58"),
        "first_hit_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux_baked.cu",
                                replaces="svox_t_tpu/ops/render_aux.py:217"),
        "mf_fwd_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux_baked.cu",
                             replaces="svox_t_tpu/ops/render_aux.py:403"),
        "mf_bwd_baked": dict(route="cuda", source="svox_t_tpu_torch/csrc/render_aux_baked.cu",
                             replaces="svox_t_tpu/ops/render_aux.py:526"),
        "bake_lookup": dict(route="cuda", source="svox_t_tpu_torch/csrc/bake.cu",
                            replaces="svox_t_tpu/ops/bake.py:948"),
        "bake_refresh": dict(route="cuda", source="svox_t_tpu_torch/csrc/bake.cu",
                             replaces="svox_t_tpu/ops/bake.py:646"),
        "grow_boxes": dict(route="cuda", source="svox_t_tpu_torch/csrc/bake.cu",
                           replaces="svox_t_tpu/ops/bake.py:695"),
        "points_aabb": dict(route="cuda", source="svox_t_tpu_torch/csrc/query.cu",
                            replaces="svox_t_tpu/ops/query.py:142"),
        # construct_tree (:130) and then points_leaf_aabb (:142) on the same
        # points, in one descent.
        "construct_tree_aabb": dict(route="cuda", source="svox_t_tpu_torch/csrc/construct_tree.cu",
                                    replaces="svox_t_tpu/ops/query.py:142"),
        "assign": dict(route="cuda", source="svox_t_tpu_torch/csrc/edit.cu",
                       replaces="svox_t_tpu/ops/query.py:112"),
        "unique_leaf": dict(route="cuda", source="svox_t_tpu_torch/csrc/edit.cu",
                            replaces="svox_t_tpu/ops/query.py:92"),
        "calc_corners": dict(route="cuda", source="svox_t_tpu_torch/csrc/edit.cu",
                             replaces="svox_t_tpu/ops/query.py:167"),
    }
    # The trilinear (K4) instances of the six march kernels: K2, K3 and K9a-d
    # with K4's corners (svox_t_tpu/ops/render.py:635 `_interp_corners`,
    # :676 `_gather_interp`).
    march_src = dict(render_fwd="render_fwd", render_bwd="render_bwd", opacity_bwd="render_bwd",
                     first_hit="render_aux", mf_fwd="render_aux", mf_bwd="render_aux")
    for name in MARCH_KERNELS:
        for sfx in ("_interp", "_baked_interp"):
            kernels[name + sfx] = dict(route="cuda", source=f"svox_t_tpu_torch/csrc/{march_src[name]}{sfx}.cu",
                                       replaces="svox_t_tpu/ops/render.py:635")
    # K5: the bf16 and int8 pool instances of the march kernels (each its
    # header compiled with the macros of `_build.POOL_INSTANCES`), and the
    # bf16 point query (svox_t_tpu/ops/render.py:248 `_gather_features`
    # with `QuantizedFeatures` :71, inside K2, K3, K9a-d and K8b).
    for name in POOL_KERNELS:
        base = next(b_ for b_ in MARCH_KERNELS if name.startswith(b_))
        kernels[name] = dict(route="cuda", source=f"svox_t_tpu_torch/csrc/{march_src[base]}.cuh",
                             replaces="svox_t_tpu/ops/render.py:248")
    for name in ("query_fwd_bf16", "query_bwd_bf16"):
        kernels[name] = dict(route="cuda", source="svox_t_tpu_torch/csrc/query_bf16.cu",
                             replaces="svox_t_tpu/ops/render.py:248")
    # K13: the tape recorder (svox_t_tpu/ops/tape.py:260 `_count_samples`,
    # :302 `_record_chunks`) and replay (:705 `_replay_fwd_impl`, :962
    # `_replay_bwd_impl`).
    # K13e, the frame axis of the replay backward (:1215
    # `_replay_bwd_frames_impl`), and K13f, the depth replay (:1311
    # `_replay_depth_impl`).
    for name in TAPE_KERNELS:
        base, sfx = name.split("_baked")[0], "_baked" if "_baked" in name else ""
        if base in ("tape_count", "tape_record", "tape_stage", "tape_copy"):
            src, line = f"tape_record{sfx}.cu", 260 if base in ("tape_count", "tape_stage") else 302
        elif name == "tape_depth":
            src, line = "tape_depth.cu", 1311
        else:
            src = ("tape_replay.cuh" if name.endswith(("_bf16", "_i8"))
                   else name.replace("_frames", "") + ".cu")
            line = 705 if "_fwd" in name else 1215 if "_frames" in name else 962
        kernels[name] = dict(route="cuda", source=f"svox_t_tpu_torch/csrc/{src}",
                             replaces=f"svox_t_tpu/ops/tape.py:{line}")
    # K14: minibatch tape training (svox_t_tpu/ops/tape_subset.py:280
    # `_gather_subset`, :623 the loss and cotangent of `_train_impl`, :429
    # `_sgd`); K12: svox_t_tpu/ops/grid.py:22 `grid_weight_render`.
    for name, (src, line) in {"subset_gather": ("tape_subset.cu", "tape_subset.py:280"),
                              "l2_cotangent": ("tape_subset.cu", "tape_subset.py:623"),
                              "sgd_update": ("tape_subset.cu", "tape_subset.py:429"),
                              "grid_occupancy": ("grid.cu", "grid.py:22"),
                              "grid_weight": ("grid.cu", "grid.py:22")}.items():
        kernels[name] = dict(route="cuda", source=f"svox_t_tpu_torch/csrc/{src}",
                             replaces=f"svox_t_tpu/ops/{line}")
    # K15: the ray schedules' cost walk (svox_t_tpu/ops/schedule.py:51
    # `march_cost`), a third kernel of the tape recorder's compile units.
    for sfx in ("", "_baked"):
        kernels["march_cost" + sfx] = dict(route="cuda", source=f"svox_t_tpu_torch/csrc/tape_record{sfx}.cu",
                                           replaces="svox_t_tpu/ops/schedule.py:51")

    # 3. Kernel vs plain
    tree = stt.tree_from_numpy(state, device=dev)
    spec = tree._spec()
    points = centers[torch.from_numpy(rng.permutation(M)).to(dev)]
    got = query_ops.construct_tree_cuda(spec, points)
    torch.cuda.synchronize()
    want = query_ops.construct_tree_plain(spec, points)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "construct_tree kernel and plain version disagree")
    changed = int((got != spec.data_flat).sum())
    check(changed > 0, "construct_tree changed no slot")
    kernels["construct_tree"]["max_abs_err"] = 0.0
    print(f"construct_tree: {M} points, index tables equal ({changed} slots re-pointed)")

    feats = torch.from_numpy(feats_np).to(dev)
    rgba_tree = stt.tree_from_numpy(rgba_state, device=dev)
    rgba_feats = torch.from_numpy(rgba_np).to(dev)
    rot = random_rotations(M, rng, dev)
    sh_renderer = stt.VolumeRenderer(tree)
    lobe_pool = seeded_pool(rng, M, 28, dev)
    lobe_trees = {fmt: stt.tree_from_numpy(dict(state, data_format=f"{fmt}9",
                                                extra_data=random_lobes(fmt, 9, seed=1)), device=dev)
                  for fmt in ("SG", "ASG")}
    cases = [
        ("RGBA", rgba_tree._spec(), rgba_feats, stt.VolumeRenderer(rgba_tree)),
        ("SH9", tree._spec(), feats, sh_renderer),
        ("SH9+rot", tree._spec(transformation_matrices=rot), feats, sh_renderer),
        ("SG9", lobe_trees["SG"]._spec(), lobe_pool, stt.VolumeRenderer(lobe_trees["SG"])),
        ("ASG9", lobe_trees["ASG"]._spec(), lobe_pool, stt.VolumeRenderer(lobe_trees["ASG"])),
    ]
    worst = 0.0
    fwd_plain_ms = {}
    with torch.no_grad():
        for name, cspec, cfeats, rend in cases:
            for fast in (False, True):
                opt = rend._get_options(fast)
                out_k = render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt)
                out_p, p_ms = timed_once_ms(
                    lambda: render_ops.volume_render_plain(cspec, cfeats, origins, dirs, dirs, opt))
                fwd_plain_ms[(name, fast)] = p_ms
                err = float((out_k - out_p).abs().max())
                worst = max(worst, err)
                hit = float((out_k[:, -1] > 0).float().mean())
                print(f"render_fwd {name} {'fast' if fast else 'exact'}: "
                      f"max_abs_err {err:.3g} (atol {RENDER_ATOL}), hit share {hit:.3f}, "
                      f"plain {p_ms:.1f} ms")
                check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
                check(err <= RENDER_ATOL, f"{name} fast={fast}: kernel vs plain {err} > {RENDER_ATOL}")

        # Weight accumulation (K2 with a weight buffer), SH9 exact and fast.
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            out_k, w_k = render_ops.volume_render_with_weight_accum_cuda(
                spec, feats, origins, dirs, dirs, opt)
            (out_p, w_p), fwd_plain_ms[("SH9+waccum", fast)] = timed_once_ms(
                lambda: render_ops.volume_render_with_weight_accum_plain(
                    spec, feats, origins, dirs, dirs, opt))
            err = float((out_k - out_p).abs().max())
            check(err <= RENDER_ATOL, f"weight-accumulating march: outputs differ by {err}")
            w_err = atomic_err(w_k, w_p, f"waccum fast={fast}")
            worst = max(worst, err, w_err)
            total = float(w_k.sum())
            print(f"render_fwd+waccum SH9 {'fast' if fast else 'exact'}: out max_abs_err {err:.3g}, "
                  f"waccum max_abs_err {w_err:.3g} (max|w| {float(w_p.abs().max()):.4g}), "
                  f"sum {total:.6g}, alpha sum {float(out_k[:, -1].sum()):.6g}, "
                  f"plain {fwd_plain_ms[('SH9+waccum', fast)]:.1f} ms")
            check(total > 0, "no weight accumulated")
            if not fast:
                alpha_sum = float(out_k[:, -1].sum())
                check(abs(total - alpha_sum) <= 1e-4 * abs(alpha_sum),
                      f"exact waccum sum {total} != alpha sum {alpha_sum}")
    kernels["render_fwd"]["max_abs_err"] = worst

    # K2's widths 4 and 1 bit for bit at its callers' two shapes: (a) this
    # scene's camera; (b) bench.py's depth-7 headline shell at 800x800, fx
    # BENCH_FX, rays in pixel order (`fwd_march_noplan_ms`), with seeded
    # rotations too. Phases 3d and 3f repeat it on the bake and the pools.
    bench7 = build_shell_tree(depth=7, data_format="SH9", data_dim=28)[:2]
    tree7 = stt.tree_from_numpy(bench7[0], device=dev)
    feats7 = torch.from_numpy(bench7[1]).to(dev)
    r7 = stt.VolumeRenderer(tree7, step_size=1e-3)
    o7, d7 = render_ops.cam2world_rays(torch.as_tensor(orbit_camera(), device=dev), WIDTH, HEIGHT, BENCH_FX,
                                       BENCH_FX)
    o7, d7 = o7.contiguous(), d7.contiguous()
    rot7 = random_rotations(feats7.shape[0], np.random.RandomState(15), dev)

    def width_cases(structure: str, pools: dict) -> list:
        """K2's SH9 cases on ``structure`` (``tree`` or ``baked``) at
        shapes (a) and (b), with and without rotations, for each pool of
        ``pools`` ({kind: (deep pool, headline pool)})."""
        out = []
        for kind, (p_a, p_b) in pools.items():
            for label, t_, p_, rend, o_, d_, rm in (("a", tree, p_a, sh_renderer, origins, dirs, rot),
                                                     ("b", tree7, p_b, r7, o7, d7, rot7)):
                sp = t_._baked_spec if structure == "baked" else t_._spec
                out += [(f"({label}) SH9 {kind}", sp(), p_, rend, o_, d_),
                        (f"({label}) SH9+rot {kind}", sp(transformation_matrices=rm), p_, rend, o_, d_)]
        return out

    t_w = time.perf_counter()
    n_w = k2_width_check(width_cases("tree", {"f32": (feats, feats7)})
                         + [("(a) RGBA f32", cases[0][1], cases[0][2], cases[0][3], origins, dirs)], "tree walk")
    print(f"render_fwd widths 4 and 1 equal bit for bit: {n_w} comparisons (shapes (a) and (b), SH9, SH9+rot and "
          f"RGBA, exact and fast, with and without weights), {time.perf_counter() - t_w:.1f} s")

    # K3 against plain: one seeded grad_out per case, each width the row
    # takes (4: the row in vectors, vector atomics; 1: the earlier loop).
    bwd_cases = [
        ("SH9 exact", tree._spec(), feats, sh_renderer, False),
        ("SH9 fast", tree._spec(), feats, sh_renderer, True),
        ("RGBA exact", rgba_tree._spec(), rgba_feats, cases[0][3], False),
        ("SH9+rot exact", tree._spec(transformation_matrices=rot), feats, sh_renderer, False),
        ("SH9+rot fast", tree._spec(transformation_matrices=rot), feats, sh_renderer, True),
        ("SG9 exact", lobe_trees["SG"]._spec(), lobe_pool, cases[3][3], False),
    ]
    worst = 0.0
    bwd_plain_ms = {}
    for name, cspec, cfeats, rend, fast in bwd_cases:
        opt = rend._get_options(fast)
        with torch.no_grad():
            out = render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt)
        g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
        err, bwd_plain_ms[name], nz, ws = k3_width_check(cspec, cfeats, origins, dirs, g_out, opt, out, name)
        worst = max(worst, err)
        print(f"render_bwd {name}: widths {ws} max_abs_err {err:.3g}, {nz} rows with a gradient, plain "
              f"{bwd_plain_ms[name]:.1f} ms")
    kernels["render_bwd"]["max_abs_err"] = worst

    # K8b query against plain: leaf centres in a seeded order plus seeded
    # points, some in empty space.
    q_points = torch.cat([centers[torch.from_numpy(rng.permutation(M)).to(dev)],
                          torch.from_numpy(rng.rand(65536, 3).astype(np.float32)).to(dev)])
    v_k, n_k, d_k = query_ops.query_forward_cuda(spec, feats, q_points)
    v_p, n_p, d_p = query_ops.query_forward_plain(spec, feats, q_points)
    check(torch.equal(v_k, v_p) and torch.equal(n_k, n_p) and torch.equal(d_k, d_p),
          "query forward kernel and plain version disagree")
    empty = int((d_k >= M).sum())
    check(empty > 0, "no query point in empty space")
    g_v = torch.from_numpy(rng.randn(*v_k.shape).astype(np.float32)).to(dev)
    gq_k = query_ops.query_backward_cuda(d_k, g_v, M)
    gq_p = query_ops.query_backward_plain(d_p, g_v, M)
    q_err = atomic_err(gq_k, gq_p, "query_bwd")
    check(float(gq_k.abs().max()) > 0, "query_bwd: zero gradient")
    kernels["query_fwd"]["max_abs_err"] = 0.0
    kernels["query_bwd"]["max_abs_err"] = q_err
    print(f"query: {q_points.shape[0]} points ({empty} in empty space), values and ids equal, "
          f"grad max_abs_err {q_err:.3g}")

    # 3b. Aux kernels against plain on the same scene, with the aux path's
    # seeded skeleton: joints as the tree's extra_data, LBS tables per row.
    joints, jf_true, sw, ji = skeleton(rng, M, dev)
    aux_state = dict(state, extra_data=joints)
    aux_spec = stt.tree_from_numpy(aux_state, device=dev)._spec(
        joint_features=jf_true, skinning_weights=sw, joint_index=ji)
    aux_err = dict(opacity_bwd=0.0, first_hit=0.0, mf_fwd=0.0, mf_bwd=0.0)
    _, ds = traversal.get_delta_scale(aux_spec.scaling, dirs)
    o_tree = traversal.world2tree(origins, aux_spec.offset, aux_spec.scaling)
    d_tree = traversal.get_delta_scale(aux_spec.scaling, dirs)[0]
    for fast in (False, True):
        opt = sh_renderer._get_options(fast)
        mode = "fast" if fast else "exact"
        with torch.no_grad():
            alpha = aux_ops.opacity_render(aux_spec, feats, origins, dirs, opt)
            full = render_ops.volume_render_cuda(aux_spec, feats, origins, dirs, dirs, opt)
        check(torch.equal(alpha, full[:, -1:]), "opacity forward is not the render's alpha")
        g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
        g_k = aux_ops.opacity_backward_cuda(aux_spec, feats, origins, dirs, g_a, opt, out_res=alpha)
        g_p, p_ms = timed_once_ms(lambda: aux_ops.opacity_backward_plain(
            aux_spec, feats, origins, dirs, g_a, opt, out_res=alpha))
        err = atomic_err(g_k, g_p, f"opacity_bwd {mode}")
        check(not bool(g_k[:, :-1].any()), "opacity VJP wrote a color column")
        check(float(g_k[:, -1].abs().max()) > 0, "opacity VJP: zero gradient")
        aux_err["opacity_bwd"] = max(aux_err["opacity_bwd"], err)
        print(f"opacity {mode}: forward equal to the render's alpha; VJP "
              f"({'two passes' if fast else 'one pass'}) max_abs_err {err:.3g} "
              f"(max|g| {float(g_p.abs().max()):.4g}), plain {p_ms:.1f} ms")

        h_k = aux_ops.first_hit_cuda(aux_spec, feats, origins, dirs, opt)
        h_p, p_ms = timed_once_ms(lambda: aux_ops.first_hit_plain(aux_spec, feats, origins, dirs, opt))
        check(torch.equal(h_k[0], h_p[0]) and torch.equal(h_k[2], h_p[2]),
              "first hit: found or rows differ")
        depth_k = torch.where(h_k[0], h_k[1] * ds, 0.0)
        depth_p = torch.where(h_p[0], h_p[1] * ds, 0.0)
        check(torch.equal(depth_k, depth_p), "first hit: depths differ")
        hp_err = float((o_tree + h_k[1][:, None] * d_tree - (o_tree + h_p[1][:, None] * d_tree))
                       .abs().max())
        frac_err = float((h_k[3] - h_p[3]).abs().max())
        check(hp_err <= RENDER_ATOL and frac_err <= RENDER_ATOL,
              f"first hit: hit point {hp_err} or compat frac {frac_err} > {RENDER_ATOL}")
        n_found = int(h_k[0].sum())
        check(n_found > 0, "first hit found nothing")
        aux_err["first_hit"] = max(aux_err["first_hit"], hp_err, frac_err)
        print(f"first hit {mode}: found, rows and depths equal ({n_found} hits), hit point "
              f"max_abs_err {hp_err:.3g}, frac {frac_err:.3g}, plain {p_ms:.1f} ms")

        with torch.no_grad():
            m_k = aux_ops.motion_feature_forward_cuda(aux_spec, jf_true, feats, origins, dirs, opt)
        m_p, p_ms = timed_once_ms(lambda: aux_ops.motion_feature_render_plain(
            aux_spec, jf_true, feats, origins, dirs, opt))
        err = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(m_k).all()), "mf_fwd: non-finite output")
        check(err <= RENDER_ATOL, f"mf_fwd {mode}: kernel vs plain {err} > {RENDER_ATOL}")
        aux_err["mf_fwd"] = max(aux_err["mf_fwd"], err)
        g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
        b_k = aux_ops.motion_feature_backward_cuda(aux_spec, jf_true, feats, origins, dirs, g_m, opt)
        b_p, bp_ms = timed_once_ms(lambda: aux_ops.motion_feature_backward_plain(
            aux_spec, jf_true, feats, origins, dirs, g_m, opt))
        b_err = atomic_err(b_k, b_p, f"mf_bwd {mode}")
        check(float(b_k.abs().max()) > 0, "mf_bwd: zero gradient")
        e_1 = mf_width_check(aux_spec, jf_true, feats, origins, dirs, opt, m_k, m_p, g_m, b_p, f" {mode}")
        aux_err["mf_fwd"] = max(aux_err["mf_fwd"], e_1[0])
        aux_err["mf_bwd"] = max(aux_err["mf_bwd"], b_err, e_1[1])
        print(f"motion features {mode}: forward max_abs_err {err:.3g}, plain {p_ms:.1f} ms; "
              f"VJP max_abs_err {b_err:.3g} (max|g| {float(b_p.abs().max()):.4g}), "
              f"plain {bp_ms:.1f} ms; width 1: forward equal, VJP max_abs_err {e_1[1]:.3g}")
    for k, v in aux_err.items():
        kernels[k]["max_abs_err"] = v

    # 3c. The LBS warp (K10) and the voxelize splat (K11) against their
    # plain versions on the deep dynamic configuration: the canonical
    # cloud is the leaf centres in row order (point i owns pool row i),
    # skinned to the skeleton's N_BONES nearest joints, posed by a seeded
    # sequence; the grid is P2V_N^3 over the unit cube.
    drng = np.random.RandomState(4)
    t0 = time.perf_counter()
    rig_np = skin_to_nearest_joints(centers_np, joints, N_BONES)
    poses = torch.from_numpy(joint_pose_sequence(joints, N_FRAMES, seed=4)).to(dev)
    src = torch.eye(4, device=dev).repeat(N_JOINTS, 1, 1)
    rig_sw, rig_ji = (torch.from_numpy(a).to(dev) for a in rig_np)
    print(f"rig: {N_JOINTS} joints, {N_BONES} nearest per point, {N_FRAMES} poses, "
          f"{time.perf_counter() - t0:.1f} s to build")
    T1 = stt.get_transformation_matrix(src, poses[1])
    wk = warp_ops.warp_forward_cuda(T1, centers, rig_sw, rig_ji)
    wp, warp_fwd_plain_ms = timed_once_ms(
        lambda: warp_ops.warp_forward_plain(T1, centers, rig_sw, rig_ji))
    w_err = max(float((a - b).abs().max()) for a, b in zip(wk, wp))
    check(bool(torch.isfinite(wk[0]).all()), "warp: non-finite points")
    check(w_err <= WARP_ATOL, f"warp_fwd: kernel vs plain {w_err} > {WARP_ATOL}")
    moved = (wk[0] - centers).norm(dim=1)
    print(f"warp_fwd ({M} points, J {N_JOINTS}, {N_BONES} bones): max_abs_err {w_err:.3g} "
          f"(atol {WARP_ATOL}); points move up to {float(moved.max()):.5f} "
          f"(mean {float(moved.mean()):.5f}), plain {warp_fwd_plain_ms:.2f} ms")
    kernels["warp_fwd"]["max_abs_err"] = w_err
    g_x = torch.from_numpy(drng.randn(M, 3).astype(np.float32)).to(dev)
    g_M = torch.from_numpy(drng.randn(M, 4, 4).astype(np.float32)).to(dev)

    def warp_bwd_check(T, sw_, ji_, what):
        got = warp_ops.warp_backward_cuda(T, centers, sw_, ji_, g_x, g_M)
        want, ms = timed_once_ms(
            lambda: warp_ops.warp_backward_plain(T, centers, sw_, ji_, g_x, g_M))
        errs = [atomic_err(got[0], want[0], f"warp_bwd {what} dT")]
        for name, a, b in (("dx", got[1], want[1]), ("dw", got[2], want[2])):
            e = float((a - b).abs().max())
            check(e <= EXACT_RTOL * max(1.0, float(b.abs().max())), f"warp_bwd {what} {name}: {e}")
            errs.append(e)
        check(float(got[0].abs().max()) > 0 and not bool(got[0][:, 3].any()), "warp_bwd: bad dT")
        # The kernel's dT sum order through its plain mirror, and its census.
        t_mirror = time.perf_counter()
        runs_dT, census = warp_ops.warp_dT_runs_plain(T, centers, sw_, ji_, g_x, g_M)
        atomic_err(runs_dT, want[0], f"warp_bwd {what}: the runs mirror")
        print(f"warp_bwd {what}: max_abs_err dT {errs[0]:.3g} (max|dT| "
              f"{float(want[0].abs().max()):.4g}), dx {errs[1]:.3g}, dw {errs[2]:.3g}, "
              f"plain {ms:.2f} ms; K10 census (runs mirror, within ATOMIC_RTOL, "
              f"{time.perf_counter() - t_mirror:.1f} s): {census}, against {12 * census['terms']} shared adds a "
              f"point at a time")
        return max(errs), ms

    e32, warp_bwd_plain_ms = warp_bwd_check(T1, rig_sw, rig_ji, f"J {N_JOINTS} nb {N_BONES}")
    # J = 2, nb = 2 (bench.py's rig): every point adds into the same 24 floats.
    z = centers[:, 2]
    sw2 = torch.stack([1.0 - z, z], dim=1).contiguous()
    ji2 = torch.tensor([0, 1], dtype=torch.int32, device=dev).repeat(M, 1)
    T2 = T1[:2].contiguous()
    e2, _ = warp_bwd_check(T2, sw2, ji2, "J 2 nb 2")
    kernels["warp_bwd"]["max_abs_err"] = max(e32, e2)

    grid = p2v_ops.grid_consts(0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
    check(grid.W == 6, f"p2v window {grid.W}, expected 6")
    warped1 = wk[0]
    vk = p2v_ops.voxelize_forward_cuda(warped1, feats, grid)
    vp, vox_fwd_plain_ms = timed_once_ms(lambda: p2v_ops.voxelize_forward_plain(warped1, feats, grid))
    v_err = atomic_err(vk, vp, "voxelize_fwd")
    touched = int((vk != 0).sum())
    g_vol = torch.from_numpy(drng.randn(P2V_N, P2V_N, P2V_N, 1).astype(np.float32)).to(dev)
    dk = p2v_ops.voxelize_backward_cuda(warped1, feats, grid, g_vol)
    dpl, vox_bwd_plain_ms = timed_once_ms(
        lambda: p2v_ops.voxelize_backward_plain(warped1, feats, grid, g_vol))
    vb_err = 0.0
    for name, a, b in (("d_points", dk[0], dpl[0]), ("d_features", dk[1], dpl[1])):
        e = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()), f"voxelize_bwd {name}: non-finite")
        check(e <= EXACT_RTOL * max(1.0, float(b.abs().max())), f"voxelize_bwd {name}: {e}")
        vb_err = max(vb_err, e)
    check(not bool(dk[1][:, :-1].any()) and float(dk[0].abs().max()) > 0,
          "voxelize_bwd: gradient outside the density column, or none")
    # The serving frames' order: the same cloud in a random permutation, whose
    # blocks' boxes are too large for the shared tile (the direct splat).
    t_tiles = time.perf_counter()
    shuffle = torch.from_numpy(np.random.RandomState(0).permutation(M)).to(dev)
    warped_rand, feats_rand = warped1[shuffle].contiguous(), feats[shuffle].contiguous()
    vs_err = atomic_err(p2v_ops.voxelize_forward_cuda(warped_rand, feats_rand, grid),
                        p2v_ops.voxelize_forward_plain(warped_rand, feats_rand, grid), "voxelize_fwd shuffled")
    tile_census = {}
    for order, (pts_o, feats_o) in {"row order": (warped1, feats), "shuffled": (warped_rand, feats_rand)}.items():
        vol_t, tiled = p2v_ops.voxelize_tiles_cuda(pts_o, feats_o, grid)
        mirror_vol, census = p2v_ops.voxelize_forward_tiled_plain(pts_o, feats_o, grid)
        want_o = vp if order == "row order" else None
        if want_o is not None:
            atomic_err(vol_t, want_o, "voxelize_fwd (census entry)")
            atomic_err(mirror_vol, want_o, "voxelize_fwd: the tiled mirror")
        check(tiled == census["tiled"], f"voxelize_fwd {order}: the kernel tiled {tiled} blocks, the mirror "
              f"{census['tiled']}")
        tile_census[order] = census
    kernels["voxelize_fwd"]["max_abs_err"] = max(v_err, vs_err)
    kernels["voxelize_bwd"]["max_abs_err"] = vb_err
    print(f"voxelize ({M} points, {P2V_N}^3 grid, W {grid.W}): forward max_abs_err {v_err:.3g} "
          f"(max {float(vp.max()):.4g}, {touched} voxels touched), shuffled {vs_err:.3g}, plain "
          f"{vox_fwd_plain_ms:.1f} ms; backward max_abs_err {vb_err:.3g}, plain {vox_bwd_plain_ms:.1f} ms; "
          f"K11 census (tiled mirror, its tiled blocks equal to the kernel's; the shuffled check and the census "
          f"{time.perf_counter() - t_tiles:.1f} s): {tile_census}")

    # 3d. The bake (the default backend's structure): the depth-9 shell
    # baked on the host; the K6 point lookup, K7a refresh after a re-point
    # and points_leaf_aabb against their plain versions, exactly; K7b
    # skip-box regrowth on bench.py's dynamic tree (whose bake has skip
    # boxes); the baked instances of the march kernels against their plain
    # versions; and the two backends, kernel against kernel, bit for bit in
    # exact mode.
    brng = np.random.RandomState(5)
    t0 = time.perf_counter()
    baked = tree._baked_spec()
    bake_s = time.perf_counter() - t0
    n_brick = baked.brick.numel() // baked.B ** 3
    mb = lambda t: 0.0 if t is None else t.numel() * 4 / 1e6  # noqa: E731
    print(f"bake: {bake_s:.2f} s on the host; top_levels {baked.top_levels} ({baked.R}^3 top grid, "
          f"{mb(baked.top):.2f} MB), mid_levels {baked.mid_levels} ({mb(baked.mid):.2f} MB), "
          f"brick_levels {baked.brick_levels} ({n_brick} bricks of {baked.B ** 3} cells, "
          f"{mb(baked.brick):.2f} MB), src_map and depth_parts {mb(baked.src_map):.2f} MB each, "
          f"skip_base {baked.skip_base}, occupied box {baked.aabb_lo.tolist()} - "
          f"{baked.aabb_hi.tolist()}")
    leaf_pts = traversal.world2tree(centers, spec.offset, spec.scaling)
    lk_pts = torch.cat([leaf_pts, torch.from_numpy(
        (brng.rand(N_LOOKUP_POINTS, 3) * 1.2 - 0.1).astype(np.float32)).to(dev)]).contiguous()
    lk_k = bake_ops.lookup_cuda(baked, lk_pts)
    lk_p, lookup_plain_ms = timed_once_ms(lambda: bake_ops.lookup_plain(baked, lk_pts))
    for name, a, b_ in zip(("row", "cube", "frac", "cell"), lk_k, lk_p):
        check(torch.equal(a, b_), f"lookup: kernel and plain {name} differ")
    leaf_ref = traversal.descend(spec, lk_pts)
    occ = leaf_ref.data_idx < M
    check(torch.equal(lk_k[0][occ], leaf_ref.data_idx[occ]) and torch.equal(lk_k[2], leaf_ref.frac)
          and torch.equal(lk_k[1], leaf_ref.cube_sz), "lookup: rows or fractions differ from the descent")
    check(torch.equal(baked.src_map[lk_k[3].long()], leaf_ref.node_flat), "lookup: cells differ")
    kernels["bake_lookup"]["max_abs_err"] = 0.0
    print(f"lookup: {lk_pts.shape[0]} points ({M} leaf centres), row, cube, fraction and cell equal "
          f"to plain and to the descent, plain {lookup_plain_ms:.1f} ms")

    new_flat = query_ops.construct_tree_cuda(spec, points)
    box_k = query_ops.points_leaf_aabb_cuda(spec, points)
    box_p, aabb_plain_ms = timed_once_ms(lambda: query_ops.points_leaf_aabb_plain(spec, points))
    check(torch.equal(box_k[0], box_p[0]) and torch.equal(box_k[1], box_p[1]),
          "points_leaf_aabb: kernel and plain differ")
    lo, hi = query_ops.points_leaf_aabb_cuda(spec, points, union=(baked.aabb_lo, baked.aabb_hi))
    check(torch.equal(lo, torch.minimum(box_k[0], baked.aabb_lo))
          and torch.equal(hi, torch.maximum(box_k[1], baked.aabb_hi)),
          "points_leaf_aabb: the union with the bake's box differs")
    ref_k = bake_ops.refresh_cuda(baked, new_flat, lo, hi)
    ref_p, refresh_plain_ms = timed_once_ms(lambda: bake_ops.refresh_plain(baked, new_flat, lo, hi))
    for name in ("top", "mid", "brick"):
        a, b_ = getattr(ref_k, name), getattr(ref_p, name)
        check((a is None and b_ is None) or torch.equal(a, b_), f"refresh: kernel and plain {name} differ")
    check(not torch.equal(ref_k.brick, baked.brick), "refresh changed no brick entry")
    kernels["bake_refresh"]["max_abs_err"] = 0.0
    kernels["points_aabb"]["max_abs_err"] = 0.0
    # The fused re-point (K8a with K8b's box): its table and box equal to
    # the plain version's and to the two calls above, with the bake's box as
    # the union and without one.
    t_fused = time.perf_counter()
    union = (baked.aabb_lo, baked.aabb_hi)
    fused = query_ops.construct_tree_aabb_cuda(spec, points, union=union)
    fused_p, fused_plain_ms = timed_once_ms(lambda: query_ops.construct_tree_aabb_plain(spec, points, union))
    check(all(torch.equal(a, b_) for a, b_ in zip(fused, fused_p)), "construct_tree_aabb: kernel and plain differ")
    check(torch.equal(fused[0], new_flat) and torch.equal(fused[1], lo) and torch.equal(fused[2], hi),
          "construct_tree_aabb: not construct_tree and points_leaf_aabb with the union")
    fused0 = query_ops.construct_tree_aabb_cuda(spec, points)
    check(torch.equal(fused0[0], new_flat) and torch.equal(fused0[1], box_k[0]) and torch.equal(fused0[2], box_k[1]),
          "construct_tree_aabb: not construct_tree and points_leaf_aabb without a union")
    kernels["construct_tree_aabb"]["max_abs_err"] = 0.0
    print(f"construct_tree_aabb ({M} points): table and box equal to plain and to construct_tree + "
          f"points_leaf_aabb, with the bake's box as the union and without (plain {fused_plain_ms:.1f} ms); "
          f"{time.perf_counter() - t_fused:.2f} s")
    print(f"points_leaf_aabb ({M} points): {box_k[0].tolist()} - {box_k[1].tolist()}, equal to plain "
          f"(plain {aabb_plain_ms:.1f} ms); refresh ({ref_k.src_map.numel()} baked cells) equal to "
          f"plain (plain {refresh_plain_ms:.1f} ms)")

    # bench.py's dynamic configuration (bench.py:676-732): a depth-5 RGBA
    # tree pointed at a 20,000-point cloud; its bake has skip boxes.
    bd = bench_dynamic_cloud()
    bench_args = [torch.from_numpy(bd[k]).to(dev)
                  for k in ("poses", "src_pose", "points", "skinning_weights", "joint_index")]
    n_bench = bench_args[0].shape[0]
    bench_feats = torch.from_numpy(bd["features"]).to(dev)

    def bench_tree_on_card():
        t = stt.N3Tree(N=2, data_dim=4, depth_limit=6, device=dev)
        t.refine(repeats=5)
        t.construct_tree(bd["points"])
        return t

    gb_tree = bench_tree_on_card()
    gb = gb_tree._baked_spec()
    check(gb.skip_base != 0, "bench.py's tree bakes without skip boxes")
    # Frame 1 of bench.py's fast frames, as render_dynamic_frames makes it:
    # re-point, the union of the box with the points' leaf box, refresh,
    # regrow.
    tk = stt.get_transformation_matrix(bench_args[1], bench_args[0][1])
    gb_warped, gb_mats = stt.warp_vertices(tk, *bench_args[2:])
    gb_spec = gb_tree._spec()
    gb_lo, gb_hi = query_ops.points_leaf_aabb_cuda(gb_spec, gb_warped, union=(gb.aabb_lo, gb.aabb_hi))
    gb_ref = bake_ops.refresh_cuda(gb, query_ops.construct_tree_cuda(gb_spec, gb_warped), gb_lo, gb_hi)
    grow_k = bake_ops.grow_boxes_cuda(gb_ref)
    grow_p, grow_plain_ms = timed_once_ms(lambda: bake_ops.grow_boxes_plain(gb_ref))
    check(torch.equal(grow_k.top, grow_p.top), "grow_boxes: kernel and plain differ")
    code = (grow_k.top & bake_ops.ROW_MASK) - bake_ops.SKIP_BASE
    n_boxes = int(((grow_k.top >= 0) & (code > 0) & (code < bake_ops._SKIP_BITS_SPAN)).sum())
    check(n_boxes > 0, "grow_boxes grew no box")
    kernels["grow_boxes"]["max_abs_err"] = 0.0
    print(f"grow_boxes (bench.py's tree, {gb.R}^3 top grid): equal to plain, {n_boxes} top cells with "
          f"a box, plain {grow_plain_ms:.1f} ms")

    # That frame's fast render, whose march steps across the skip boxes
    # (the depth-9 shell bakes without them), against its plain version.
    gb_r = stt.VolumeRenderer(gb_tree)
    gb_opt = gb_r._get_options(True)
    gb_o, gb_d, gb_v = gb_r._camera_rays(orbit_camera(), WIDTH, HEIGHT, BENCH_FX, None, gb_opt)
    gb_sp = grow_k.with_(transformation_matrices=gb_mats)
    with torch.no_grad():
        skip_k = render_ops.volume_render_cuda(gb_sp, bench_feats, gb_o, gb_d, gb_v, gb_opt)
        skip_p = render_ops.volume_render_plain(gb_sp, bench_feats, gb_o, gb_d, gb_v, gb_opt)
    skip_err = float((skip_k - skip_p).abs().max())
    n_exits = skip_exits(gb_sp, bench_feats, gb_o, gb_d, gb_opt)
    check(bool(torch.isfinite(skip_k).all()) and skip_err <= RENDER_ATOL,
          f"baked fast frame with skip boxes: kernel vs plain {skip_err} > {RENDER_ATOL}")
    check(n_exits > 0, "baked fast frame: no sample stepped across a skip box")
    print(f"render_fwd_baked RGBA fast on bench.py's frame 1 (skip boxes, {WIDTH}x{HEIGHT}, fx {BENCH_FX}): "
          f"max_abs_err {skip_err:.3g}, {n_exits} samples before the first hit step across a skip box")

    # The baked march instances against their plain versions.
    baked_rot = tree._baked_spec(transformation_matrices=rot)
    worst = dict(render_fwd_baked=skip_err, render_bwd_baked=0.0)
    baked_plain_ms = {}
    with torch.no_grad():
        for name, bspec in (("SH9", baked), ("SH9+rot", baked_rot)):
            for fast in (False, True):
                opt = sh_renderer._get_options(fast)
                out_k = render_ops.volume_render_cuda(bspec, feats, origins, dirs, dirs, opt)
                out_p, baked_plain_ms[(name, fast)] = timed_once_ms(
                    lambda: render_ops.volume_render_plain(bspec, feats, origins, dirs, dirs, opt))
                err = float((out_k - out_p).abs().max())
                check(bool(torch.isfinite(out_k).all()), f"baked {name}: non-finite output")
                check(err <= RENDER_ATOL, f"baked {name} fast={fast}: kernel vs plain {err}")
                worst["render_fwd_baked"] = max(worst["render_fwd_baked"], err)
                print(f"render_fwd_baked {name} {'fast' if fast else 'exact'}: max_abs_err {err:.3g}, "
                      f"plain {baked_plain_ms[(name, fast)]:.1f} ms")
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            out_k, w_k = render_ops.volume_render_with_weight_accum_cuda(
                baked, feats, origins, dirs, dirs, opt)
            out_p, w_p = render_ops.volume_render_with_weight_accum_plain(
                baked, feats, origins, dirs, dirs, opt)
            err = float((out_k - out_p).abs().max())
            check(err <= RENDER_ATOL, f"baked weight-accumulating march: outputs differ by {err}")
            w_err = atomic_err(w_k, w_p, f"baked waccum fast={fast}")
            worst["render_fwd_baked"] = max(worst["render_fwd_baked"], err, w_err)
            total = float(w_k.sum())
            check(total > 0, "baked: no weight accumulated")
            if not fast:
                alpha_sum = float(out_k[:, -1].sum())
                check(abs(total - alpha_sum) <= 1e-4 * abs(alpha_sum),
                      f"baked exact waccum sum {total} != alpha sum {alpha_sum}")
            print(f"render_fwd_baked+waccum SH9 {'fast' if fast else 'exact'}: out max_abs_err "
                  f"{err:.3g}, waccum max_abs_err {w_err:.3g}, sum {total:.6g}")
    t_w = time.perf_counter()
    n_w = k2_width_check(width_cases("baked", {"f32": (feats, feats7)}), "bake")
    print(f"render_fwd_baked widths 4 and 1 equal bit for bit: {n_w} comparisons (shapes (a) and (b), SH9 and "
          f"SH9+rot, exact and fast, with and without weights), {time.perf_counter() - t_w:.1f} s")
    for fast in (False, True):
        opt = sh_renderer._get_options(fast)
        for label, bspec in (("SH9", baked), ("SH9+rot", baked_rot)):
            with torch.no_grad():
                out = render_ops.volume_render_cuda(bspec, feats, origins, dirs, dirs, opt)
            g_out = torch.from_numpy(brng.randn(*out.shape).astype(np.float32)).to(dev)
            err, p_ms, nz, ws = k3_width_check(bspec, feats, origins, dirs, g_out, opt, out,
                                               f"baked {label} fast={fast}")
            if label == "SH9":
                baked_plain_ms[("bwd", fast)] = p_ms
            worst["render_bwd_baked"] = max(worst["render_bwd_baked"], err)
            print(f"render_bwd_baked {label} {'fast' if fast else 'exact'}: widths {ws} max_abs_err {err:.3g}, "
                  f"{nz} rows with a gradient, plain {p_ms:.1f} ms")
    for k_, v in worst.items():
        kernels[k_]["max_abs_err"] = v

    aux_baked_tree = stt.tree_from_numpy(aux_state, device=dev)
    aux_baked = aux_baked_tree._baked_spec(skinning_weights=sw, joint_index=ji)
    aux_err_b = dict(opacity_bwd_baked=0.0, first_hit_baked=0.0, mf_fwd_baked=0.0, mf_bwd_baked=0.0)
    for fast in (False, True):
        opt = sh_renderer._get_options(fast)
        mode = "fast" if fast else "exact"
        with torch.no_grad():
            alpha = aux_ops.opacity_render(aux_baked, feats, origins, dirs, opt)
        g_a = torch.from_numpy(brng.randn(B, 1).astype(np.float32)).to(dev)
        g_k = aux_ops.opacity_backward_cuda(aux_baked, feats, origins, dirs, g_a, opt, out_res=alpha)
        g_p, baked_plain_ms[("opacity_bwd", fast)] = timed_once_ms(lambda: aux_ops.opacity_backward_plain(
            aux_baked, feats, origins, dirs, g_a, opt, out_res=alpha))
        e_o = atomic_err(g_k, g_p, f"opacity_bwd_baked {mode}")
        h_k = aux_ops.first_hit_cuda(aux_baked, feats, origins, dirs, opt)
        h_p, baked_plain_ms[("first_hit", fast)] = timed_once_ms(
            lambda: aux_ops.first_hit_plain(aux_baked, feats, origins, dirs, opt))
        check(all(torch.equal(a, b_) for a, b_ in zip(h_k[:3], h_p[:3])),
              "first_hit_baked: found, t_hit or rows differ")
        e_h = float((h_k[3] - h_p[3]).abs().max())
        check(e_h <= RENDER_ATOL and int(h_k[0].sum()) > 0, f"first_hit_baked: frac {e_h}, or no hit")
        with torch.no_grad():
            m_k = aux_ops.motion_feature_forward_cuda(aux_baked, jf_true, feats, origins, dirs, opt)
        m_p, baked_plain_ms[("mf_fwd", fast)] = timed_once_ms(lambda: aux_ops.motion_feature_render_plain(
            aux_baked, jf_true, feats, origins, dirs, opt))
        e_m = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(m_k).all()) and e_m <= RENDER_ATOL, f"mf_fwd_baked {mode}: {e_m}")
        g_m = torch.from_numpy(brng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
        b_k = aux_ops.motion_feature_backward_cuda(aux_baked, jf_true, feats, origins, dirs, g_m, opt)
        b_p, baked_plain_ms[("mf_bwd", fast)] = timed_once_ms(lambda: aux_ops.motion_feature_backward_plain(
            aux_baked, jf_true, feats, origins, dirs, g_m, opt))
        e_b = atomic_err(b_k, b_p, f"mf_bwd_baked {mode}")
        check(float(b_k.abs().max()) > 0, "mf_bwd_baked: zero gradient")
        e_1 = mf_width_check(aux_baked, jf_true, feats, origins, dirs, opt, m_k, m_p, g_m, b_p, f"_baked {mode}")
        e_m, e_b = max(e_m, e_1[0]), max(e_b, e_1[1])
        for k_, e in (("opacity_bwd_baked", e_o), ("first_hit_baked", e_h), ("mf_fwd_baked", e_m),
                      ("mf_bwd_baked", e_b)):
            aux_err_b[k_] = max(aux_err_b[k_], e)
        print(f"baked aux {mode}: opacity VJP max_abs_err {e_o:.3g}, first hit equal "
              f"({int(h_k[0].sum())} hits, frac {e_h:.3g}), motion features {e_m:.3g}, "
              f"VJP {e_b:.3g}")
    for k_, v in aux_err_b.items():
        kernels[k_]["max_abs_err"] = v

    # The backends kernel against kernel: exact mode, bit for bit.
    with torch.no_grad():
        opt_x = sh_renderer._get_options(False)
        for name, bspec, tspec in (("SH9", baked, spec),
                                   ("SH9+rot", baked_rot, tree._spec(transformation_matrices=rot))):
            out_b = render_ops.volume_render_cuda(bspec, feats, origins, dirs, dirs, opt_x)
            out_t = render_ops.volume_render_cuda(tspec, feats, origins, dirs, dirs, opt_x)
            check(torch.equal(out_b, out_t), f"{name}: baked and tree exact outputs differ")
        dep_b = aux_ops.render_depth(baked, feats, origins, dirs, opt_x)
        dep_t = aux_ops.render_depth(spec, feats, origins, dirs, opt_x)
        check(torch.equal(dep_b, dep_t), "baked and tree exact depths differ")
    print("backends: exact colors, alpha and depth of the baked and tree kernels equal bit for bit "
          f"on {B} rays (SH9, SH9+rot)")

    # 3e. Trilinear interpolation (K4): the interp instances of the six
    # march kernels on both structures against their plain versions, on
    # every camera ray of the aux scene (its joints and LBS tables, the
    # canonical pool), exact as the main path runs them (and the forward
    # fast too); then the two structures' interp kernels against each
    # other, exact colors, alpha and depth bit for bit.
    irng = np.random.RandomState(7)
    interp_r = stt.VolumeRenderer(tree, interp="trilinear")
    interp_specs = {"_interp": aux_spec, "_baked_interp": aux_baked}
    interp_plain_ms, interp_out = {}, {}
    t_3e = time.perf_counter()
    for sfx, ispec in interp_specs.items():
        err = {name: 0.0 for name in MARCH_KERNELS}
        for fast in (True, False):
            opt = interp_r._get_options(fast)
            mode = "fast" if fast else "exact"
            with torch.no_grad():
                out_k = render_ops.volume_render_cuda(ispec, feats, origins, dirs, dirs, opt)
            out_p, p_ms = timed_once_ms(
                lambda: render_ops.volume_render_plain(ispec, feats, origins, dirs, dirs, opt))
            e = float((out_k - out_p).abs().max())
            check(bool(torch.isfinite(out_k).all()) and e <= RENDER_ATOL,
                  f"render_fwd{sfx} {mode}: kernel vs plain {e} > {RENDER_ATOL}")
            err["render_fwd"] = max(err["render_fwd"], e)
            print(f"interp render_fwd{sfx} {mode} ({B} rays): max_abs_err {e:.3g}, "
                  f"hit share {float((out_k[:, -1] > 0).float().mean()):.3f}, plain {p_ms:.1f} ms")
        del out_p
        interp_plain_ms["render_fwd" + sfx] = p_ms
        # K3+K4 at both widths against plain: exact (single pass, the main
        # path's), with seeded rotations too, and fast (two passes).
        for label, bspec, fast in (("exact (single pass)", ispec, False),
                                   ("exact (single pass) rot", ispec.with_(transformation_matrices=rot), False),
                                   ("fast (two passes)", ispec, True)):
            b_opt = interp_r._get_options(fast)
            with torch.no_grad():
                out_b = render_ops.volume_render_cuda(bspec, feats, origins, dirs, dirs, b_opt)
            g_out = torch.from_numpy(irng.randn(*out_b.shape).astype(np.float32)).to(dev)
            e_, p_ms, nz, ws = k3_width_check(bspec, feats, origins, dirs, g_out, b_opt, out_b, f"{sfx} {label}")
            if bspec is ispec and not fast:
                interp_plain_ms["render_bwd" + sfx] = p_ms
            err["render_bwd"] = max(err["render_bwd"], e_)
            print(f"interp render_bwd{sfx} {label}: widths {ws} max_abs_err {e_:.3g}, {nz} rows with a gradient, "
                  f"plain {p_ms:.1f} ms")
            del out_b
        with torch.no_grad():
            ok_, w_k = render_ops.volume_render_with_weight_accum_cuda(ispec, feats, origins, dirs, dirs, opt)
        op_, w_p = render_ops.volume_render_with_weight_accum_plain(ispec, feats, origins, dirs, dirs, opt)
        check(float((ok_ - op_).abs().max()) <= RENDER_ATOL, f"render_fwd{sfx} with weights: outputs")
        err["render_fwd"] = max(err["render_fwd"], atomic_err(w_k, w_p, f"render_fwd{sfx} weights"))
        check(float(w_k.sum()) > 0, f"render_fwd{sfx}: no weight accumulated")
        alpha = out_k[:, -1:].contiguous()
        g_a = torch.from_numpy(irng.randn(B, 1).astype(np.float32)).to(dev)
        a_k = aux_ops.opacity_backward_cuda(ispec, feats, origins, dirs, g_a, opt, out_res=alpha)
        a_p, interp_plain_ms["opacity_bwd" + sfx] = timed_once_ms(lambda: aux_ops.opacity_backward_plain(
            ispec, feats, origins, dirs, g_a, opt, out_res=alpha))
        err["opacity_bwd"] = atomic_err(a_k, a_p, f"opacity_bwd{sfx}")
        check(not bool(a_k[:, :-1].any()) and float(a_k[:, -1].abs().max()) > 0,
              f"opacity_bwd{sfx}: bad gradient")
        h_k = aux_ops.first_hit_cuda(ispec, feats, origins, dirs, opt)
        h_p, interp_plain_ms["first_hit" + sfx] = timed_once_ms(
            lambda: aux_ops.first_hit_plain(ispec, feats, origins, dirs, opt))
        check(all(torch.equal(a, b_) for a, b_ in zip(h_k[:3], h_p[:3])),
              f"first_hit{sfx}: found, t_hit or rows differ")
        err["first_hit"] = float((h_k[3] - h_p[3]).abs().max())
        check(err["first_hit"] <= RENDER_ATOL and int(h_k[0].sum()) > 0, f"first_hit{sfx}: frac or no hit")
        m_k = aux_ops.motion_feature_forward_cuda(ispec, jf_true, feats, origins, dirs, opt)
        m_p, interp_plain_ms["mf_fwd" + sfx] = timed_once_ms(lambda: aux_ops.motion_feature_render_plain(
            ispec, jf_true, feats, origins, dirs, opt))
        err["mf_fwd"] = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(m_k).all()) and err["mf_fwd"] <= RENDER_ATOL, f"mf_fwd{sfx}: {err['mf_fwd']}")
        g_m = torch.from_numpy(irng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
        b_k = aux_ops.motion_feature_backward_cuda(ispec, jf_true, feats, origins, dirs, g_m, opt)
        b_p, interp_plain_ms["mf_bwd" + sfx] = timed_once_ms(lambda: aux_ops.motion_feature_backward_plain(
            ispec, jf_true, feats, origins, dirs, g_m, opt))
        err["mf_bwd"] = atomic_err(b_k, b_p, f"mf_bwd{sfx}")
        check(float(b_k.abs().max()) > 0, f"mf_bwd{sfx}: zero gradient")
        e_1 = mf_width_check(ispec, jf_true, feats, origins, dirs, opt, m_k, m_p, g_m, b_p, sfx)
        err["mf_fwd"], err["mf_bwd"] = max(err["mf_fwd"], e_1[0]), max(err["mf_bwd"], e_1[1])
        print(f"interp aux{sfx} exact ({B} rays): opacity VJP max_abs_err {err['opacity_bwd']:.3g}, first hit "
              f"equal ({int(h_k[0].sum())} hits, {int((h_k[1] > 0).sum())} with a t_hit; frac "
              f"{err['first_hit']:.3g}), motion features {err['mf_fwd']:.3g}, VJP {err['mf_bwd']:.3g}; "
              f"plain ms {({k: round(v, 1) for k, v in interp_plain_ms.items() if k.endswith(sfx) and not k.startswith('render')})}")
        for name, e in err.items():
            kernels[name + sfx]["max_abs_err"] = e
        with torch.no_grad():
            interp_out[sfx] = (out_k, aux_ops.render_depth(ispec, feats, origins, dirs, opt))
    check(torch.equal(interp_out["_interp"][0], interp_out["_baked_interp"][0]),
          "interp: baked and tree exact outputs differ")
    check(torch.equal(interp_out["_interp"][1], interp_out["_baked_interp"][1]),
          "interp: baked and tree exact depths differ")
    out_it = interp_out["_interp"][0]
    with torch.no_grad():
        out_n = render_ops.volume_render_cuda(aux_baked, feats, origins, dirs, dirs, sh_renderer._get_options(False))
    print(f"interp backends: exact colors, alpha and depth of the baked and tree interp kernels equal bit for bit "
          f"on {B} rays; hit share {float((out_it[:, -1] > 0).float().mean()):.4f} (nearest "
          f"{float((out_n[:, -1] > 0).float().mean()):.4f}), max |interp - nearest| "
          f"{float((out_it - out_n).abs().max()):.4g}; phase 3e {time.perf_counter() - t_3e:.1f} s")
    del interp_out, out_it, out_n

    # 3f. Feature pools (K5): every bf16 and int8 instance against the
    # float32 kernels and its plain version, both structures, both interp
    # modes; the bf16 point query.
    t_w = time.perf_counter()
    pools_w = {k_: (pool_of(k_, feats)[0], pool_of(k_, feats7)[0]) for k_ in POOL_KINDS}
    n_w = sum(k2_width_check(width_cases(s_, pools_w), f"{s_} pools") for s_ in ("tree", "baked"))
    print(f"render_fwd pool instances (bf16, int8) widths 4 and 1 equal bit for bit on both structures: {n_w} "
          f"comparisons (shapes (a) and (b), SH9 and SH9+rot, exact and fast, with and without weights), "
          f"{time.perf_counter() - t_w:.1f} s")
    del pools_w
    pool_plain_ms = pool_kernel_phase({"": aux_spec, "_baked": aux_baked}, feats, jf_true, origins, dirs,
                                      {"": sh_renderer, "_interp": interp_r}, kernels, dev)
    query_bf16_check(spec, feats, q_points, kernels, dev)
    print(f"pool bytes ({M} rows x 28 channels): float32 {M * 28 * 4 / 1e6:.1f} MB, bf16 "
          f"{M * 28 * 2 / 1e6:.1f} MB, int8 {(M * 28 + 2 * 28 * 4) / 1e6:.1f} MB [{card}]")

    # 3g. Recorded sample tapes (K13): the count, record and replay kernels
    # against their plain versions and the march kernels, both structures,
    # exact and fast, compacted and not.
    tape_res = tape_kernel_phase(
        state, spec, baked, feats, rot, origins, dirs, centers,
        (gb_sp, bench_feats, gb_o, gb_d, gb_v, gb_opt),
        {fast: sh_renderer._get_options(fast) for fast in (False, True)}, kernels, dev)

    # 3h. Minibatch tape training (K14) and the dense-grid weight pass (K12)
    # against their plain versions at the main paths' shapes: bench.py's
    # minibatch rig and the depth-9 shell's density grid.
    mb = minibatch_scene(dev)
    gscene = grid_scene(centers_np, feats_np[:, -1], dev)
    mb_census = subset_kernel_phase(mb, gscene, kernels, dev, card)

    # 3i. The ray schedules' cost walk (K15) against its plain version on
    # every camera ray, both structures, exact and fast (with and without
    # the pool's sigma column).
    cost_res = cost_kernel_phase({"": spec, "_baked": baked}, feats, origins, dirs,
                                 {fast: sh_renderer._get_options(fast) for fast in (False, True)}, kernels)

    arena_reruns = tape_ops.ARENA_RERUNS["reruns"]
    # 4. Main path, serving: three frames through the public entry points,
    # on the default baked backend (baked once, as at load; every re-point
    # then refreshes the bake) and on the tree walk.
    frame_points = [centers[torch.from_numpy(rng.permutation(M)).to(dev)] for _ in range(N_FRAMES)]
    frame_feats = [seeded_pool(rng, M, 28, dev) for _ in range(N_FRAMES)]
    c2w = orbit_camera()
    sample = torch.arange(0, B, 97, device=dev)
    serve_trees, serve_counts, serve_images = {}, {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        serve_tree = stt.tree_from_numpy(state, device=dev)
        renderer = stt.VolumeRenderer(serve_tree, backend=backend)
        if backend == "baked":
            serve_tree._baked_spec()
        reset_counts()
        frame_s, images, tables = [], [], []
        with torch.no_grad():
            for i in range(N_FRAMES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve_tree.construct_tree(frame_points[i])
                img_exact = renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX)
                img_fast = renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX, fast=True)
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
                images.append((img_exact, img_fast))
                tables.append(serve_tree._spec().data_flat.clone())
        counts = read_counts()
        print(f"main path, serving ({LABEL[backend]}): {N_FRAMES} frames, launches {nonzero(counts)}, "
              f"host ms per frame (construct + exact + fast) {[round(x * 1e3, 3) for x in frame_s]}")
        check(counts["repoint"] == N_FRAMES, "construct_tree kernel not launched per frame")
        check(counts["render_fwd" + sfx] == 2 * N_FRAMES, "render kernel not launched per render")
        check_bake_counts(counts, backend, N_FRAMES)
        check_march_widths(counts, f"serving ({backend})")
        # Outputs are right: shape, finite, alpha in [0, 1], hits and misses,
        # and a strided pixel sample equal to the plain version on the same
        # frame state.
        with torch.no_grad():
            for img_exact, img_fast in images:
                for img in (img_exact, img_fast):
                    check(tuple(img.shape) == (HEIGHT, WIDTH, 4), f"image shape {tuple(img.shape)}")
                    check(bool(torch.isfinite(img).all()), "non-finite image")
                    a = img[..., 3]
                    check(bool((a >= 0).all() and (a <= 1).all()), "alpha outside [0, 1]")
                    check(bool((a > 0).any() and (a == 0).any()), "no hit or no miss pixels")
            opt_e = renderer._get_options(False)
            ref = render_ops.volume_render_plain(renderer._render_spec(), frame_feats[-1],
                                                 origins[sample], dirs[sample], dirs[sample], opt_e)
            err = float((images[-1][0].reshape(B, 4)[sample] - ref).abs().max())
            print(f"last frame exact vs plain on {sample.numel()} pixels: max_abs_err {err:.3g}")
            check(err <= RENDER_ATOL, f"served frame disagrees with plain version: {err}")
            for i in range(1, N_FRAMES):
                check(not torch.equal(tables[i - 1], tables[i]), "index table did not change per frame")
        serve_trees[backend], serve_counts[backend], serve_images[backend] = serve_tree, counts, images
    fast_diff = 0.0
    for (e_b, f_b), (e_t, f_t) in zip(serve_images["baked"], serve_images["tree"]):
        check(torch.equal(e_b, e_t), "the backends' exact frames differ")
        fast_diff = max(fast_diff, float((f_b - f_t).abs().max()))
    print(f"serving: the backends' exact frames equal bit for bit; their fast frames differ by up to "
          f"{fast_diff:.3g} (the bake's box advance)")

    # 4b. Main path, training: Adam steps through the public entry points
    # (N_STEPS on the default backend, N_TREE_STEPS on the tree walk).
    true_pool = seeded_pool(rng, M, 28, dev)
    pool0 = seeded_pool(rng, M, 28, dev)
    perms = [torch.from_numpy(rng.permutation(M)).to(dev) for _ in range(N_STEPS)]
    prior_points = centers[torch.from_numpy(rng.choice(M, N_PRIOR_POINTS, replace=False)).to(dev)]
    train_counts, step_ms = {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        steps = N_STEPS if backend == "baked" else N_TREE_STEPS
        train_tree = stt.tree_from_numpy(state, device=dev)
        reset_counts()
        pool, losses, image_losses, step_ms[backend], weights = train(
            train_tree, true_pool, pool0, centers, perms, prior_points, steps,
            accumulate_at=steps // 2, backend=backend)
        counts = train_counts[backend] = read_counts()
        print(f"main path, training ({LABEL[backend]}): {steps} steps, launches {nonzero(counts)}, "
              f"loss {[round(x, 8) for x in losses]}, image loss {[round(x, 8) for x in image_losses]}, "
              f"host ms per step {[round(x, 3) for x in step_ms[backend]]}")
        # construct_tree runs once more per call of train(): the target's pointing.
        check(counts["repoint"] == steps + 1, "construct_tree not launched per step")
        check(counts["render_fwd" + sfx] == steps + 1, "render_fwd not launched per step")
        check(counts["render_bwd" + sfx] == steps, "render_bwd not launched once per step")
        check_march_bwd_widths(counts, f"training ({backend})")
        check(counts["query_fwd"] == steps and counts["query_bwd"] == steps,
              "query kernels not launched per step")
        check_query_units(counts, f"training ({backend})")
        check_bake_counts(counts, backend, steps + 1)
        check(losses[-1] < losses[0] and image_losses[-1] < image_losses[0], "the loss did not fall")
        check(pool.grad is not None and bool(torch.isfinite(pool.grad).all()), "non-finite gradient")
        check(float(pool.grad.abs().max()) > 0, "zero gradient")
        check(weights is not None and weights.shape == (train_tree.n_leaves,), "no accumulated weights")
        check(bool(torch.isfinite(weights).all()) and float(weights.sum()) > 0, "bad accumulated weights")
        print(f"accumulated weights ({backend}): {weights.shape[0]} leaves, sum "
              f"{float(weights.sum()):.6g}, {int((weights > 0).sum())} leaves with weight")

    # 4c. Main path, aux serving: per frame, render_persp and then
    # opacity_render, render_depth and motion_render (with the CUDA
    # reference's hit point, compat_hit_point: on the bake one K6 lookup at
    # the hit points) on the same camera rays, on both backends.
    cam_rays = stt.Rays(origins, dirs, dirs)
    aux_serve_counts, aux_outs = {}, {}
    aux_frame_ms, aux_step_ms = {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        aux_tree = stt.tree_from_numpy(aux_state, device=dev)
        aux_renderer = stt.VolumeRenderer(aux_tree, backend=backend)
        aux_renderer.compat_hit_point = 1
        if backend == "baked":
            aux_tree._baked_spec()
        reset_counts()
        aux_frames, aux_frame_s = [], []
        with torch.no_grad():
            for i in range(N_FRAMES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aux_tree.construct_tree(frame_points[i])
                img = aux_renderer.render_persp(frame_feats[i], c2w, WIDTH, HEIGHT, fx=FX)
                alpha = aux_renderer.opacity_render(frame_feats[i], cam_rays)
                depth = aux_renderer.render_depth(frame_feats[i], cam_rays)
                motion = aux_renderer.motion_render(frame_feats[i], cam_rays)
                torch.cuda.synchronize()
                aux_frame_s.append(time.perf_counter() - t0)
                aux_frames.append((img, alpha, depth, motion))
        counts = aux_serve_counts[backend] = read_counts()
        aux_frame_ms[backend] = [round(x * 1e3, 3) for x in aux_frame_s]
        print(f"main path, aux serving ({LABEL[backend]}): {N_FRAMES} frames, launches "
              f"{nonzero(counts)}, host ms per frame (construct + render + opacity + depth + motion) "
              f"{[round(x * 1e3, 3) for x in aux_frame_s]}")
        check(counts["repoint"] == N_FRAMES, "construct_tree not launched per frame")
        check(counts["render_fwd" + sfx] == 2 * N_FRAMES, "render_fwd not launched by render + opacity")
        check(counts["first_hit" + sfx] == 2 * N_FRAMES, "first_hit not launched by depth + motion")
        check_bake_counts(counts, backend, N_FRAMES)
        if backend == "baked":
            check(counts["bake_lookup"] == N_FRAMES, "the hit points' lookup not launched per frame")
        with torch.no_grad():
            for img, alpha, depth, (motion, depth_m, hit_pt, didx) in aux_frames:
                check(torch.equal(alpha[:, 0], img.reshape(B, -1)[:, -1]), "opacity is not the image's alpha")
                check(torch.equal(depth, depth_m), "render_depth and motion_render disagree")
                found = depth[:, 0] > 0
                check(bool(found.any()) and bool((~found).any()), "no hit or no miss ray")
                check(not bool((found & (alpha[:, 0] == 0)).any()), "a hit ray with alpha 0")
                check(tuple(motion.shape) == (B, N_JOINTS) and bool(torch.isfinite(motion).all()),
                      "bad motion features")
                check(not bool(motion[~found].any()) and not bool(hit_pt[~found].any()), "a miss with a hit")
                check(bool((didx[found] < M).all()), "data_idx outside the pool")
            ref = aux_ops.first_hit_plain(aux_renderer._render_spec(), frame_feats[-1], origins[sample],
                                          dirs[sample], aux_renderer._get_options(False))
            ref_depth = torch.where(ref[0], ref[1] * ds[sample], 0.0)
            check(torch.equal(aux_frames[-1][2][sample, 0], ref_depth),
                  "served depth disagrees with the plain version")
            print(f"aux frames ({backend}): hit share {float((aux_frames[-1][2] > 0).float().mean()):.4f}; "
                  f"last frame depth equal to plain on {sample.numel()} pixels")
        aux_outs[backend] = aux_frames
    for fb, ft in zip(aux_outs["baked"], aux_outs["tree"]):
        check(all(torch.equal(a, b_) for a, b_ in zip(fb[:3] + tuple(fb[3]), ft[:3] + tuple(ft[3]))),
              "the backends' aux outputs differ")
    print("aux serving: the backends' images, opacity, depths and motion outputs (compat hit points) "
          "equal bit for bit")

    # 4d. Main path, aux training: Adam steps over the pool and the joint
    # features (image MSE + opacity mask loss + motion-feature MSE).
    jf_init = torch.from_numpy(rng.randn(N_JOINTS, JOINT_DIM).astype(np.float32)).to(dev)
    aux_train_counts = {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        steps = N_STEPS if backend == "baked" else N_TREE_STEPS
        aux_train_tree = stt.tree_from_numpy(aux_state, device=dev)
        reset_counts()
        a_pool, a_jf, a_losses, a_step_ms = train_aux(
            aux_train_tree, true_pool, pool0, jf_true, jf_init, sw, ji, centers, perms, cam_rays,
            steps, backend=backend)
        counts = aux_train_counts[backend] = read_counts()
        aux_step_ms[backend] = [round(x, 3) for x in a_step_ms]
        print(f"main path, aux training ({LABEL[backend]}): {steps} steps, launches {nonzero(counts)}, "
              f"loss {[round(x, 8) for x in a_losses]}, host ms per step "
              f"{[round(x, 3) for x in a_step_ms]}")
        want = {"repoint": steps + 1, "render_fwd" + sfx: 2 * (steps + 1),
                "render_bwd" + sfx: steps, "opacity_bwd" + sfx: steps, "mf_fwd" + sfx: steps + 1,
                "mf_bwd" + sfx: steps}
        for k, n in want.items():
            check(counts[k] == n, f"aux training: {k} launched {counts[k]} times, not {n}")
        check_mf_widths(counts, f"aux training ({backend})")
        check_bake_counts(counts, backend, steps + 1)
        check(a_losses[-1] < a_losses[0], "the aux loss did not fall")
        for name, x in (("pool", a_pool), ("joint features", a_jf)):
            check(x.grad is not None and bool(torch.isfinite(x.grad).all())
                  and float(x.grad.abs().max()) > 0, f"bad {name} gradient")

    # 4e. Main path, dynamic serving: render_dynamic_frames over the pose
    # sequence (warp, re-point with the table carried, on the bake refresh
    # with the carried box union, render with the blended matrices as
    # rotations, first-hit depth), fast with the tree left untouched, then
    # exact leaving it at the last frame, on both backends; then one
    # voxelize of each frame's warped cloud.
    dyn_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, viewdir_rotation=True,
                  with_depth=True)
    # The port's own keys keep their tree-walk meaning; the bake's are new.
    dyn_keys = {("tree", True): "dynamic_deep9_fast_frame_ms", ("tree", False): "dynamic_deep9_frame_ms",
                ("baked", True): "dynamic_deep9_baked_fast_frame_ms",
                ("baked", False): "dynamic_deep9_baked_frame_ms"}
    dyn_counts, dyn_ms, dyn_first = [], {}, {}
    rays_s = stt.Rays(origins[sample], dirs[sample], dirs[sample])
    with torch.no_grad():
        for backend in BACKENDS:
            sfx = SUFFIX[backend]
            dyn_tree = stt.tree_from_numpy(state, device=dev)
            dyn_r = stt.VolumeRenderer(dyn_tree, backend=backend)
            table0 = dyn_tree._spec().data_flat.clone()

            def dyn_call(fast):
                return dyn_r.render_dynamic_frames(feats, poses, src, centers, rig_sw, rig_ji,
                                                   fast=fast, update_tree=not fast, **dyn_kw)

            dyn_out = {}
            for fast in (True, False):
                reset_counts()
                cols, deps = dyn_call(fast)
                torch.cuda.synchronize()
                counts = read_counts()
                dyn_counts.append(counts)
                print(f"main path, dynamic serving ({LABEL[backend]}, {'fast' if fast else 'exact'}): "
                      f"{N_FRAMES} frames, launches {nonzero(counts)}")
                for k in ("warp_fwd", "repoint", "render_fwd" + sfx, "first_hit" + sfx):
                    check(counts[k] == N_FRAMES, f"dynamic serving: {k} launched {counts[k]} times")
                check_march_widths(counts, f"dynamic serving ({backend})")
                if backend == "baked":  # the exact call adopts its last table: one more refresh
                    check(counts["construct_tree_aabb"] == N_FRAMES and counts["points_aabb"] == 0
                          and counts["bake_refresh"] == N_FRAMES + (0 if fast else 1),
                          "dynamic serving: the bake not refreshed per frame")
                check(tuple(cols.shape) == (N_FRAMES, HEIGHT, WIDTH, 4)
                      and tuple(deps.shape) == (N_FRAMES, HEIGHT, WIDTH, 1), "dynamic output shapes")
                check(bool(torch.isfinite(cols).all() and torch.isfinite(deps).all()), "non-finite frame")
                a = cols[..., 3]
                check(bool((a >= 0).all() and (a <= 1).all() and (a > 0).any() and (a == 0).any()),
                      "dynamic frames: alpha outside [0, 1], or no hit or no miss")
                check(bool(((deps[..., 0] > 0) <= (a > 0)).all()), "a depth where alpha is 0")
                if fast:
                    check(torch.equal(dyn_tree._spec().data_flat, table0),
                          "update_tree=False moved the table")
                dyn_out[fast] = (cols, deps)
            carried = dyn_tree._spec().data_flat.clone()
            dyn_first[backend] = dyn_out[False]
            # Frame times: the calls above warmed both modes up; then three
            # rounds of exact and fast in turn, the least of each per frame.
            dyn_dts = {True: [], False: []}
            for _ in range(3):
                for fast in (False, True):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dyn_call(fast)
                    torch.cuda.synchronize()
                    dyn_dts[fast].append((time.perf_counter() - t0) * 1e3 / N_FRAMES)
            for fast, dts in dyn_dts.items():
                dyn_ms[dyn_keys[(backend, fast)]] = min(dts)
            print(f"main path, dynamic serving ({backend}): host ms per frame (least of 3 calls) "
                  + ", ".join(f"{dyn_keys[(backend, f)]} {min(d):.4f}" for f, d in dyn_dts.items())
                  + f"; all calls {({dyn_keys[(backend, f)]: [round(x, 4) for x in d] for f, d in dyn_dts.items()})}")

            # The fused loop against the eager loop of the public calls:
            # warp_vertices -> construct_tree -> forward with the mats.
            eager_tree = stt.tree_from_numpy(state, device=dev)
            eager_r = stt.VolumeRenderer(eager_tree, backend=backend)
            if backend == "baked":
                eager_tree._baked_spec()
            tables = []
            for k in range(N_FRAMES):
                tk = stt.get_transformation_matrix(src, poses[k])
                warped, mats = stt.warp_vertices(tk, centers, rig_sw, rig_ji)
                eager_tree.construct_tree(warped)
                tables.append(eager_tree._spec().data_flat.clone())
            check(torch.equal(tables[-1], carried), "carried table differs from eager")
            check(all(not torch.equal(tables[i - 1], tables[i]) for i in range(1, N_FRAMES)),
                  "the index table did not change per frame")
            ref = eager_r(feats, rays_s, transformation_matrices=mats)
            err = float((dyn_out[False][0][-1].reshape(B, 4)[sample] - ref).abs().max())
            check(err <= RENDER_ATOL, f"dynamic frame vs the eager loop: {err}")
            ref_d = eager_r.render_depth(feats, rays_s)
            check(torch.equal(dyn_out[False][1][-1].reshape(B, 1)[sample], ref_d), "dynamic depth differs")
            print(f"dynamic last frame ({backend}) vs the eager loop on {sample.numel()} pixels: "
                  f"max_abs_err {err:.3g}, depths equal, tables equal; hit share "
                  f"{float((dyn_out[False][0][-1][..., 3] > 0).float().mean()):.4f}")
        check(torch.equal(dyn_first["baked"][0], dyn_first["tree"][0])
              and torch.equal(dyn_first["baked"][1], dyn_first["tree"][1]),
              "the backends' exact dynamic frames differ")
        print("dynamic serving: the backends' exact frames and depths equal bit for bit")

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vols = []
        for k in range(N_FRAMES):
            tk = stt.get_transformation_matrix(src, poses[k])
            warped, _ = stt.warp_vertices(tk, centers, rig_sw, rig_ji)
            vols.append(stt.voxelize(warped, feats, 0.0, 1.0, P2V_N, P2V_KR, P2V_CR))
        torch.cuda.synchronize()
        p2v_frame_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        vox_counts = read_counts()
        check(vox_counts["voxelize_fwd"] == N_FRAMES, "voxelize not launched per frame")
        mass = [float(v.sum()) for v in vols]
        check(all(np.isfinite(mass)) and min(mass) > 0, f"bad voxel grids {mass}")
        print(f"main path, p2v: warp + voxelize of {N_FRAMES} frames, launches {nonzero(vox_counts)}, "
              f"host ms per frame {p2v_frame_ms:.4f}, grid mass {[round(m, 2) for m in mass]}")

    # 4f. Main path, dynamic training: Adam steps on a per-frame pool stack
    # through render_dynamic_frames, toward frames the true stack renders.
    true_stack = torch.stack([seeded_pool(drng, M, 28, dev) for _ in range(DYN_TRAIN_FRAMES)])
    stack0 = torch.stack([seeded_pool(drng, M, 28, dev) for _ in range(DYN_TRAIN_FRAMES)])
    tr_args = (poses[:DYN_TRAIN_FRAMES], src, centers, rig_sw, rig_ji)
    tr_kw = dict(c2w=c2w, width=WIDTH, height=HEIGHT, fx=FX, update_tree=False)
    dyn_train_counts, dyn_step_ms = {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        steps = DYN_STEPS if backend == "baked" else N_TREE_STEPS
        tr_r = stt.VolumeRenderer(stt.tree_from_numpy(state, device=dev), backend=backend)
        with torch.no_grad():
            targets = tr_r.render_dynamic_frames(true_stack, *tr_args, **tr_kw)
        stack = stack0.clone().requires_grad_()
        adam = torch.optim.Adam([stack], lr=LR)
        dyn_losses, dyn_step_ms[backend] = [], []
        reset_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adam.zero_grad(set_to_none=True)
            loss = ((tr_r.render_dynamic_frames(stack, *tr_args, **tr_kw) - targets) ** 2).mean()
            loss.backward()
            adam.step()
            torch.cuda.synchronize()
            dyn_step_ms[backend].append((time.perf_counter() - t0) * 1e3)
            dyn_losses.append(loss.item())
        counts = dyn_train_counts[backend] = read_counts()
        print(f"main path, dynamic training ({LABEL[backend]}): {steps} steps of {DYN_TRAIN_FRAMES} "
              f"frames, launches {nonzero(counts)}, loss {[round(x, 8) for x in dyn_losses]}, host ms "
              f"per step {[round(x, 3) for x in dyn_step_ms[backend]]}")
        n_fr = steps * DYN_TRAIN_FRAMES
        for k in ("warp_fwd", "repoint", "render_fwd" + sfx, "render_bwd" + sfx):
            check(counts[k] == n_fr, f"dynamic training: {k} launched {counts[k]} times")
        check_bake_counts(counts, backend, n_fr)
        check(dyn_losses[-1] < dyn_losses[0], "the dynamic training loss did not fall")
        check(bool(torch.isfinite(stack.grad).all()) and float(stack.grad.abs().max()) > 0,
              "bad pool-stack gradient")

    # 4g. Main path, pose fit: Adam steps on the joints' transforms toward
    # the grid the true pose splats, through warp_vertices and voxelize
    # (their backward kernels).
    with torch.no_grad():
        t_true = stt.get_transformation_matrix(src, poses[1])
        target_vol = stt.voxelize(stt.warp_vertices(t_true, centers, rig_sw, rig_ji)[0], feats,
                                  0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
    t_fit = src.clone().requires_grad_()
    adam = torch.optim.Adam([t_fit], lr=POSE_LR)
    pose_losses, pose_step_ms, pose_grads = [], [], []
    reset_counts()
    for _ in range(DYN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        warped, _ = stt.warp_vertices(t_fit, centers, rig_sw, rig_ji)
        vol = stt.voxelize(warped, feats, 0.0, 1.0, P2V_N, P2V_KR, P2V_CR)
        loss = ((vol - target_vol) ** 2).mean()
        loss.backward()
        pose_grads.append(t_fit.grad.clone())
        adam.step()
        torch.cuda.synchronize()
        pose_step_ms.append((time.perf_counter() - t0) * 1e3)
        pose_losses.append(loss.item())
    pose_counts = read_counts()
    print(f"main path, pose fit: {DYN_STEPS} steps, launches {pose_counts}, loss "
          f"{[round(x, 6) for x in pose_losses]}, max|dT| "
          f"{[float(f'{float(g.abs().max()):.4g}') for g in pose_grads]}, host ms per step "
          f"{[round(x, 3) for x in pose_step_ms]}")
    for k in ("warp_fwd", "warp_bwd", "voxelize_fwd", "voxelize_bwd"):
        check(pose_counts[k] == DYN_STEPS, f"pose fit: {k} launched {pose_counts[k]} times")
    for g in pose_grads:
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 and not bool(g[:, 3].any()),
              "bad transform gradient")
    check(pose_losses[-1] < pose_losses[0], "the pose-fit loss did not fall")

    # 4h. bench.py's dynamic configuration (bench.py:676-732), with this
    # package's N3Tree: per frame warp, re-point and an 800x800 RGBA
    # render; min over three calls of four frames, per frame. bench.py
    # renders through the JAX package's default backend, the bake: its
    # keys time the default baked backend here too, and the tree walk's
    # times get keys of their own.
    bench_keys = {("baked", False): "dynamic_fused_frame_ms", ("baked", True): "dynamic_fast_frame_ms",
                  ("tree", False): "dynamic_fused_frame_tree_ms",
                  ("tree", True): "dynamic_fast_frame_tree_ms"}
    bench_ms, bench_counts = {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        bench_r = stt.VolumeRenderer(bench_tree_on_card(), backend=backend)

        def bench_run(i, fast):
            outs = bench_r.render_dynamic_frames(bench_feats * (1.0 + 1e-3 * i), *bench_args, c2w=c2w,
                                                 width=WIDTH, height=HEIGHT, fx=BENCH_FX,
                                                 update_tree=False, fast=fast)
            return float(outs.sum())

        reset_counts()
        with torch.no_grad():
            for fast in (False, True):
                total = bench_run(0, fast)
                check(np.isfinite(total), "bench dynamic frames: non-finite")
                dts = []
                for i in range(3):
                    t0 = time.perf_counter()
                    bench_run(i + 1, fast)
                    dts.append(time.perf_counter() - t0)
                bench_ms[bench_keys[(backend, fast)]] = min(dts) * 1e3 / n_bench
        counts = bench_counts[backend] = read_counts()
        check(counts["warp_fwd"] == 8 * n_bench and counts["render_fwd" + sfx] == 8 * n_bench,
              "bench dynamic: kernels not launched per frame")
        check_bake_counts(counts, backend, 8 * n_bench)
        if backend == "baked":
            check(counts["grow_boxes"] == 4 * n_bench, "bench dynamic: skip boxes not regrown per fast frame")
        print(f"main path, bench.py dynamic ({LABEL[backend]}; {bd['points'].shape[0]} points, depth 5 "
              f"RGBA, {n_bench} frames, fx {BENCH_FX}): launches {nonzero(counts)}, "
              + ", ".join(f"{bench_keys[(backend, f)]} {bench_ms[bench_keys[(backend, f)]]:.4f}"
                          for f in (False, True)))

    # 4i. Main path, tree editing (the prune/refine half of training) on
    # the depth-9 SH9 shell: corners, set, the unique-leaf query, merge +
    # shrink_to_fit and refine, each edit re-baked and rendered exact on
    # both backends (`edit_path`); the kernels equal their plain versions.
    edit_tree = stt.tree_from_numpy(state, device=dev)
    reset_counts()
    edit = edit_path(edit_tree, feats.clone(), np.random.RandomState(6))
    edit_counts = read_counts()
    print(f"main path, tree editing ({edit_tree.N}^3 tree, {M} rows): launches {nonzero(edit_counts)}; "
          f"calc_corners, assign and unique_leaf_nodes equal to plain; {edit['occupied']} of "
          f"{len(edit['calc_corners_args'][1])} leaves occupied; merged "
          f"{edit['merged']} of {edit['frontier']} frontier nodes ({edit['idle_frontier']} took no weight), "
          f"refined {edit['refined']} leaves -> {edit['leaves_after']}; hit share "
          f"{edit['hits after merge + shrink_to_fit']:.4f} / {edit['hits after refine']:.4f}; baked and "
          f"tree exact frames equal bit for bit after each edit; host ms "
          f"{ {k: round(v, 3) for k, v in edit['ms'].items()} }")
    for k in ("calc_corners", "assign", "unique_leaf"):
        check(edit_counts[k] > 0, f"tree editing: {k} not launched")
        kernels[k]["max_abs_err"] = 0.0
    check(edit_counts["render_fwd_baked"] >= 4 and edit_counts["render_fwd"] >= 2,
          "tree editing: the renders did not run on both backends")
    check(edit_counts["query_fwd"] > 0, "tree editing: query_fwd not launched")
    check_query_units(edit_counts, "tree editing")

    # 4j. Main path, trilinear interpolation (K4) through
    # VolumeRenderer(interp="trilinear") on both backends, on the aux scene
    # re-pointed at frame 1's cloud: an exact and a fast frame; one training
    # step (image MSE, opacity mask loss and motion-feature MSE over the
    # pool and the joint features) with backward() inside
    # accumulate_weights(); render_depth and motion_render (the reference's
    # hit point). Only interp instances of the march kernels may launch.
    interp_counts, interp_frames, interp_frame_ms = {}, {}, {}
    i_target = serve_images["baked"][0][0]
    for backend in BACKENDS:
        isfx = SUFFIX[backend] + "_interp"
        i_tree = stt.tree_from_numpy(aux_state, device=dev)
        i_r = stt.VolumeRenderer(i_tree, backend=backend, interp="trilinear")
        i_r.compat_hit_point = 1
        if backend == "baked":
            i_tree._baked_spec()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            i_tree.construct_tree(frame_points[0])
            img_e = i_r.render_persp(frame_feats[0], c2w, WIDTH, HEIGHT, fx=FX)
            img_f = i_r.render_persp(frame_feats[0], c2w, WIDTH, HEIGHT, fx=FX, fast=True)
            t_alpha = i_r.opacity_render(true_pool, cam_rays)
            t_mf = i_r.motion_feature_render(true_pool, jf_true, sw, ji, cam_rays)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        i_pool = pool0.clone().requires_grad_()
        i_jf = jf_init.clone().requires_grad_()
        t0 = time.perf_counter()
        with i_tree.accumulate_weights() as i_acc:
            img = i_r.render_persp(i_pool, c2w, WIDTH, HEIGHT, fx=FX)
            alpha = i_r.opacity_render(i_pool, cam_rays)
            mf = i_r.motion_feature_render(i_pool, i_jf, sw, ji, cam_rays)
            loss = (((img - i_target) ** 2).mean() + MASK_WEIGHT * ((alpha - t_alpha) ** 2).mean()
                    + ((mf - t_mf) ** 2).mean())
            loss.backward()
        torch.cuda.synchronize()
        step_ms_i = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            depth = i_r.render_depth(frame_feats[0], cam_rays)
            motion = i_r.motion_render(frame_feats[0], cam_rays)
        torch.cuda.synchronize()
        counts = interp_counts[backend] = read_counts()
        check_march_widths(counts, f"interp path ({backend})")
        check_march_bwd_widths(counts, f"interp path ({backend})")
        check_mf_widths(counts, f"interp path ({backend})")
        w = i_acc()
        print(f"main path, interp ({LABEL[backend]}): launches {nonzero(counts)}; host ms: construct + exact "
              f"+ fast frames + opacity and motion-feature targets {frame_ms:.3f}, training step "
              f"{step_ms_i:.3f}; loss {float(loss):.8g}")
        for name in MARCH_KERNELS:
            check(counts[name + isfx] > 0, f"interp: {name + isfx} not launched")
            check(all(counts[name + s] == 0 for s in ("", "_baked")),
                  f"interp: a nearest-mode {name} instance launched")
        check_bake_counts(counts, backend, 1)
        for im in (img_e, img_f):
            a = im[..., 3]
            check(tuple(im.shape) == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(im).all())
                  and bool((a >= 0).all() and (a <= 1).all() and (a > 0).any() and (a == 0).any()),
                  f"interp ({backend}): bad frame")
        for name, x in (("pool", i_pool), ("joint features", i_jf)):
            check(x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0,
                  f"interp ({backend}): bad {name} gradient")
        check(bool(torch.isfinite(w).all()) and float(w.sum()) > 0, f"interp ({backend}): no weights")
        found = depth[:, 0] > 0
        check(bool(found.any()) and torch.equal(depth, motion[1]) and bool((motion[3][found] < M).all()),
              f"interp ({backend}): bad depth or hit rows")
        ref = render_ops.volume_render_plain(i_r._render_spec(), frame_feats[0], origins[sample[::8]],
                                             dirs[sample[::8]], dirs[sample[::8]], i_r._get_options(False))
        err = float((img_e.reshape(B, 4)[sample[::8]] - ref).abs().max())
        check(err <= RENDER_ATOL, f"interp ({backend}): served frame vs plain {err}")
        # The interp frame on the host clock: least of 3 warm exact frames.
        dts = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                i_r.render_persp(frame_feats[0], c2w, WIDTH, HEIGHT, fx=FX)
                torch.cuda.synchronize()
                dts.append((time.perf_counter() - t0) * 1e3)
        interp_frame_ms[backend] = min(dts)
        print(f"interp frames ({backend}): hit share {float((img_e[..., 3] > 0).float().mean()):.4f}, exact "
              f"frame vs plain on {sample[::8].numel()} pixels max_abs_err {err:.3g}; weights sum "
              f"{float(w.sum()):.6g} on {int((w > 0).sum())} leaves; {int(found.sum())} depth hits; "
              f"exact render_persp host ms (least of 3) {interp_frame_ms[backend]:.4f}")
        interp_frames[backend] = (img_e, depth, motion)
    check(all(torch.equal(a, b_) for a, b_ in zip(interp_frames["baked"][:2] + tuple(interp_frames["baked"][2]),
                                                  interp_frames["tree"][:2] + tuple(interp_frames["tree"][2]))),
          "interp: the backends' exact frames, depths or motion outputs differ")
    print("interp: the backends' exact frames, depths and motion outputs equal bit for bit")

    # 4k. Main path, bf16 and int8 pools (K5) on both backends
    # (`pool_path`): bench.py's deep serving and its int8 form, a bf16
    # forward + backward, a bf16 training step, the aux passes on the int8
    # pool, a bf16 dynamic call, and the same under interp.
    pool_counts, pool_ms = {}, {}
    rig = (poses, src, centers, rig_sw, rig_ji)
    for backend in BACKENDS:
        res = pool_path(backend, aux_state, feats, jf_true, sw, ji, rig, cam_rays, c2w, dev)
        counts = pool_counts[backend] = res["counts"]
        want = [k for k in POOL_KERNELS if ("_baked" in k) == (backend == "baked")]
        missing = [k for k in want + ["query_fwd_bf16", "query_bwd_bf16"] if counts[k] == 0]
        check(not missing, f"pool path ({backend}): not launched: {missing}")
        check_query_units(counts, f"pool path ({backend})")
        check_march_widths(counts, f"pool path ({backend})")
        check_march_bwd_widths(counts, f"pool path ({backend})")
        check_mf_widths(counts, f"pool path ({backend})")
        if backend == "tree":
            check_bake_counts(counts, backend, 0)
        pool_ms[backend] = res["ms"]
        ms = res["ms"]
        print(f"main path, bf16/int8 pools ({LABEL[backend]}): launches {nonzero(counts)}; rays in pixel "
              f"order: deep9_noplan_ms {ms['deep9_noplan_ms']:.4f} ({B / ms['deep9_noplan_ms'] / 1e3:.3f} "
              f"Mrays/s), deep9_int8_noplan_ms {ms['deep9_int8_noplan_ms']:.4f} "
              f"({B / ms['deep9_int8_noplan_ms'] / 1e3:.3f} Mrays/s); deep9_int8_max_err "
              f"{res['deep9_int8_max_err']:.5g} ({INT8_ERR_RAYS} rays), fwd_bwd_bf16_ms "
              f"{ms['fwd_bwd_bf16_ms']:.4f}, bf16 render_dynamic_frames call ({N_FRAMES} frames) "
              f"{ms['dynamic_bf16_call_ms']:.3f} ms; host clock, synchronized (bench.py's deep9_ms marches "
              f"cost-ordered rays: phase 4p) [{card}]")

    # 4l. Main path, recorded sample tapes (K13) on both backends
    # (`tape_path`): three frames of render_persp_tape with the frames'
    # pools, exact and fast, bit for bit equal to render_persp; two Adam
    # steps through render_persp_tape + backward(), one inside
    # accumulate_weights(); then bench.py's tape keys beside the march.
    tape_counts, tape_ms = {}, {}
    for backend in BACKENDS:
        sfx = SUFFIX[backend]
        reruns = tape_ops.ARENA_RERUNS["reruns"]
        res = tape_path(backend, state, frame_feats, true_pool, pool0, c2w, dev)
        reruns = tape_ops.ARENA_RERUNS["reruns"] - reruns
        counts = tape_counts[backend] = res["counts"]
        print(f"main path, tapes ({LABEL[backend]}): launches {nonzero(counts)}, loss "
              f"{[round(x, 8) for x in res['losses']]}, host ms per frame (exact + fast replays; the first "
              f"records both tapes) {[round(x, 3) for x in res['frame_ms']]}; frames equal to render_persp "
              f"bit for bit")
        want = {"tape_stage" + sfx: 2 + reruns, "tape_copy" + sfx: 2, "tape_replay_fwd": 2 * N_FRAMES + 3,
                "tape_replay_bwd": 2, "tape_replay_fwd_bf16": 2, "tape_replay_fwd_i8": 1,
                "tape_replay_bwd_bf16": 1, "render_fwd" + sfx: 0, "render_bwd" + sfx: 0}
        for k, n in want.items():
            check(counts[k] == n, f"tape path ({backend}): {k} launched {counts[k]} times, not {n}")
        check_bwd_widths(counts, f"tape path ({backend})")
        check_fwd_widths(counts, f"tape path ({backend})")
        check_bake_counts(counts, backend, 0)
        reset_counts()
        tape_ms[backend] = tape_times(backend, {7: bench7, DEPTH: (state, feats_np)}, dev, card)
        check_march_widths(read_counts(), f"tape path's march keys ({backend})")

    # 4m. Main path, the temporal tape path (K13e, K13f) on both backends
    # (`dynamic_tape_path`): the deep dynamic scene's data-indirect tape,
    # recorded once against the animation's union occupancy; its frames
    # exact, fast and uncompacted with rotations and depth, held to
    # render_dynamic_frames; a two-frame stack's gradient through
    # render_tape_frames; a 3-view rig frame. Then bench.py's temporal tape
    # keys on the default bake, beside the march's.
    t_4m = time.perf_counter()
    dyn_tape_counts, dyn_tape_ms, dyn_tape_exact = {}, {}, {}
    for backend in BACKENDS:
        res = dynamic_tape_path(backend, state, feats, rig, c2w, dev)
        dyn_tape_counts[backend], dyn_tape_ms[backend] = res["counts"], res["ms"]
        dyn_tape_exact[backend] = res["exact"]
        if backend == "baked":
            depth_case = res["depth_case"]
    check(all(torch.equal(a, b_) for a, b_ in zip(dyn_tape_exact["baked"], dyn_tape_exact["tree"])),
          "the backends' exact dynamic tape frames differ")
    del dyn_tape_exact
    dyn_tape_keys = dynamic_tape_times(bench_tree_on_card, bd, state, bench7, c2w, dev, card)
    print(f"temporal tapes beside the march (default bake): dynamic_tape_frame_ms "
          f"{dyn_tape_keys['dynamic_tape_frame_ms']:.4f} vs dynamic_fused_frame_ms "
          f"{bench_ms['dynamic_fused_frame_ms']:.4f}, dynamic_tape_fast_frame_ms "
          f"{dyn_tape_keys['dynamic_tape_fast_frame_ms']:.4f} vs dynamic_fast_frame_ms "
          f"{bench_ms['dynamic_fast_frame_ms']:.4f}; tape_fwd_bwd_ms {dyn_tape_keys['tape_fwd_bwd_ms']:.4f} vs "
          f"tape_fwd_bwd_seq_ms {tape_ms['baked']['tape_fwd_bwd_seq_ms']:.4f}; deep dynamic frame (rotations, "
          f"depth) through the tape {dyn_tape_ms['baked']['explicit_frame_ms']:.4f} (cache key "
          f"{dyn_tape_ms['baked']['cached_frame_ms']:.4f}; the key's call {dyn_tape_ms['baked']['key_ms']:.4f}) vs dynamic_deep9_baked_frame_ms "
          f"{dyn_ms['dynamic_deep9_baked_frame_ms']:.4f}; phase 4m {time.perf_counter() - t_4m:.1f} s [{card}]")

    # 4n. Main path, minibatch tape training (K14) on bench.py's minibatch
    # cell (`minibatch_path`): its keys, the march's random-batch step
    # beside them, train_minibatches held to the eager chain of public calls.
    t_4n = time.perf_counter()
    mb_res = minibatch_path(mb, dev, card)
    mb_counts = mb_res["counts"]
    steps = 4 * N_MB + 4 * N_MB2
    want = {"subset_gather": steps, "l2_cotangent": steps + 4 * N_CHAIN, "sgd_update": steps + 4 * N_CHAIN,
            "tape_replay_bwd": steps + 4 * N_CHAIN, "render_fwd_baked": 0, "render_bwd_baked": 0}
    for k, n in want.items():
        check(mb_counts[k] == n, f"minibatch path: {k} launched {mb_counts[k]} times, not {n}")
    check_bwd_widths(mb_counts, "minibatch path")
    check_fwd_widths(mb_counts, "minibatch path")
    ms = mb_res["ms"]
    print(f"main path, minibatch tape training: launches {nonzero(mb_counts)}; rig record "
          f"{mb['record_s'] * 1e3:.1f} ms ({mb['rig'].n_rays} rays, {mb['rig'].n_samples} samples) [{card}]")
    print(f"bench.py minibatch keys (default bake; host clock, least of 3 calls, next pack's prep overlapped): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items() if k != "march_minibatch_step_ms")
          + f"; beside them one random-batch SGD step through the march (forward + backward + SGD, {B_MB} "
          f"rays) {ms['march_minibatch_step_ms']:.4f} ms; phase 4n {time.perf_counter() - t_4n:.1f} s [{card}]")
    # 4o. Main path, the dense-grid weight pass (K12) at full width.
    grid_res = grid_path(gscene)
    check(grid_res["counts"]["grid_weight"] == 1 and grid_res["counts"]["grid_occupancy"] == 1,
          "grid path: grid_occupancy and grid_weight did not launch once each")
    del mb, gscene

    # 4p. Main path, cost-ordered ray schedules (K15) on both backends
    # (`plan_path`): planned frames, a planned training step and the union
    # plan of the dynamic loop, each equal to the tile order; then bench.py's
    # planning keys on the default bake (`plan_times`).
    t_4p = time.perf_counter()
    plan_counts = {}
    for backend in BACKENDS:
        plan_counts[backend] = plan_path(backend, state, frame_feats, true_pool, pool0, feats, rig, c2w,
                                         dev)["counts"]
    plan_times(bench7, (state, feats_np), dev, card)
    del bench7
    print(f"phase 4p {time.perf_counter() - t_4p:.1f} s")

    phases = (*serve_counts.values(), *train_counts.values(), *aux_serve_counts.values(),
              *aux_train_counts.values(), *dyn_counts, vox_counts, *dyn_train_counts.values(),
              pose_counts, *bench_counts.values(), edit_counts, *interp_counts.values(),
              *pool_counts.values(), *tape_counts.values(), *dyn_tape_counts.values(), mb_counts,
              grid_res["counts"], *plan_counts.values())
    for k in kernels:
        kernels[k]["launches"] = sum(c[k] for c in phases)
        if k in OFF_PATH:
            check(kernels[k]["launches"] == 0, f"{k} launched on the main path: {OFF_PATH[k]}")
        else:
            check(kernels[k]["launches"] > 0, f"{k} not launched on the main path")
    print(f"main path: the tape walks' arenas ran short {tape_ops.ARENA_RERUNS['reruns'] - arena_reruns} times "
          f"(ARENA_RERUNS; each a rerun of tape_stage)")

    # 5. Times (CUDA events, after one warm-up), on the serving trees as
    # the last frame left them: the tree walk's kernels on the tree's
    # spec, the baked instances on the other tree's bake.
    spec_t = serve_trees["tree"]._spec()
    spec_bt = serve_trees["baked"]._baked_spec()
    renderer = stt.VolumeRenderer(serve_trees["tree"], backend="tree")
    pts = frame_points[0]
    f0 = frame_feats[0]
    with torch.no_grad():
        ct_ms = time_ms(lambda: query_ops.construct_tree_cuda(spec_t, pts), KERNEL_REPS)
        ct_plain_ms = time_ms(lambda: query_ops.construct_tree_plain(spec_t, pts), 3)
        # The device's time of a call alone (its scatter and merge, L2
        # flushed before each call): back-to-back calls through the wrapper
        # leave the card idle while the host prepares the next one, which
        # the CUDA events above count.
        ct_dev = {cold: device_ms(lambda: query_ops.construct_tree_cuda(spec_t, pts), KERNEL_REPS,
                                  ("scatter_kernel", "merge_kernel"), cold=cold) for cold in (True, False)}
        kernels["construct_tree"].update(ms=ct_ms, plain_ms=ct_plain_ms, device_ms=ct_dev[True])
        print(f"time construct_tree ({M} points): kernel {ct_ms:.4f} ms a call (CUDA events over {KERNEL_REPS} "
              f"back-to-back wrapper calls), device {ct_dev[True]:.4f} ms (its kernels alone, L2 cold; warm "
              f"{ct_dev[False]:.4f}), plain {ct_plain_ms:.4f} ms [{card}]")
        # The fused re-point against the two calls it replaces, in turns,
        # with the bake's box as the union (prev_ms: the two calls).
        t_fused = time.perf_counter()
        union = (spec_bt.aabb_lo, spec_bt.aabb_hi)

        def fused_call():
            return query_ops.construct_tree_aabb_cuda(spec_t, pts, union=union)

        def two_calls():
            return (query_ops.construct_tree_cuda(spec_t, pts),
                    query_ops.points_leaf_aabb_cuda(spec_t, pts, union=union))

        ctb_ms, two_ms = in_turns(fused_call, two_calls, lambda fn: time_ms(fn, KERNEL_REPS))
        ctb_plain_ms = time_ms(lambda: query_ops.construct_tree_aabb_plain(spec_t, pts, union), 3)
        ctb_dev = {cold: device_ms(fused_call, KERNEL_REPS, ("scatter_box_kernel", "merge_box_kernel"), cold=cold)
                   for cold in (True, False)}
        two_dev = {cold: device_ms(two_calls, KERNEL_REPS, ("scatter_kernel", "merge_kernel", "points_aabb"),
                                   cold=cold) for cold in (True, False)}
        kernels["construct_tree_aabb"].update(ms=ctb_ms, plain_ms=ctb_plain_ms, device_ms=ctb_dev[True],
                                              prev_ms=two_ms)
        print(f"time construct_tree_aabb ({M} points, a union): kernel {ctb_ms:.4f} ms a call (CUDA events over "
              f"{KERNEL_REPS} back-to-back wrapper calls), construct_tree + points_leaf_aabb {two_ms:.4f} ms in turns "
              f"({two_ms / ctb_ms:.3f}x); device {ctb_dev[True]:.4f} ms (its kernels alone, L2 cold; warm "
              f"{ctb_dev[False]:.4f}), the two calls' kernels {two_dev[True]:.4f} (warm {two_dev[False]:.4f}); "
              f"plain {ctb_plain_ms:.4f} ms; {time.perf_counter() - t_fused:.2f} s [{card}]")
        def k2_turns(spec_, pool_, o_, d_, opt_):
            """(width 4 ms, width 1 ms) of K2 in turns (`in_turns`)."""
            return in_turns(lambda: render_ops.volume_render_cuda(spec_, pool_, o_, d_, d_, opt_),
                            lambda: render_ops.volume_render_cuda(spec_, pool_, o_, d_, d_, opt_, width=1),
                            lambda fn: time_ms(fn, KERNEL_REPS))

        def k3_turns(spec_, pool_, o_, d_, g_, opt_, out_):
            """(width 4 ms, width 1 ms) of K3 in turns (`in_turns`), each call
            the wrapper's (a zeroed gradient, the launch)."""
            return in_turns(lambda: render_ops.volume_render_backward_cuda(spec_, pool_, o_, d_, d_, g_, opt_,
                                                                           out_res=out_),
                            lambda: render_ops.volume_render_backward_cuda(spec_, pool_, o_, d_, d_, g_, opt_,
                                                                           out_res=out_, width=1),
                            lambda fn: time_ms(fn, KERNEL_REPS))

        for fast in (False, True):
            opt = renderer._get_options(fast)
            k_ms, k1_ms = k2_turns(spec_t, f0, origins, dirs, opt)
            p_ms = time_ms(lambda: render_ops.volume_render_plain(spec_t, f0, origins, dirs, dirs, opt), 1)
            w_ms = time_ms(lambda: render_ops.volume_render_with_weight_accum_cuda(
                spec_t, f0, origins, dirs, dirs, opt), KERNEL_REPS)
            mode = "fast" if fast else "exact"
            print(f"time render_fwd SH9 {mode} {WIDTH}x{HEIGHT}: kernel {k_ms:.4f} ms "
                  f"({B / k_ms / 1e3:.2f} Mrays/s), its width-1 instance (the earlier loop) {k1_ms:.4f} ms in "
                  f"turns ({k1_ms / k_ms:.3f}x), plain {p_ms:.1f} ms "
                  f"({B / p_ms / 1e3:.4f} Mrays/s); with weight accumulation kernel {w_ms:.4f} ms, "
                  f"plain {fwd_plain_ms[('SH9+waccum', fast)]:.1f} ms (one call, phase 3) [{card}]")
            if not fast:
                kernels["render_fwd"].update(ms=k_ms, plain_ms=p_ms, prev_ms=k1_ms)
            out = render_ops.volume_render_cuda(spec_t, f0, origins, dirs, dirs, opt)
            g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
            b_ms, b1_ms = k3_turns(spec_t, f0, origins, dirs, g_out, opt, out)
            bp_ms = time_ms(lambda: render_ops.volume_render_backward_plain(
                spec_t, f0, origins, dirs, dirs, g_out, opt, out_res=out), 1)
            passes = "two passes" if fast else "single pass"
            print(f"time render_bwd SH9 {mode} ({passes}) {WIDTH}x{HEIGHT}: kernel {b_ms:.4f} ms, its width-1 "
                  f"instance (the earlier loop) {b1_ms:.4f} ms in turns ({b1_ms / b_ms:.3f}x), "
                  f"plain {bp_ms:.1f} ms [{card}]")
            if not fast:
                kernels["render_bwd"].update(ms=b_ms, plain_ms=bp_ms, prev_ms=b1_ms)
        tree_fwd_ms = {}
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            mode = "fast" if fast else "exact"
            kb_ms, kb1_ms = k2_turns(spec_bt, f0, origins, dirs, opt)
            tree_fwd_ms[fast] = time_ms(lambda: render_ops.volume_render_cuda(
                spec_t, f0, origins, dirs, dirs, opt), KERNEL_REPS)
            wb_ms = time_ms(lambda: render_ops.volume_render_with_weight_accum_cuda(
                spec_bt, f0, origins, dirs, dirs, opt), KERNEL_REPS)
            out = render_ops.volume_render_cuda(spec_bt, f0, origins, dirs, dirs, opt)
            g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
            bb_ms, bb1_ms = k3_turns(spec_bt, f0, origins, dirs, g_out, opt, out)
            print(f"time render_fwd_baked SH9 {mode} {WIDTH}x{HEIGHT}: kernel {kb_ms:.4f} ms "
                  f"({B / kb_ms / 1e3:.2f} Mrays/s; its width-1 instance (the earlier loop) {kb1_ms:.4f} ms in "
                  f"turns ({kb1_ms / kb_ms:.3f}x); the tree walk's kernel {tree_fwd_ms[fast]:.4f} ms "
                  f"in the same turn), with weight accumulation {wb_ms:.4f} ms, plain "
                  f"{baked_plain_ms[('SH9', fast)]:.1f} ms (one call, phase 3d); render_bwd_baked "
                  f"({'two passes' if fast else 'single pass'}) kernel {bb_ms:.4f} ms, width 1 {bb1_ms:.4f} ms "
                  f"in turns ({bb1_ms / bb_ms:.3f}x), plain {baked_plain_ms[('bwd', fast)]:.1f} ms (one call, "
                  f"phase 3d) [{card}]")
            if not fast:
                kernels["render_fwd_baked"].update(ms=kb_ms, plain_ms=baked_plain_ms[("SH9", False)],
                                                   prev_ms=kb1_ms)
                kernels["render_bwd_baked"].update(ms=bb_ms, plain_ms=baked_plain_ms[("bwd", False)],
                                                   prev_ms=bb1_ms)
        # Shape (b), bench.py's headline shell in pixel order, and shape (a)
        # with rotations (the dynamic frames'), exact, on both structures.
        opt7 = r7._get_options(False)
        for label, t_, p_, o_, d_, opt_, rm in (("(b) headline", tree7, feats7, o7, d7, opt7, None),
                                                ("(a) SH9+rot", tree, feats, origins, dirs,
                                                 sh_renderer._get_options(False), rot)):
            line, line_b = [], []
            for s_ in ("tree", "baked"):
                sp = (t_._baked_spec if s_ == "baked" else t_._spec)(transformation_matrices=rm)
                a_ms, a1_ms = k2_turns(sp, p_, o_, d_, opt_)
                line.append(f"{s_} {a_ms:.4f} ms, width 1 {a1_ms:.4f} ({a1_ms / a_ms:.3f}x)")
                out_ = render_ops.volume_render_cuda(sp, p_, o_, d_, d_, opt_)
                g_ = torch.from_numpy(rng.randn(*out_.shape).astype(np.float32)).to(dev)
                a_ms, a1_ms = k3_turns(sp, p_, o_, d_, g_, opt_, out_)
                line_b.append(f"{s_} {a_ms:.4f} ms, width 1 {a1_ms:.4f} ({a1_ms / a_ms:.3f}x)")
            print(f"time render_fwd {label} exact {WIDTH}x{HEIGHT}, width 4 against width 1 (the earlier loop) in "
                  f"turns: " + "; ".join(line) + f" [{card}]")
            print(f"time render_bwd {label} exact (single pass) {WIDTH}x{HEIGHT}, width 4 against width 1 (the "
                  f"earlier loop) in turns: " + "; ".join(line_b) + f" [{card}]")
        for name, cspec, cfeats, rend in cases[3:]:
            opt = rend._get_options(False)
            l_ms = time_ms(lambda: render_ops.volume_render_cuda(cspec, cfeats, origins, dirs, dirs, opt),
                           KERNEL_REPS)
            print(f"time render_fwd {name} exact {WIDTH}x{HEIGHT}: kernel {l_ms:.4f} ms, "
                  f"plain {fwd_plain_ms[(name, False)]:.1f} ms (one call, phase 3) [{card}]")
        qpts = frame_points[0]
        qf_ms = time_ms(lambda: query_ops.query_forward_cuda(spec_t, f0, qpts), KERNEL_REPS)
        qf_plain_ms = time_ms(lambda: query_ops.query_forward_plain(spec_t, f0, qpts), 3)
        _, _, didx = query_ops.query_forward_cuda(spec_t, f0, qpts)
        g_v = torch.from_numpy(rng.randn(M, 28).astype(np.float32)).to(dev)
        qb_ms = time_ms(lambda: query_ops.query_backward_cuda(didx, g_v, M), KERNEL_REPS)
        qb_dev_ms, qb_how = kernel_alone_ms(lambda: query_ops.query_backward_cuda(didx, g_v, M), KERNEL_REPS,
                                            ("query_bwd",))
        qb_plain_ms = time_ms(lambda: query_ops.query_backward_plain(didx, g_v, M), 3)
        check(bool((didx < M).all()), "a leaf centre in empty space")
        didx_l = didx.long()
        qb_lib_ms = time_ms(lambda: torch.zeros(M, 28, device=dev).index_add_(0, didx_l, g_v),
                            KERNEL_REPS)
        kernels["query_fwd"].update(ms=qf_ms, plain_ms=qf_plain_ms)
        kernels["query_bwd"].update(ms=qb_ms, plain_ms=qb_plain_ms, library_ms=qb_lib_ms)
        print(f"time query ({M} points, D 28): forward kernel {qf_ms:.4f} ms, plain {qf_plain_ms:.4f} ms; "
              f"backward kernel {qb_ms:.4f} ms a wrapper call (its kernels alone {qb_dev_ms:.4f} ms, {qb_how}, "
              f"L2 cold), plain {qb_plain_ms:.4f} ms, index_add_ {qb_lib_ms:.4f} ms [{card}]")
        # The bf16 query (K5) on the same points; its library call sums
        # the bf16 gradients in a bf16 buffer, as the JAX package does.
        fb0, g_vb = f0.to(torch.bfloat16), g_v.to(torch.bfloat16)
        times = dict(
            fwd=time_ms(lambda: query_ops.query_forward_cuda(spec_t, fb0, qpts), KERNEL_REPS),
            fwd_plain=time_ms(lambda: query_ops.query_forward_plain(spec_t, fb0, qpts), 3),
            bwd=time_ms(lambda: query_ops.query_backward_cuda(didx, g_vb, M), KERNEL_REPS),
            bwd_plain=time_ms(lambda: query_ops.query_backward_plain(didx, g_vb, M), 3),
            lib=time_ms(lambda: torch.zeros(M, 28, dtype=torch.bfloat16, device=dev).index_add_(
                0, didx_l, g_vb), KERNEL_REPS))
        kernels["query_fwd_bf16"].update(ms=times["fwd"], plain_ms=times["fwd_plain"])
        kernels["query_bwd_bf16"].update(ms=times["bwd"], plain_ms=times["bwd_plain"], library_ms=times["lib"])
        print(f"time query bf16 ({M} points, D 28): forward kernel {times['fwd']:.4f} ms, plain "
              f"{times['fwd_plain']:.4f} ms; backward kernel {times['bwd']:.4f} ms, plain "
              f"{times['bwd_plain']:.4f} ms, index_add_ (bf16 sums) {times['lib']:.4f} ms [{card}]")
        # Every other copy unit of the query forward on the same points
        # (the narrower units a misaligned pool takes, forced) and the
        # generic instance (D 24, a contiguous column slice, at its rule's
        # unit), each against its plain version bit for bit, once.
        held = []
        for pool in (f0, fb0, f0[:, :24].contiguous(), fb0[:, :24].contiguous()):
            want = query_ops.query_forward_plain(spec_t, pool, qpts)
            rule = query_ops.query_unit(pool.shape[1], pool.dtype, (pool.data_ptr(),))
            units = [u for u in query_ops.QUERY_UNITS[pool.dtype] if u < rule] if pool.shape[1] == 28 else [rule]
            for u in units:
                got = query_ops.query_forward_cuda(spec_t, pool, qpts, unit=u)
                name = f"{'f32' if pool.dtype == torch.float32 else 'bf16'} D {pool.shape[1]} unit {u}"
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"query forward {name}: kernel and plain version disagree")
                held.append(name)
        print(f"query forward, every other instance on the {qpts.shape[0]} points: {', '.join(held)}: values and "
              f"ids equal to plain")
        # Likewise the query backward: every unit of the SH9 rows (forced)
        # and the generic instance (D 24), on every id with a duplicated
        # tenth (rows that take several points) and on a tenth of the ids,
        # each within the atomic tolerance of its plain version, once.
        held = []
        tenth = didx.shape[0] // 10
        for gv in (g_v, g_vb):
            for ids_p, g_p, ids_what in ((torch.cat([didx, didx[:tenth]]), torch.cat([gv, gv[:tenth] * 0.5]),
                                          "every id and a tenth twice"), (didx[:tenth], gv[:tenth], "a tenth")):
                for g_d in (g_p, g_p[:, :24].contiguous()):
                    want = query_ops.query_backward_plain(ids_p, g_d, M)
                    rule = query_ops.query_bwd_unit(g_d.shape[1], g_d.dtype, (g_d.data_ptr(), 256))
                    units = ([u for u in query_ops.QUERY_BWD_UNITS[g_d.dtype] if u <= rule]
                             if g_d.shape[1] == 28 else [rule])
                    for u in units:
                        name = f"{'f32' if g_d.dtype == torch.float32 else 'bf16'} D {g_d.shape[1]} unit {u} ({ids_what})"
                        atomic_err(query_ops.query_backward_cuda(ids_p, g_d, M, unit=u), want,
                                   f"query backward {name}")
                        held.append(name)
        print(f"query backward, every instance ({M} points): {', '.join(held)}: within the atomic tolerance of "
              f"plain")

        # The aux kernels, on the aux scene pointed at the canonical rows.
        for fast in (False, True):
            opt = sh_renderer._get_options(fast)
            mode = "fast" if fast else "exact"
            alpha = aux_ops.opacity_render(aux_spec, f0, origins, dirs, opt)
            g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
            g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
            runs = {
                "opacity_bwd": (lambda: aux_ops.opacity_backward_cuda(
                                    aux_spec, f0, origins, dirs, g_a, opt, out_res=alpha),
                                lambda: aux_ops.opacity_backward_plain(
                                    aux_spec, f0, origins, dirs, g_a, opt, out_res=alpha)),
                "first_hit": (lambda: aux_ops.first_hit_cuda(aux_spec, f0, origins, dirs, opt),
                              lambda: aux_ops.first_hit_plain(aux_spec, f0, origins, dirs, opt)),
                "mf_fwd": (lambda: aux_ops.motion_feature_forward_cuda(
                               aux_spec, jf_true, f0, origins, dirs, opt),
                           lambda: aux_ops.motion_feature_render_plain(
                               aux_spec, jf_true, f0, origins, dirs, opt)),
                "mf_bwd": (lambda: aux_ops.motion_feature_backward_cuda(
                               aux_spec, jf_true, f0, origins, dirs, g_m, opt),
                           lambda: aux_ops.motion_feature_backward_plain(
                               aux_spec, jf_true, f0, origins, dirs, g_m, opt)),
            }
            for name, (run_k, run_p) in runs.items():
                turns = ""
                if name.startswith("mf_"):
                    k_ms, k1_ms = mf_turns(aux_spec, jf_true, f0, origins, dirs, opt,
                                           g_m if name == "mf_bwd" else None)
                    turns = f", {MF_TURNS} {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                    if not fast:
                        kernels[name]["prev_ms"] = k1_ms
                else:
                    k_ms = time_ms(run_k, KERNEL_REPS)
                p_ms = time_ms(run_p, 1)
                print(f"time {name} SH9 {mode} {WIDTH}x{HEIGHT} (J {N_JOINTS}, Kd {JOINT_DIM}, "
                      f"{N_BONES} bones): kernel {k_ms:.4f} ms{turns}, plain {p_ms:.1f} ms [{card}]")
                if not fast:
                    kernels[name].update(ms=k_ms, plain_ms=p_ms)

        # The aux path's frames and steps beside the K9c and K9d times.
        print(f"aux path beside K9c and K9d: serving frame host ms {aux_frame_ms} (phase 4c), training step host "
              f"ms {aux_step_ms} (phase 4d) [{card}]")

        # The baked aux instances, exact, on the aux scene's bake.
        opt = sh_renderer._get_options(False)
        alpha = aux_ops.opacity_render(aux_baked, f0, origins, dirs, opt)
        g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
        g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
        runs = {
            "opacity_bwd_baked": lambda: aux_ops.opacity_backward_cuda(
                aux_baked, f0, origins, dirs, g_a, opt, out_res=alpha),
            "first_hit_baked": lambda: aux_ops.first_hit_cuda(aux_baked, f0, origins, dirs, opt),
            "mf_fwd_baked": lambda: aux_ops.motion_feature_forward_cuda(
                aux_baked, jf_true, f0, origins, dirs, opt),
            "mf_bwd_baked": lambda: aux_ops.motion_feature_backward_cuda(
                aux_baked, jf_true, f0, origins, dirs, g_m, opt),
        }
        for name, run_k in runs.items():
            turns = ""
            if name.startswith("mf_"):
                k_ms, k1_ms = mf_turns(aux_baked, jf_true, f0, origins, dirs, opt,
                                       g_m if name.startswith("mf_bwd") else None)
                kernels[name]["prev_ms"] = k1_ms
                turns = f", {MF_TURNS} {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
            else:
                k_ms = time_ms(run_k, KERNEL_REPS)
            p_ms = baked_plain_ms[(name[: -len("_baked")], False)]
            kernels[name].update(ms=k_ms, plain_ms=p_ms)
            print(f"time {name} SH9 exact {WIDTH}x{HEIGHT}: kernel {k_ms:.4f} ms{turns} (tree walk "
                  f"{kernels[name[: -len('_baked')]]['ms']:.4f} ms), plain {p_ms:.1f} ms "
                  f"(one call, phase 3d) [{card}]")

        # The trilinear (K4) instances, exact, on the aux scene (canonical
        # rows); plain: one call, phase 3e. The nearest-mode kernel of the
        # same structure in the same turn, for comparison.
        opt = interp_r._get_options(False)
        opt_n = sh_renderer._get_options(False)
        for sfx, ispec in interp_specs.items():
            out = render_ops.volume_render_cuda(ispec, feats, origins, dirs, dirs, opt)
            g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
            alpha = out[:, -1:].contiguous()
            g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
            g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
            runs = {
                "render_fwd": lambda o_=opt: render_ops.volume_render_cuda(ispec, feats, origins, dirs, dirs, o_),
                "render_bwd": lambda o_=opt: render_ops.volume_render_backward_cuda(
                    ispec, feats, origins, dirs, dirs, g_out, o_, out_res=out),
                "opacity_bwd": lambda o_=opt: aux_ops.opacity_backward_cuda(
                    ispec, feats, origins, dirs, g_a, o_, out_res=alpha),
                "first_hit": lambda o_=opt: aux_ops.first_hit_cuda(ispec, feats, origins, dirs, o_),
                "mf_fwd": lambda o_=opt: aux_ops.motion_feature_forward_cuda(
                    ispec, jf_true, feats, origins, dirs, o_),
                "mf_bwd": lambda o_=opt: aux_ops.motion_feature_backward_cuda(
                    ispec, jf_true, feats, origins, dirs, g_m, o_),
            }
            for name, run_k in runs.items():
                width_1 = ""
                if name == "render_fwd":
                    # K2+K4 at width 4 against its width 1 (the same corner
                    # lookups, the scalar row) in turns.
                    k_ms, k1_ms = k2_turns(ispec, feats, origins, dirs, opt)
                    kernels[name + sfx]["prev_ms"] = k1_ms
                    width_1 = f", its width-1 instance {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                elif name == "render_bwd":
                    # K3+K4 at width 4 against its width 1 (the earlier loop:
                    # 9 lookups, scalar rows and atomics) in turns.
                    k_ms, k1_ms = k3_turns(ispec, feats, origins, dirs, g_out, opt, out)
                    kernels[name + sfx]["prev_ms"] = k1_ms
                    width_1 = f", its width-1 instance (the earlier loop) {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                elif name.startswith("mf_"):
                    k_ms, k1_ms = mf_turns(ispec, jf_true, feats, origins, dirs, opt,
                                           g_m if name == "mf_bwd" else None)
                    kernels[name + sfx]["prev_ms"] = k1_ms
                    width_1 = f", {MF_TURNS} {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                else:
                    k_ms = time_ms(run_k, KERNEL_REPS)
                n_ms = time_ms(lambda: run_k(opt_n), KERNEL_REPS)
                kernels[name + sfx].update(ms=k_ms, plain_ms=interp_plain_ms[name + sfx])
                print(f"time {name}{sfx} SH9 exact {WIDTH}x{HEIGHT}: kernel {k_ms:.4f} ms{width_1} (nearest mode "
                      f"{n_ms:.4f} ms in the same turn), plain {interp_plain_ms[name + sfx]:.1f} ms (one call, "
                      f"phase 3e) [{card}]")
                if name == "render_fwd":
                    with torch.no_grad():
                        rot_spec = ispec.with_(transformation_matrices=rot)
                        r_ms, r1_ms = k2_turns(rot_spec, feats, origins, dirs, opt)
                    print(f"time render_fwd{sfx} SH9+rot exact {WIDTH}x{HEIGHT}: kernel {r_ms:.4f} ms, its "
                          f"width-1 instance {r1_ms:.4f} ms in turns ({r1_ms / r_ms:.3f}x) [{card}]")

        # The pool instances (K5), exact, on the aux scene's camera rays;
        # plain: one call on the same rays, phase 3f. The float32
        # instance on the same structure in the same turn, for comparison.
        for pk in POOL_KINDS:
            pool, _ = pool_of(pk, feats)
            for isfx, rend in (("", sh_renderer), ("_interp", interp_r)):
                opt = rend._get_options(False)
                for ssfx, pspec in (("", aux_spec), ("_baked", aux_baked)):
                    sfx = ssfx + isfx
                    out = render_ops.volume_render_cuda(pspec, feats, origins, dirs, dirs, opt)
                    alpha = out[:, -1:].contiguous()
                    g_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dev)
                    g_a = torch.from_numpy(rng.randn(B, 1).astype(np.float32)).to(dev)
                    g_m = torch.from_numpy(rng.randn(B, JOINT_DIM).astype(np.float32)).to(dev)
                    runs = {
                        "render_fwd": lambda p_: render_ops.volume_render_cuda(pspec, p_, origins, dirs, dirs, opt),
                        "render_bwd": lambda p_: render_ops.volume_render_backward_cuda(
                            pspec, p_, origins, dirs, dirs, g_out, opt, out_res=out),
                        "opacity_bwd": lambda p_: aux_ops.opacity_backward_cuda(
                            pspec, p_, origins, dirs, g_a, opt, out_res=alpha),
                        "first_hit": lambda p_: aux_ops.first_hit_cuda(pspec, p_, origins, dirs, opt),
                        "mf_fwd": lambda p_: aux_ops.motion_feature_forward_cuda(
                            pspec, jf_true, p_, origins, dirs, opt),
                        "mf_bwd": lambda p_: aux_ops.motion_feature_backward_cuda(
                            pspec, jf_true, p_, origins, dirs, g_m, opt),
                    }
                    for name, run_k in runs.items():
                        key = f"{name}{sfx}_{pk}"
                        if key not in kernels:
                            continue
                        width_1 = ""
                        if name == "render_fwd":
                            k_ms, k1_ms = k2_turns(pspec, pool, origins, dirs, opt)
                            kernels[key]["prev_ms"] = k1_ms
                            width_1 = f", its width-1 instance {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                        elif name == "render_bwd":
                            k_ms, k1_ms = k3_turns(pspec, pool, origins, dirs, g_out, opt, out)
                            kernels[key]["prev_ms"] = k1_ms
                            width_1 = f", its width-1 instance {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                        elif name.startswith("mf_"):
                            k_ms, k1_ms = mf_turns(pspec, jf_true, pool, origins, dirs, opt,
                                                   g_m if name == "mf_bwd" else None)
                            kernels[key]["prev_ms"] = k1_ms
                            width_1 = f", {MF_TURNS} {k1_ms:.4f} ms in turns ({k1_ms / k_ms:.3f}x)"
                        else:
                            k_ms = time_ms(lambda: run_k(pool), KERNEL_REPS)
                        f_ms = time_ms(lambda: run_k(feats), KERNEL_REPS)
                        kernels[key].update(ms=k_ms, plain_ms=pool_plain_ms[key])
                        print(f"time {key} SH9 exact {WIDTH}x{HEIGHT}: kernel {k_ms:.4f} ms{width_1} (float32 "
                              f"pool {f_ms:.4f} ms in the same turn), plain {pool_plain_ms[key]:.1f} ms (one call, "
                              f"phase 3f) [{card}]")

        # The bake's kernels at the main path's shapes: the bake's three
        # kernels alone by the profiler, L2 cold, beside the CUDA-event time
        # of back-to-back wrapper calls (a call shorter than its dispatch
        # counts the host there); points_leaf_aabb by CUDA events. Plain:
        # one call, phase 3d.
        runs = {
            "bake_lookup": (lambda: bake_ops.lookup_cuda(baked, lk_pts), lookup_plain_ms,
                            f"{lk_pts.shape[0]} points", ("lookup_kernel",)),
            "bake_refresh": (lambda: bake_ops.refresh_cuda(baked, new_flat, lo, hi), refresh_plain_ms,
                             f"{baked.src_map.numel()} baked cells", ("refresh_kernel",)),
            "grow_boxes": (lambda: bake_ops.grow_boxes_cuda(gb_ref), grow_plain_ms,
                           f"{gb.R}^3 top grid", ("distance_pass", "pack_boxes_kernel")),
            "points_aabb": (lambda: query_ops.points_leaf_aabb_cuda(spec, points), aabb_plain_ms,
                            f"{M} points", None),
        }
        for name, (run_k, p_ms, what, names) in runs.items():
            e_ms = time_ms(run_k, KERNEL_REPS)
            k_ms, how = kernel_alone_ms(run_k, KERNEL_REPS, names) if names else (e_ms, "")
            kernels[name].update(ms=k_ms, plain_ms=p_ms, timer=how or "CUDA events")
            alone = f" alone ({how}, L2 cold), {e_ms:.4f} ms a wrapper call (CUDA events)" if names else ""
            print(f"time {name} ({what}): kernel {k_ms:.4f} ms{alone}, plain {p_ms:.2f} ms (one call) [{card}]")

        # The warp and voxelize kernels at the deep configuration's shapes
        # (the warp backward forms all three gradients); plain: one call,
        # phase 3c.
        runs = {
            "warp_fwd": lambda: warp_ops.warp_forward_cuda(T1, centers, rig_sw, rig_ji),
            "warp_bwd": lambda: warp_ops.warp_backward_cuda(T1, centers, rig_sw, rig_ji, g_x, g_M),
            "voxelize_fwd": lambda: p2v_ops.voxelize_forward_cuda(warped1, feats, grid),
            "voxelize_bwd": lambda: p2v_ops.voxelize_backward_cuda(warped1, feats, grid, g_vol),
        }
        plain_once = dict(warp_fwd=warp_fwd_plain_ms, warp_bwd=warp_bwd_plain_ms,
                          voxelize_fwd=vox_fwd_plain_ms, voxelize_bwd=vox_bwd_plain_ms)
        for name, run_k in runs.items():
            k_ms = time_ms(run_k, KERNEL_REPS)
            kernels[name].update(ms=k_ms, plain_ms=plain_once[name])
            print(f"time {name} ({M} points, J {N_JOINTS}, {N_BONES} bones, {P2V_N}^3 grid): "
                  f"kernel {k_ms:.4f} ms, plain {plain_once[name]:.2f} ms (one call) [{card}]")
        # The tree-editing kernels at the editing path's shapes (the depth-9
        # shell before its edits); plain: one call, phase 4i.
        e_ids, e_N, e_cells = edit["unique_args"]
        runs = {
            "calc_corners": (lambda: query_ops.calc_corners_cuda(*edit["calc_corners_args"]),
                             f"{len(edit['calc_corners_args'][1])} leaves"),
            "assign": (lambda: query_ops.assign_cuda(*edit["assign_args"]),
                       f"{edit['assign_args'][2].shape[0]} points into a ({M}, 28) pool"),
            "unique_leaf": (lambda: query_ops.unique_leaf_nodes_cuda(e_ids, e_N, n_cells=e_cells),
                            f"{e_ids.shape[0]} ids over {e_cells} cells"),
        }
        for name, (run_k, what) in runs.items():
            k_ms = time_ms(run_k, KERNEL_REPS)
            kernels[name].update(ms=k_ms, plain_ms=edit["plain_ms"][name])
            print(f"time {name} ({what}): kernel {k_ms:.4f} ms, plain {edit['plain_ms'][name]:.2f} ms "
                  f"(one call) [{card}]")
        uq_lib_ms = time_ms(lambda: torch.unique(e_ids, sorted=True), KERNEL_REPS)
        kernels["unique_leaf"]["library_ms"] = uq_lib_ms
        print(f"time torch.unique (sorted) of the same ids: {uq_lib_ms:.4f} ms [{card}]")
        w2_ms = time_ms(lambda: warp_ops.warp_backward_cuda(T2, centers, sw2, ji2, g_x, g_M),
                        KERNEL_REPS)
        w2_dt_ms = time_ms(lambda: warp_ops.warp_backward_cuda(T2, centers, sw2, ji2, g_x, None,
                                                               True, False, False), KERNEL_REPS)
        print(f"time warp_bwd J 2 nb 2 ({M} points): kernel {w2_ms:.4f} ms, dT only "
              f"{w2_dt_ms:.4f} ms [{card}]")
        # K10's backward at its other callers' shapes, and K11's forward in
        # the serving frames' random order (CUDA events, as above).
        callers = {
            "warp_bwd (b) the pose fit's call: g_x only, dT only": lambda: warp_ops.warp_backward_cuda(
                T1, centers, rig_sw, rig_ji, g_x, None, True, False, False),
            "warp_bwd (c) bench.py's rig, J 2 nb 2: g_x and g_M, dT only": lambda: warp_ops.warp_backward_cuda(
                T2, centers, sw2, ji2, g_x, g_M, True, False, False),
            "voxelize_fwd, the cloud in a random order": lambda: p2v_ops.voxelize_forward_cuda(
                warped_rand, feats_rand, grid),
        }
        t_callers = time.perf_counter()
        for what, run_k in callers.items():
            print(f"time {what} ({M} points): kernel {time_ms(run_k, KERNEL_REPS):.4f} ms [{card}]")
        print(f"the callers' shapes above: {time.perf_counter() - t_callers:.1f} s")

    # The tape kernels (K13) on the depth-9 shell before its re-points
    # (phase 3g's structures and tape), each beside the march kernel.
    tp9 = tape_res["samples"].pop("tape")
    tape_kernel_times(tp9, {"": spec, "_baked": baked}, feats, origins, dirs,
                      sh_renderer._get_options(False), tape_res["plain_ms"], kernels, dev, card)
    dcensus = tape_frames_kernel_times(tp9, baked, feats, origins, dirs, sh_renderer._get_options(False),
                                       depth_case, tape_res["plain_ms"], kernels, dev, card)
    del tp9, depth_case
    cost_kernel_times({"": spec, "_baked": baked}, feats, origins, dirs,
                      {fast: sh_renderer._get_options(fast) for fast in (False, True)}, cost_res, kernels,
                      card)

    # Forward + backward of a render loss, as bench.py names it:
    # fwd_bwd_ms sustained (CUDA events over KERNEL_REPS calls),
    # fwd_bwd_single_call_ms one synchronized call on the host clock (min of 3).
    opt_e = renderer._get_options(False)
    g_img = torch.from_numpy(rng.randn(B, 4).astype(np.float32)).to(dev)
    fb_pool = f0.clone().requires_grad_()

    def fwd_bwd():
        out = render_ops.volume_render(spec_t, fb_pool, origins, dirs, dirs, opt_e)
        return torch.autograd.grad((out * g_img).sum(), fb_pool)[0]

    fwd_bwd_ms = time_ms(fwd_bwd, KERNEL_REPS)
    single = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)

    def fwd_bwd_baked():
        out = render_ops.volume_render(spec_bt, fb_pool, origins, dirs, dirs, opt_e)
        return torch.autograd.grad((out * g_img).sum(), fb_pool)[0]

    fwd_bwd_baked_ms = time_ms(fwd_bwd_baked, KERNEL_REPS)
    print(f"time fwd_bwd SH9 exact {WIDTH}x{HEIGHT} (tree walk): fwd_bwd_ms {fwd_bwd_ms:.4f}, "
          f"fwd_bwd_single_call_ms {min(single):.4f}, fwd_bwd_mrays_s {B / fwd_bwd_ms / 1e3:.2f}; "
          f"on the bake fwd_bwd_baked_ms {fwd_bwd_baked_ms:.4f} [{card}]")
    for backend in BACKENDS:
        print(f"time training step ({backend}; construct_tree + render_persp + loss + query prior + "
              f"backward + Adam), host clock: median {statistics.median(step_ms[backend]):.3f} ms of "
              f"{[round(x, 3) for x in step_ms[backend]]} [{card}]")
    print(f"time dynamic frames (render_dynamic_frames, host clock, synchronized): "
          + ", ".join(f"{k} {v:.4f}" for k, v in {**dyn_ms, **bench_ms}.items())
          + "; dynamic training step median "
          + ", ".join(f"{b_} {statistics.median(dyn_step_ms[b_]):.3f} ms" for b_ in BACKENDS)
          + f"; pose-fit step median {statistics.median(pose_step_ms):.3f} ms, warp + voxelize per "
          f"frame {p2v_frame_ms:.4f} ms [{card}]")

    # 6. Bounds: the least time of each kernel's work at these shapes,
    # from what this run's data makes the march do (exact SH9 camera).
    census = march_census(spec, feats, origins, dirs, sh_renderer._get_options(False))
    census_b = march_census(baked, feats, origins, dirs, sh_renderer._get_options(False))
    leaf = traversal.descend(spec, traversal.world2tree(pts, spec.offset, spec.scaling))
    q_levels = int(torch.round(torch.log2(leaf.cube_sz) / float(np.log2(spec.N))).sum())
    bounds = march_bounds(census, M, 28)
    bounds.update(march_bounds(census_b, M, 28))
    e_spec, e_leaves = edit["calc_corners_args"]
    bounds.update(kernel_bounds(M, 28, spec.data_flat.numel(), pts.shape[0], q_levels, dict(
        rows=e_leaves.shape[0], steps=edit["corner_steps"], nodes=e_spec.n_internal,
        points=edit["assign_args"][2].shape[0], levels=edit["assign_levels"],
        ids=edit["unique_args"][0].shape[0])))
    bounds.update(bake_bounds(lk_pts.shape[0], baked.src_map.numel(),
                              baked.top.numel() + baked.n_mid, gb.R))
    print(f"census (SH9 exact, {WIDTH}x{HEIGHT}, tree walk): {census}")
    print(f"census (SH9 exact, {WIDTH}x{HEIGHT}, bake): {census_b}")
    print(f"K3 census (SH9 exact, {WIDTH}x{HEIGHT}): {census['contrib']} contributing samples; reductions into "
          f"the (M, 28) gradient: width 1 (the earlier loop) {28 * census['contrib']} scalar, width 4 "
          f"{7 * census['contrib']} vector (28 and 7 a sample)")
    # K2's one-wave question: the 128-ray blocks that march or hold a hit
    # against the blocks the card holds at once at each width's registers.
    for label, c_, unit in (("tree walk", census, "render_fwd.cu"), ("bake", census_b, "render_fwd_baked.cu")):
        waves = []
        for w in (4, 1):
            if (unit, w) in march_regs:
                resident = N_SMS * blocks_per_sm(march_regs[unit, w])
                waves.append(f"width {w}: {march_regs[unit, w]} registers, {resident} resident blocks, "
                             f"{c_['blocks_marching'] / resident:.2f} waves of marching blocks, "
                             f"{c_['blocks_hit'] / resident:.2f} of hit blocks")
        print(f"K2 waves ({label}, SH9 exact): {c_['hitting']} hitting rays of {c_['rays']} ({c_['marching']} "
              f"march), samples per hitting ray max {c_['samples_hit_max']}, p99 {c_['samples_hit_p99']}, median "
              f"{c_['samples_hit_median']} (per marching ray max {c_['samples_max']}, p99 {c_['samples_p99']}); "
              f"128-ray blocks: {c_['blocks']}, {c_['blocks_marching']} marching, {c_['blocks_hit']} with a hit; "
              + "; ".join(waves))
    # The pool instances (K5) take the same samples as the float32 ones
    # (their forwards are equal bit for bit, and no sigma changed sign;
    # phase 3f), so the same census with the pool's bytes.
    for pk in POOL_KINDS:
        for c_ in (census, census_b):
            bounds.update({k: v for k, v in march_bounds(c_, M, 28, pk).items() if k in kernels})
    for label, ispec in (("tree walk", aux_spec), ("bake", aux_baked)):
        c_i = march_census(ispec, feats, origins, dirs, interp_r._get_options(False))
        # K9b's lookups up to each ray's first hit, nearest and interp, as
        # its kernel makes them (first_hit_path's census); the interp
        # instances' bounds count them.
        for interp_fh in (False, True):
            opt_fh = dataclasses.replace(interp_r._get_options(False), interp=int(interp_fh))
            c_fh = first_hit_path.first_hit_census(ispec, feats, origins, dirs, opt_fh)
            print(k9b_census_line(c_fh, label, card))
        check(c_fh["samples"] == c_i["fh_samples"], "K9b census: not the interp march census's first-hit samples")
        c_i.update(k9b_loads=c_fh["loads_keep"], k9b_lookups=c_fh["lookups_keep"])
        bounds.update(interp_bounds(c_i, M, 28))
        for pk in POOL_KINDS:
            bounds.update({k: v for k, v in interp_bounds(c_i, M, 28, pk).items() if k in kernels})
        print(f"census (SH9 exact, interp, {WIDTH}x{HEIGHT}, {label}): {c_i}")
        # K2+K4's lookups: the table loads a sample makes as the width-4
        # kernel makes them (render_fwd.cuh kCornerReuse: levers 1-2 on the
        # tree walk, the own corner's row and the own path reused; lever 1
        # on the bake), with lever 1 alone, and with 9 lookups from the
        # root, from corner_lookup's mirror; and render_fwd's bound counted
        # from the kernel's lookups (the kernels line's) and from 9 lookups
        # from the root (the earlier kernel's count).
        sam = max(c_i["samples"], 1)
        fwd = "render_fwd" + ("_baked_interp" if c_i["baked"] else "_interp")
        b_k, b_9 = bounds[fwd], interp_bounds(c_i, M, 28, nine=True)[fwd]
        levers = "lever 1" if c_i["baked"] else "levers 1-2"
        print(f"K2+K4 census ({label}, SH9 exact interp): {c_i['marching']} marching rays of {c_i['rays']}, "
              f"{c_i['samples']} samples; table loads of the lookups: the width-4 kernel's ({levers}) "
              f"{c_i['k4_loads']} ({c_i['k4_loads'] / sam:.3f} a sample, {c_i['k4_lookups'] / sam:.3f} lookups), "
              f"lever 1 alone {c_i['k4_loads_own']} ({c_i['k4_loads_own'] / sam:.3f}), 9 from the root "
              f"{c_i['k4_loads_root']} ({c_i['k4_loads_root'] / sam:.3f}); the width-4 kernel's "
              f"{c_i['k4_loads_root'] / max(c_i['k4_loads'], 1):.3f}x fewer than 9 from the root; bound of {fwd} "
              f"{b_k['bound_ms']:.5f} ms ({b_k['bound_by']}) counting the kernel's lookups, "
              f"{b_9['bound_ms']:.5f} ms ({b_9['bound_by']}) counting 9 lookups from the root [{card}]")
        # K3+K4's reductions: each contributing sample's gradient row into
        # each of its corners that has a row, 28 scalar reductions a corner at
        # width 1, 7 vector ones at width 4; its lookups are K2+K4's.
        fh = "first_hit" + ("_baked_interp" if c_i["baked"] else "_interp")
        print(f"K9b+K4 bound ({label}): {bounds[fh]['bound_ms']:.5f} ms ({bounds[fh]['bound_by']}) counting the "
              f"kernel's lookups ({c_i['k9b_lookups'] / max(c_i['fh_samples'], 1):.3f} a sample), "
              f"{interp_bounds(c_i, M, 28, nine=True)[fh]['bound_ms']:.5f} ms counting 9 lookups from the root "
              f"(the earlier kernel's) [{card}]")
        op = "opacity_bwd" + ("_baked_interp" if c_i["baked"] else "_interp")
        print(f"K9a+K4 bound ({label}): {bounds[op]['bound_ms']:.5f} ms ({bounds[op]['bound_by']}) counting the "
              f"kernel's lookups (K2+K4's, {c_i['k4_lookups'] / sam:.3f} a sample), "
              f"{interp_bounds(c_i, M, 28, nine=True)[op]['bound_ms']:.5f} ms counting 9 lookups from the root "
              f"(the earlier kernel's) [{card}]")
        cc = c_i["contrib_corners"]
        print(f"K3+K4 census ({label}, SH9 exact interp): {c_i['contrib']} contributing samples, {cc} corners with "
              f"a row among them ({cc / max(c_i['contrib'], 1):.3f} a sample); reductions into the (M, 28) "
              f"gradient: width 1 (the earlier loop) {28 * cc} scalar, width 4 {7 * cc} vector; lookups a sample: "
              f"width 1 9, width 4 {c_i['k4_lookups'] / sam:.3f}; bound of {fwd.replace('fwd', 'bwd')} "
              f"{bounds[fwd.replace('fwd', 'bwd')]['bound_ms']:.5f} ms counting the width-4 kernel's lookups, "
              f"{interp_bounds(c_i, M, 28, nine=True)[fwd.replace('fwd', 'bwd')]['bound_ms']:.5f} ms counting 9 "
              f"[{card}]")
    p2v_c = p2v_census(warped1, grid)
    bounds.update(dynamic_bounds(M, N_BONES, N_JOINTS, 28, P2V_N, p2v_c, touched))
    bounds.update(tape_bounds(census, census_b, tape_res["samples"], M, 28, tape_res["chunks"]))
    bounds.update(tape_frames_bounds(census_b, tape_res["samples"]["_baked", False, True], M, 28, dcensus))
    bounds.update(minibatch_bounds(mb_census))
    for sfx, c_ in cost_res["census"].items():
        b_ = cost_bound(c_)
        print(f"bound march_cost{sfx} fast with sigmas: {b_['bound_bytes'] / 1e6:.2f} MB, "
              f"{b_['bound_ops'] / 1e9:.4f} Gop -> {b_['bound_ms']:.5f} ms ({b_['bound_by']}); kernel "
              f"{cost_res['fast_ms'][sfx]:.4f} ms, {b_['bound_ms'] / cost_res['fast_ms'][sfx]:.3f} of the "
              f"bound [{card}]")
    print(f"census (K13f on the main path's dynamic tape, frame 0): {dcensus}")
    print(f"census (voxelize, {P2V_N}^3, W {grid.W}): {p2v_c}, {touched} voxels touched")
    for k, b in bounds.items():
        kernels[k].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        kernels[k].setdefault("library_ms", None)
        print(f"bound {k}: {b['bound_bytes'] / 1e6:.2f} MB, {b['bound_ops'] / 1e9:.4f} Gop -> "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}); kernel {kernels[k]['ms']:.4f} ms, "
              f"{b['bound_ms'] / kernels[k]['ms']:.3f} of the bound [{card}]")

    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all, {build_s:.1f} s of it the build "
          f"[{card}]")

    # 7. Result lines
    # prev_ms: the width-1 instance's time in this run, in turns (K13c and
    # its frame axis: the scalar row; K13d and K13e, K2, K2+K4, K3 and K3+K4
    # and their pool instances: the earlier design; K9c and K9d: the scalar
    # instance, the earlier kernel's reads; construct_tree_aabb: the two
    # calls it replaces, construct_tree and points_leaf_aabb; tape_stage:
    # a recording by the count and record walks, in turns with one by the
    # walk and its copy), else null.
    # registers: ptxas's count for the width-4 plain SH9 instance of K3 and
    # K3+K4 (no rotation) and for the Kd-16 instance of K9c and K9d, else
    # null.
    # timer: what timed ``ms`` where phase 6 takes a kernel alone by the
    # profiler or, where its sessions record none of the kernel's launches,
    # by CUDA events behind a busy stream (the bake's kernels), else null.
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "prev_ms", "registers", "timer")
    for k, v in kernels.items():
        v.setdefault("prev_ms", None)
        v.setdefault("timer", None)
        unit = k if k.endswith("_bf16") else k + ".cu"
        v["registers"] = march_regs.get((unit, 4)) if k.startswith("render_bwd") else None
        if k.startswith(("mf_fwd", "mf_bwd")):
            aux_unit = "render_aux" + k[len("mf_fwd"):]
            v["registers"] = march_regs.get((aux_unit if aux_unit.endswith(("_bf16", "_i8")) else aux_unit + ".cu",
                                             k[:len("mf_fwd")]))
    print(card)
    print(json.dumps({"kernels": [dict(name=k, **{key: v[key] for key in keys})
                                  for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
