"""What K9d's adds meet: a plain walk of the motion-feature VJP's march.

`mf_census` walks the rays as `render_aux.motion_feature_backward_plain`
does (the backward's rules: samples while ``t < tmax``, the gate
``sigma > 0``, no early stop; under interp a contributing sample also needs
a row < M) and sums the same addends, ``sw_n * ((weight * s) * (1 - s)) *
g`` for each contributing sample and bone with ``sw_n > 0``, in float64. It
counts, besides:

  * ``contrib``: contributing samples; ``adds``: (sample, bone) pairs with
    ``sw > 0``, each Kd adds in the kernel;
  * per hit ray, the runs of consecutive contributing samples that share
    their row (``runs_row``) and their joint-index row (``runs_ji``), and
    ``adds_merged_ji``: the (run, bone) pairs of the joint-index runs whose
    bone has ``sw > 0`` in some sample of the run — the adds left if a ray
    held its addends in registers while its joint-index row repeats;
  * per warp of 32 consecutive rays and step (the kernel's warps march
    their lanes in step): ``warp_steps``, the warp-steps with a contributing
    lane; ``lanes``, their contributing lanes; and per bone of such a
    warp-step with an add, ``bone_steps``, ``bone_lanes`` (its adding lanes),
    ``bone_joints`` (the distinct joints they add into) and ``bone_peak``
    (the lanes on its most shared joint), summed.

`tools/mf_ab.py`'s ``owned`` design would cost about ``lanes`` rounds a
warp; the kernel issues ``Kd`` shared atomics a bone, whose lanes
serialize on a shared joint (``bone_peak``). Returns (the (J, Kd)
gradient in the joint table's float type, {count: int}). A diagnostic of
`tools/mf_ab.py`, not part of the package.
"""

from __future__ import annotations

import torch

from svox_t_tpu_torch.ops.render import _ray_setup, _sigmoid
from svox_t_tpu_torch.ops.render_aux import (_blend, _check, _check_mf_grad, _float_table, _lbs_tables,
                                             _sample)
from svox_t_tpu_torch.utils.spec import RenderOptions, TreeSpec

WARP = 32
COUNTS = ("contrib", "adds", "runs_row", "runs_ji", "adds_merged_ji", "warp_steps", "lanes",
          "bone_steps", "bone_lanes", "bone_joints", "bone_peak")


def _warp_joints(joints: torch.Tensor) -> tuple:
    """For (W, 32) joint ids (-1: no add), per warp with an add: the adding
    lanes, the distinct joints and the lanes on the most shared joint,
    summed; and the number of such warps."""
    busy = (joints >= 0).any(1)
    if not bool(busy.any()):
        return 0, 0, 0, 0
    j = joints[busy]
    per = torch.zeros(j.shape[0], int(j.max()) + 2, dtype=torch.long, device=j.device)
    per.scatter_add_(1, (j + 1).long(), (j >= 0).long())
    per = per[:, 1:]  # column 0 took the lanes with no add
    return int(busy.sum()), int(per.sum()), int((per > 0).sum()), int(per.max(1).values.sum())


def mf_census(spec: TreeSpec, joint_features: torch.Tensor, features: torch.Tensor,
              origins: torch.Tensor, dirs: torch.Tensor, grad_out: torch.Tensor,
              opt: RenderOptions) -> tuple:
    """(gradient, counts) of K9d's march on these rays (module doc)."""
    _check(spec, features, origins, dirs, opt)
    sw, ji = _lbs_tables(spec, joint_features, features)
    _check_mf_grad(joint_features, origins, grad_out)
    J = joint_features.shape[0]
    nb = sw.shape[1]
    c = dict.fromkeys(COUNTS, 0)
    grad = torch.zeros_like(joint_features, dtype=torch.float64)
    out_dtype = _float_table(joint_features).dtype
    B = origins.shape[0]
    if features.shape[0] == 0 or B == 0:
        return grad.to(out_dtype), c
    rays = _ray_setup(spec, origins, dirs, opt, cube_hit=True)
    delta_scale, tmin, tmax, hit = rays[3:]
    dev = origins.device
    t = tmin
    L = torch.ones_like(tmin)
    has_prev = torch.zeros(B, dtype=torch.bool, device=dev)
    prev_row = torch.zeros(B, dtype=torch.long, device=dev)
    prev_ji = torch.zeros(B, nb, dtype=ji.dtype, device=dev)
    run_pos = torch.zeros(B, nb, dtype=torch.bool, device=dev)
    pad = (-B) % WARP
    for _ in range(opt.max_steps):
        active = hit & (t < tmax)
        if not bool(active.any()):
            break
        s = _sample(spec, features, opt, rays, t)
        gate = active & (s.sigma > 0.0)
        contrib = gate & s.resident
        att = torch.exp(-s.dt * delta_scale * s.sigma)
        weight = L * (1.0 - att)
        sw_r, ji_r = sw[s.rows], ji[s.rows]
        col = _sigmoid(_blend(sw_r, ji_r, joint_features, contrib))
        gb = ((weight[:, None] * col) * (1.0 - col)) * grad_out
        pos = contrib[:, None] & (sw_r > 0)
        for n in range(nb):
            ok = pos[:, n]
            grad.index_add_(0, ji_r[ok, n].clamp(0, J - 1).long(), (sw_r[ok, n, None] * gb[ok]).double())
        # Runs of consecutive contributing samples with the same row and
        # the same joint-index row.
        same_row = has_prev & (prev_row == s.rows)
        same_ji = has_prev & (prev_ji == ji_r).all(1)
        c["contrib"] += int(contrib.sum())
        c["adds"] += int(pos.sum())
        c["runs_row"] += int((contrib & ~same_row).sum())
        new_ji = contrib & ~same_ji
        c["runs_ji"] += int(new_ji.sum())
        c["adds_merged_ji"] += int(run_pos[new_ji & has_prev].sum())
        run_pos = torch.where(new_ji[:, None], pos, run_pos | pos)
        has_prev = has_prev | contrib
        prev_row = torch.where(contrib, s.rows, prev_row)
        prev_ji = torch.where(contrib[:, None], ji_r, prev_ji)
        # The warps of 32 consecutive rays at this step.
        lanes = torch.cat([contrib, contrib.new_zeros(pad)]).view(-1, WARP)
        busy = lanes.any(1)
        c["warp_steps"] += int(busy.sum())
        c["lanes"] += int(lanes.sum())
        joints = torch.where(pos, ji_r.clamp(0, J - 1).long(), -1)
        for n in range(nb):
            w_n = torch.cat([joints[:, n], joints.new_full((pad,), -1)]).view(-1, WARP)
            steps, adding, distinct, peak = _warp_joints(w_n)
            c["bone_steps"] += steps
            c["bone_lanes"] += adding
            c["bone_joints"] += distinct
            c["bone_peak"] += peak
        L = torch.where(gate, L * att, L)
        t = torch.where(active, t + s.dt, t)
    c["adds_merged_ji"] += int(run_pos[has_prev].sum())
    return grad.to(out_dtype), c
