"""Designs of the forward march (K2) side by side, on one CUDA GPU.

    python3 tools/render_fwd_ab.py [--parent DIR]

`csrc/render_fwd.cuh`'s nearest loop at vector width 4 (the three-colour
RGBA, SH1 and SH9 rows) loads a sample's whole row in 16-byte loads; on the
bake with a float32 pool (`kLookAhead`) it starts sample k's loads (row,
rotation, weight cell), then sample k + 1's lookup, before sample k
composites. Width 1 runs the earlier loop; its instances named by `kWide`
(those that spill under ptxas's own register limit) launch with
`kWideBlocks` blocks an SM. This script compiles each design with nvcc,
every design a text patch of the header as it is, in a copy of the sources:

  * ``shipped``: the header as it is;
  * ``own_limit``: every width-1 instance under ptxas's own limit (`kWide`
    false), as before the redesign;
  * ``row_only``: width 4 with no lookup ahead;
  * ``pool_ahead``: the lookup ahead at width 4 on the bake for every pool
    type;
  * ``wide_1``, ``wide_5``: the `kWide` instances at 1 or 5 blocks an SM;
  * ``all_ahead``: the lookup ahead at width 4 on both structures;
  * ``ahead_only``: width 1 through the width-4 loop with the lookup ahead:
    the sample's sigma, rotation and weight cell, then the next lookup,
    then the coefficients where sigma passes;
  * ``all_wide``, ``all_wide_6``: every width-1 instance at one or at 6
    blocks an SM (`kWide` true);
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    header, whose C entry may have no width argument.

``earlier`` is the shipped library at width 1. A design measured earlier
and taken out, the next sample's row loaded into a second register row
(PERF.md), is not rebuilt here.

The designs up to ``wide_5`` and ``parent`` are built for every pool type
(float32, bf16, int8) and structure; the others only for the float32
pool's SH9 and SG9 instances (the entry's format switch cut). The script
prints each library's kernels, the registers of its SH9 and `kWide`
instances and every nearest instance that spills, then times in turns
(ROUNDS rounds, the order reversed every other round, the medians; CUDA
events over REPS launches), on both structures (the tree walk and the
bake):

  * the float32 designs at the two shapes K2's callers give it: (a) the
    depth-9 SH9 shell on the 800x800 orbit camera (640,000 rays, exact),
    without and with seeded per-voxel rotations (``deep``, ``deep_rot``);
    (b) bench.py's depth-7 headline shell at 800x800, fx 880, rays in pixel
    order, `step_size` 1e-3 (``headline``); and the width-1 designs on
    shape (a) with a seeded SG9 pool (``deep_sg``, ``deep_sg_rot``);
  * ``FAMILIES`` (format, basis, pool type, rotations, weights) on shape
    (a)'s structure and rays with the scene's SH9 pool or a seeded one:
    ``parent``, ``own_limit`` and ``shipped`` at width 1; where the row has
    one, ``shipped``, ``row_only`` and ``pool_ahead`` at width 4; for
    ``WIDE_FAMILIES`` ``wide_1`` and ``wide_5``.

The outputs of every design (and of ``parent``) are checked equal bit for
bit. Needs one CUDA GPU and nvcc.

    python3 tools/render_fwd_ab.py --interp [--parent DIR] [--designs A,B,...]

times K2+K4, the trilinear march (`render_fwd.cuh`'s interp instances, both
structures, every pool type), instead. Its designs, each a text patch of
the header:

  * ``no_lever``: the 9 lookups from the root, as before (`kCornerReuse`
    0);
  * ``lever1``: the own corner's row reused (lever 1), the other 7 corners
    looked up from the root (`kCornerReuse` 1);
  * ``levers12``: on the tree walk the corner descents started on the own
    path too (lever 2; `kCornerReuse` 2), on the bake lever 1;
  * ``shipped``: the header as it is (`kCornerReuse` by structure, format
    and width; at width 4 one pass over each corner's whole row, form (b));
  * ``form_a``: at width 4 the sigma column of every corner first, then
    the colour columns in vectors where sigma passes;
  * ``wide_interp``: the two width-4 instances that spill under ptxas's own
    limit (the tree walk's int8 SH9 with weights, the bake's bf16 SH9 with
    rotations and weights) at `kWideBlocks` blocks an SM (only their two
    compile units);
  * ``bound_4``, ``bound_5``: the interp instances launched with a bound
    of 4 or 5 blocks an SM;
  * ``parent``: that commit's header (its interp instances at width 1).

The bake's lever 2 (the own lookup's table entries reused by the corners
at the same index) lost 2% and is not rebuilt here (PERF.md). Each design
but ``form_a`` and ``wide_interp`` runs at width 1 (scalar rows) and,
for the three-colour rows, at width 4 (the row in 16-, 8- or 4-byte
loads); ``wide_interp`` only on the instances it changes.
``--designs`` builds and times only the named ones (and ``parent``).

It prints each library's interp kernels, the registers of their SH9
instances and every one that spills, then times the designs in turns
(as above) at phase 3e's and 4j's shapes: the depth-9 SH9 shell on the
800x800 orbit camera (640,000 rays), exact and fast, with and without
rotations and weights, on float32, bf16 and int8 pools, and the width-1
families (SH4, SH16, SG9, ASG25); outputs bit for bit against ``parent``
(or ``no_lever`` at width 1).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import render as render_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera, random_lobes  # noqa: E402
from svox_t_tpu_torch.utils.spec import FORMAT_ASG, FORMAT_SG, FORMAT_SH  # noqa: E402

ROUNDS = 6
REPS = 20

K2_UNITS = ("render_fwd", "render_fwd_baked", "render_fwd_bf16", "render_fwd_baked_bf16",
            "render_fwd_i8", "render_fwd_baked_i8")
INTERP_UNITS = ("render_fwd_interp", "render_fwd_baked_interp", "render_fwd_interp_bf16",
                "render_fwd_baked_interp_bf16", "render_fwd_interp_i8", "render_fwd_baked_interp_i8")
POOL_OF_UNIT = {u: "f32" for u in K2_UNITS[:2] + INTERP_UNITS[:2]}
POOL_OF_UNIT.update({u: u.rsplit("_", 1)[1] for u in K2_UNITS[2:] + INTERP_UNITS[2:]})
REUSE = re.compile(r"constexpr int kCornerReuse =.*?;\n", re.S)
LAUNCH_WIDE = "  if constexpr (W == 1 && !svox::kInterp && kWide<S, FMT, BD, kRot, kWeights>) {"
# `wide_interp`: the two width-4 interp instances that spill 24 bytes under
# ptxas's own limit launched as render_fwd_kernel_wide (kWideBlocks).
WIDE_INTERP = (LAUNCH_WIDE,
               "  if constexpr ((W == 1 && !svox::kInterp && kWide<S, FMT, BD, kRot, kWeights>) ||\n"
               "                (W == 4 && svox::kInterp && FMT == svox::kSH && BD == 9 && kWeights &&\n"
               "                 (S::kBaked ? std::is_same<svox::Pool, svox::PoolBF16>::value && kRot\n"
               "                            : std::is_same<svox::Pool, svox::PoolI8>::value && !kRot))) {")
# form (a): the colour pass of a width-4 interp sample over each corner's
# colour columns in vectors, after the sigma column's pass (interp_sum).
FORM_A_LOGITS = """// interp_logits of a three-colour row with no spare column, each corner's
// colour columns loaded in vectors (one row live at a time).
template <int FMT, int KB, int kD, class P>
__device__ __forceinline__ void interp_logits_row4(const svox::Corners& cn, const P features, int nb,
                                                   const float* basis, float* z) {
#pragma unroll
  for (int c = 0; c < 3; ++c) z[c] = 0.f;
#pragma unroll 1
  for (int n = 0; n < 8; ++n) {
    const int32_t row = cn.row[n];
    if (row < 0) continue;
    const auto f = features + static_cast<size_t>(row) * kD;
    float buf[kD];
#pragma unroll
    for (int e = 0; e < kD; e += 4) svox::load_row4(f, buf, e);
    const float w = cn.w[n];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = z[c] + w * svox::color_logit<FMT, KB, 4>(f, buf, c, nb, basis);
  }
}

"""
RAY_DOC = "// FMT: svox::kRGBA / kSH / kSG / kASG. BD: basis capacity"
FORM_A = (
    (RAY_DOC, FORM_A_LOGITS + RAY_DOC),
    ("      if constexpr (W == 4) {\n        if constexpr (FMT != svox::kRGBA && kRot) {\n          bool any",
     "      if constexpr (false) {\n        if constexpr (FMT != svox::kRGBA && kRot) {\n          bool any"),
    ("          svox::interp_logits<FMT, kB, kMaxColor>(cn, p.features, p.D, nc, nb, basis, z);\n        }\n",
     "          svox::interp_logits<FMT, kB, kMaxColor>(cn, p.features, p.D, nc, nb, basis, z);\n"
     "        } else {\n"
     "          if constexpr (FMT != svox::kRGBA && kRot) {\n"
     "            float m[9];\n"
     "            load_rot<true>(p.tmats, static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0, m);\n"
     "            rotated_basis<FMT, BD>(p, m, vx, vy, vz, nb, basis);\n"
     "          }\n"
     "          interp_logits_row4<FMT, kB, kD>(cn, p.features, nb, basis, z);\n"
     "        }\n"),
)
# The march kernel's launch bound (`bound_*`: only the interp units are
# built under those designs).
KERNEL_BOUND = "__global__ void __launch_bounds__(kThreads) render_fwd_kernel("
LOOK_AHEAD = "constexpr bool kLookAhead = S::kBaked && svox::kFloatPool;\n"
WIDE = re.compile(r"constexpr bool kWide =.*?;\n", re.S)
WIDE_BLOCKS = re.compile(r"constexpr int kWideBlocks = \d+;\n")
# The entry's format switch, cut to the SH9 and SG9 instances the float32
# designs time.
SWITCH = re.compile(r"  switch \(format\) \{\n    case svox::kRGBA:.*?\n  \}\n", re.S)
SH9_SG9 = ("  if (basis_dim != 9) return cudaErrorInvalidValue;\n"
           "  if (format == svox::kSG) return launch<S, svox::kSG, 9>(p, stream);\n"
           "  return format == svox::kSH ? launch<S, svox::kSH, 9>(p, stream) : cudaErrorInvalidValue;\n")
# `ahead_only`: width 1 through the width-4 loop with the lookup ahead,
# where the row is read a column at a time: sigma is loaded with the
# rotation (in scalars) and weight cell before the next lookup.
AHEAD_ONLY = (
    ("if constexpr (W == 1) {\n    // The earlier loop", "if constexpr (false) {\n    // The earlier loop"),
    (LOOK_AHEAD, "constexpr bool kLookAhead = true;\n"),
    ("      const auto row = p.features + static_cast<size_t>(idx) * kD;\n",
     "      const int D = W == 4 ? kD : p.D;\n      const auto row = p.features + static_cast<size_t>(idx) * D;\n"),
    ("        svox::load_row<kD>(p.features, idx, p.M, buf);\n",
     "        if constexpr (W == 4) svox::load_row<kD>(p.features, idx, p.M, buf);\n"
     "        else sigma = svox::ld(row + D - 1);\n"),
    ("load_rot<true>(p.tmats, idx, m);", "load_rot<W == 4>(p.tmats, idx, m);"),
    ("        sigma = svox::row_col<W>(row, buf, kD - 1);\n",
     "        if constexpr (W == 4) sigma = svox::row_col<W>(row, buf, kD - 1);\n"),
)
# {design: (text patches of render_fwd.cuh, compile units)}.
DESIGNS = {
    "shipped": ((), K2_UNITS),
    "own_limit": (((WIDE, "constexpr bool kWide = false;\n"),), K2_UNITS),
    "row_only": (((LOOK_AHEAD, "constexpr bool kLookAhead = false;\n"),), K2_UNITS),
    "pool_ahead": (((LOOK_AHEAD, "constexpr bool kLookAhead = S::kBaked;\n"),), K2_UNITS),
    "wide_1": (((WIDE_BLOCKS, "constexpr int kWideBlocks = 1;\n"),), K2_UNITS),
    "wide_5": (((WIDE_BLOCKS, "constexpr int kWideBlocks = 5;\n"),), K2_UNITS),
    "all_ahead": (((SWITCH, SH9_SG9), (LOOK_AHEAD, "constexpr bool kLookAhead = true;\n")), K2_UNITS[:2]),
    "ahead_only": (((SWITCH, SH9_SG9), *AHEAD_ONLY), K2_UNITS[:2]),
    "all_wide": (((SWITCH, SH9_SG9), (WIDE, "constexpr bool kWide = true;\n"),
                  (WIDE_BLOCKS, "constexpr int kWideBlocks = 1;\n")), K2_UNITS[:2]),
    "all_wide_6": (((SWITCH, SH9_SG9), (WIDE, "constexpr bool kWide = true;\n"),
                    (WIDE_BLOCKS, "constexpr int kWideBlocks = 6;\n")), K2_UNITS[:2]),
}
# K2+K4's designs (--interp): {design: text patches of render_fwd.cuh}; a
# design whose patch leaves the header as it is shares the shipped library.
INTERP_DESIGNS = {
    "shipped": ((), INTERP_UNITS),
    "no_lever": (((REUSE, "constexpr int kCornerReuse = 0;\n"),), INTERP_UNITS),
    "lever1": (((REUSE, "constexpr int kCornerReuse = 1;\n"),), INTERP_UNITS),
    "levers12": (((REUSE, "constexpr int kCornerReuse = S::kBaked ? 1 : 2;\n"),), INTERP_UNITS),
    "form_a": (FORM_A, INTERP_UNITS),
    "wide_interp": ((WIDE_INTERP,), ("render_fwd_interp_i8", "render_fwd_baked_interp_bf16")),
    "bound_4": (((KERNEL_BOUND, KERNEL_BOUND.replace("(kThreads)", "(kThreads, 4)")),), INTERP_UNITS),
    "bound_5": (((KERNEL_BOUND, KERNEL_BOUND.replace("(kThreads)", "(kThreads, 5)")),), INTERP_UNITS),
}
# The (case label, structure) on which wide_interp changes an instance.
WIDE_INTERP_CASES = {("SH9 int8 weights", "tree"), ("SH9 bf16 rot weights", "baked")}
# (label, format, basis, pool type, rotations, weights, fast) of the interp
# cases: the SH9 main path's rows (phase 3e, 4j, 4k) and the width-1
# families.
INTERP_CASES = (
    ("SH9", FORMAT_SH, 9, "f32", False, False, False),
    ("SH9 fast", FORMAT_SH, 9, "f32", False, False, True),
    ("SH9 rot", FORMAT_SH, 9, "f32", True, False, False),
    ("SH9 weights", FORMAT_SH, 9, "f32", False, True, False),
    ("SH9 rot weights", FORMAT_SH, 9, "f32", True, True, False),
    ("SH9 bf16", FORMAT_SH, 9, "bf16", False, False, False),
    ("SH9 bf16 rot", FORMAT_SH, 9, "bf16", True, False, False),
    ("SH9 int8", FORMAT_SH, 9, "i8", False, False, False),
    ("SH9 int8 rot", FORMAT_SH, 9, "i8", True, False, False),
    ("SH9 int8 weights", FORMAT_SH, 9, "i8", False, True, False),
    ("SH9 bf16 rot weights", FORMAT_SH, 9, "bf16", True, True, False),
    ("SH4", FORMAT_SH, 4, "f32", False, False, False),
    ("SH4 int8", FORMAT_SH, 4, "i8", False, False, False),
    ("SH16", FORMAT_SH, 16, "f32", False, False, False),
    ("SG9", FORMAT_SG, 9, "f32", False, False, False),
    ("SG9 rot weights", FORMAT_SG, 9, "f32", True, True, False),
    ("SG9 bf16", FORMAT_SG, 9, "bf16", False, False, False),
    ("ASG25", FORMAT_ASG, 25, "f32", False, False, False),
)
# (design, library, width) of each timed run of the float32 designs: every
# design on the SH9 shapes, the width-1 ones on the SG9 pool.
RUNS = (("shipped", "shipped", 4), ("all_ahead", "all_ahead", 4), ("row_only", "row_only", 4),
        ("earlier", "shipped", 1), ("ahead_only", "ahead_only", 1), ("all_wide", "all_wide", 1),
        ("all_wide_6", "all_wide_6", 1))
RUNS_W1 = RUNS[3:]
# (label, format, basis_dim, pool type, rotations, weights): the SH9 rows of
# the serving paths on every pool type, and a member of each width-1 family
# that `kWide` names or that keeps the limit.
FAMILIES = (
    ("SH9", FORMAT_SH, 9, "f32", False, False),
    ("SH9 bf16", FORMAT_SH, 9, "bf16", False, False),
    ("SH9 int8", FORMAT_SH, 9, "i8", False, False),
    ("SH9 rot", FORMAT_SH, 9, "f32", True, False),
    ("SH9 rot weights", FORMAT_SH, 9, "f32", True, True),
    ("SH9 bf16 rot", FORMAT_SH, 9, "bf16", True, False),
    ("SH9 int8 rot", FORMAT_SH, 9, "i8", True, False),
    ("SH4", FORMAT_SH, 4, "f32", False, False),
    ("SH4 int8", FORMAT_SH, 4, "i8", False, False),
    ("SH16", FORMAT_SH, 16, "f32", False, False),
    ("SG9", FORMAT_SG, 9, "f32", False, False),
    ("SG9 rot weights", FORMAT_SG, 9, "f32", True, True),
    ("SG1 rot", FORMAT_SG, 1, "f32", True, False),
    ("SG16", FORMAT_SG, 16, "f32", False, False),
    ("ASG25", FORMAT_ASG, 25, "f32", False, False),
    ("SG9 int8", FORMAT_SG, 9, "i8", False, False),
    ("ASG1 rot", FORMAT_ASG, 1, "f32", True, False),
    ("SH9 bf16 weights", FORMAT_SH, 9, "bf16", False, True),
    ("SH16 int8 weights", FORMAT_SH, 16, "i8", False, True),
)
# The families with an instance that `kWide` names, timed also under the
# `wide_*` designs.
WIDE_FAMILIES = ("SG1 rot", "ASG1 rot", "SH4 int8", "SH9 bf16 weights", "SH16 int8 weights")
FMT_NAME = {FORMAT_SH: "SH", FORMAT_SG: "SG", FORMAT_ASG: "ASG"}
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PTXAS_USED = re.compile(r"Used (\d+) registers")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# K2's kernel instances: structure, format, basis capacity, rotation,
# weights and width (none before the redesign).
K2_INSTANCE = re.compile(
    r"render_fwd_kernel(?:_wide)?IN4svox\d+(TreeWalk|Baked)ELi(\d+)ELi(\d+)ELb([01])ELb([01])E(?:Li(\d+)E)?")


def design_sources(workdir: Path, parent: Path | None, designs: dict, parent_units=K2_UNITS,
                   header: str = "render_fwd.cuh") -> tuple:
    """({library: (its csrc directory, its compile units)}, {design: the
    library it shares}): each design's sources copied to ``workdir`` and its
    ``header`` patched (a design whose patches leave the shipped header as it
    is shares the shipped library), and the parent's sources as they are.
    ``designs``: {design: (patches, units)}."""
    src = (_build.CSRC / header).read_text()
    out, alias = {}, {}
    for name, (patches, units) in designs.items():
        text = src
        for old, new in patches:
            n = len(old.findall(text)) if isinstance(old, re.Pattern) else text.count(old)
            if n != 1:
                raise RuntimeError(f"{header} changed: design {name}'s patch no longer applies")
            text = old.sub(new, text) if isinstance(old, re.Pattern) else text.replace(old, new)
        if name != "shipped" and text == src and "shipped" in designs:
            alias[name] = "shipped"
            continue
        d = workdir / name
        d.mkdir()
        for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        (d / header).write_text(text)
        out[name] = (d, units)
    if parent is not None:
        out["parent"] = (parent / "svox_t_tpu_torch" / "csrc", parent_units)
    return out, alias


def compile_libraries(workdir: Path, sources: dict, report_rows=None) -> dict:
    """{library: path}: every unit of every library compiled at once, one
    nvcc each, then one link a library; prints the kernels, the SH9
    instances' registers and each spilling nearest instance (``report_rows``
    instead of `report`: another header's kernels)."""
    nvcc = _build._nvcc()
    jobs = []
    for name, (csrc, names) in sources.items():
        for unit in _build.units(csrc):
            if unit.name in names:
                jobs.append((name, unit))

    def compile_unit(job):
        name, unit = job
        obj = workdir / f"{name}.{unit.name}.o"
        cmd = [nvcc, *_build._flags(unit), "-c", "-o", str(obj),
               *_build.source_args(unit, workdir / f"{name}.{unit.name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} {unit.name} failed:\n{proc.stdout}\n{proc.stderr}")
        return obj, proc.stdout + proc.stderr, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        done = list(pool.map(compile_unit, jobs))
    print(f"nvcc: {len(jobs)} compiles in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name in sources:
        objs = [str(o) for (n, _), (o, _, _) in zip(jobs, done) if n == name]
        lib = workdir / f"lib{name}.so"
        proc = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib), *objs],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link {name} failed:\n{proc.stdout}\n{proc.stderr}")
        libs[name] = lib
        rows = []
        for (n, unit), (_, log, _) in zip(jobs, done):
            if n == name:
                rows += [(unit.name, *r) for r in ptxas_rows(log)]
        (report_rows or report)(name, rows)
    return libs


def ptxas_rows(log: str) -> list:
    """[(entry, registers, bytes spilled)] of a compile's ptxas log."""
    entry, spill, rows = None, 0, []
    for line in log.splitlines():
        if (m := PTXAS_ENTRY.search(line)):
            entry = m.group(1)
        elif (m := PTXAS_SPILL.search(line)):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := PTXAS_USED.search(line)) and entry is not None:
            rows.append((entry, int(m.group(1)), spill))
            entry, spill = None, 0
    return rows


def instance_name(unit: str, m: re.Match) -> str:
    """A K2 instance as ``<structure> <pool> <format><basis> [rot] [weights]
    width <w> [one block an SM]``."""
    structure, fmt, bd, rot, weights, width = m.groups()
    fmt = {"0": "RGBA", "1": "SH", "2": "SG", "3": "ASG"}[fmt]
    width = width or "1"
    return (f"{structure}{' interp' if '_interp' in unit else ''} {POOL_OF_UNIT[unit]} "
            f"{fmt}{bd if fmt != 'RGBA' else ''}{' rot' if rot == '1' else ''}"
            f"{' weights' if weights == '1' else ''} width {width}{' wide' if '_wide' in m.group(0) else ''}")


def report(name: str, rows: list) -> None:
    k2 = [(unit, r, s, m) for unit, e, r, s in rows for m in [K2_INSTANCE.search(e)] if m]
    sh9 = [f"{instance_name(u, m)} {r} regs ({cs.blocks_per_sm(r)} blocks/SM)" for u, r, s, m in k2
           if m.group(2) == "1" and m.group(3) == "9" and m.group(5) == "0"]
    spills = [f"{instance_name(u, m)} {r} regs {s} B" for u, r, s, m in k2 if s]
    wide = [f"{instance_name(u, m)} {r} regs" for u, r, s, m in k2 if "_wide" in m.group(0)]
    print(f"ptxas {name}: {len(k2)} K2 kernels, {sum(s for *_, s, _ in k2)} bytes spilled in all")
    print(f"  SH9: {'; '.join(sh9)}")
    print(f"  spilling ({len(spills)}): {'; '.join(spills) if spills else 'none'}")
    if wide:
        print(f"  wide ({len(wide)}): {'; '.join(wide)}")


def load_entries(libs: dict, parent_has_width: bool) -> dict:
    """{(library, structure suffix + pool suffix): (C entry, has width)}:
    ``parent_has_width`` says whether the parent's entry takes a width."""
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for pool_sfx in ("", "_bf16", "_i8"):
            for sfx in ("", "_baked", "_interp", "_baked_interp"):
                fn = getattr(lib, f"svox_render_fwd{sfx}{pool_sfx}", None)
                if fn is None:
                    continue
                has_width = name != "parent" or parent_has_width
                fn.argtypes = (render_ops._FWD_ARGS if has_width
                               else render_ops._FWD_ARGS[:-3] + render_ops._FWD_ARGS[-2:])
                fn.restype = ctypes.c_int
                fns[name, sfx + pool_sfx] = (fn, has_width)
    return fns


def seeded_device_pool(M: int, D: int, seed: int, dev) -> torch.Tensor:
    """A pool like `chip_smoke.seeded_pool`'s, drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(M, D, generator=g, device=dev) * 0.3
    f[:, -1] = torch.randn(M, generator=g, device=dev).abs() * 30.0 + 10.0
    return f


def as_pool(kind: str, feats: torch.Tensor):
    if kind == "bf16":
        return feats.to(torch.bfloat16)
    if kind == "i8":
        return stt.quantize_features(feats)
    return feats


def scenes(dev) -> tuple:
    """(shapes, families): shapes {shape: {structure: (spec, pool, origins,
    dirs, options)}} of the float32 designs: (a) the deep shell on the
    orbit camera, without (``deep``) and with (``deep_rot``) rotations, and
    with a seeded SG9 pool (``deep_sg``, ``deep_sg_rot``); (b) bench.py's
    headline shell (``headline``); families {label: {structure: (...)}} of
    `FAMILIES` on shape (a)'s structure and rays."""
    out = {}
    state, feats_np, _ = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    M = feats.shape[0]
    opt = stt.VolumeRenderer(tree)._get_options(False)
    o, d = cs.camera_rays(dev)
    rot = cs.random_rotations(M, np.random.RandomState(0), dev)
    base = {"tree": tree._spec(), "baked": tree._baked_spec()}
    spin = {k: s.with_(transformation_matrices=rot) for k, s in base.items()}
    out["deep"] = {k: (s, feats, o, d, opt) for k, s in base.items()}
    out["deep_rot"] = {k: (s, feats, o, d, opt) for k, s in spin.items()}
    lobes = {f: torch.from_numpy(random_lobes(FMT_NAME[f], 25, seed=1)).to(dev) for f in (FORMAT_SG, FORMAT_ASG)}
    sg_opt = dataclasses.replace(opt, format=FORMAT_SG, basis_dim=9)
    sg_pool = seeded_device_pool(M, 28, 2, dev)
    for shape, specs in (("deep_sg", base), ("deep_sg_rot", spin)):
        out[shape] = {k: (s.with_(extra_data=lobes[FORMAT_SG][:9].contiguous()), sg_pool, o, d, sg_opt)
                      for k, s in specs.items()}
    state7, f7_np = build_shell_tree(depth=7, data_format="SH9", data_dim=28)[:2]
    t7 = stt.tree_from_numpy(state7, device=dev)
    f7 = torch.from_numpy(f7_np).to(dev)
    opt7 = stt.VolumeRenderer(t7, step_size=1e-3)._get_options(False)
    o7, d7 = render_ops.cam2world_rays(torch.as_tensor(orbit_camera(), device=dev), cs.WIDTH, cs.HEIGHT,
                                       cs.BENCH_FX, cs.BENCH_FX)
    o7, d7 = o7.contiguous(), d7.contiguous()
    out["headline"] = {"tree": (t7._spec(), f7, o7, d7, opt7), "baked": (t7._baked_spec(), f7, o7, d7, opt7)}
    fam = {}
    for i, (label, fmt, bd, kind, has_rot, _) in enumerate(FAMILIES):
        D = 3 * bd + 1
        pool = as_pool(kind, feats if D == 28 and fmt == FORMAT_SH else seeded_device_pool(M, D, 10 + i, dev))
        f_opt = dataclasses.replace(opt, format=fmt, basis_dim=bd)
        specs = spin if has_rot else base
        ex = lobes[fmt][:bd].contiguous() if fmt in lobes else None
        fam[label] = {k: (s.with_(extra_data=ex) if ex is not None else s, pool, o, d, f_opt)
                      for k, s in specs.items()}
    return out, fam


def interp_scenes(dev) -> dict:
    """{label: {structure: (spec, pool, origins, dirs, options)}} of
    `INTERP_CASES` (K2+K4): the depth-9 SH9 shell on the 800x800 orbit
    camera, with its SH9 pool or a seeded one, seeded rotations and lobes."""
    state, feats_np, _ = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    M = feats.shape[0]
    rend = stt.VolumeRenderer(tree, interp="trilinear")
    o, d = cs.camera_rays(dev)
    rot = cs.random_rotations(M, np.random.RandomState(0), dev)
    base = {"tree": tree._spec(), "baked": tree._baked_spec()}
    spin = {k: s.with_(transformation_matrices=rot) for k, s in base.items()}
    lobes = {f: torch.from_numpy(random_lobes(FMT_NAME[f], 25, seed=1)).to(dev) for f in (FORMAT_SG, FORMAT_ASG)}
    out = {}
    for i, (label, fmt, bd, kind, has_rot, _, fast) in enumerate(INTERP_CASES):
        D = 3 * bd + 1
        pool = as_pool(kind, feats if D == 28 and fmt == FORMAT_SH else seeded_device_pool(M, D, 10 + i, dev))
        opt = dataclasses.replace(rend._get_options(fast), format=fmt, basis_dim=bd)
        ex = lobes[fmt][:bd].contiguous() if fmt in lobes else None
        out[label] = {k: (s.with_(extra_data=ex) if ex is not None else s, pool, o, d, opt)
                      for k, s in (spin if has_rot else base).items()}
    return out


def time_interp(cases: dict, in_turns, with_parent: bool, designs, card: str) -> None:
    """K2+K4's ``designs`` in turns on ``cases`` (`interp_scenes`), outputs
    bit for bit against the first run (``parent`` where given)."""
    runs = {}
    w1 = [d for d in ("no_lever", "lever1", "levers12", "bound_4", "bound_5", "shipped") if d in designs]
    w4 = [d for d in ("no_lever", "lever1", "levers12", "form_a", "bound_4", "bound_5", "shipped") if d in designs]
    for label, fmt, bd, *_ in INTERP_CASES:
        vec = render_ops._vector_row(fmt, bd, 3 * bd + 1)
        for st_ in ("baked", "tree"):
            r = (("parent", "parent", 1),) if with_parent else ()
            r += tuple((f"{d}_w1", d, 1) for d in w1)
            if vec:
                r += tuple((f"{d}_w4", d, 4) for d in w4)
                if "wide_interp" in designs and (label, st_) in WIDE_INTERP_CASES:
                    r += (("wide_interp_w4", "wide_interp", 4),)
            runs[label, st_] = r
    keys, times = in_turns(cases, runs, {c[0]: c[5] for c in INTERP_CASES})
    ref = "parent" if with_parent else runs[keys[0]][0][0]
    print(f"K2+K4 designs in turns, {ROUNDS} rounds, outputs equal bit for bit to {ref}; CUDA events over {REPS} "
          f"launches; depth-{cs.DEPTH} SH9 shell {cs.WIDTH}x{cs.HEIGHT} fx {cs.FX}, the scene's SH9 pool or a "
          f"seeded one [{card}]")
    res = {}
    for k in keys:
        base = statistics.median(times[ref, k])
        for run in runs[k]:
            v = times[run[0], k]
            med = statistics.median(v)
            res[f"{run[0]}_{k[0].replace(' ', '_')}_{k[1]}_ms"] = med
            print(f"  {k[0]:16s} {k[1]:6s} {run[0]:12s} width {run[2]}: median {med:.4f} ms "
                  f"({base / med:.3f}x {ref}), rounds {[round(x, 4) for x in v]}")
    print(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K2 is timed beside this one's")
    ap.add_argument("--interp", action="store_true",
                    help="time K2+K4's designs (the trilinear march) instead of the nearest march's")
    ap.add_argument("--designs", default=None,
                    help="with --interp: a comma-separated subset of the designs to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("render_fwd_ab.py needs a CUDA GPU")
    parent_has_width = args.parent is not None and "int width, int device" in (
        args.parent / "svox_t_tpu_torch" / "csrc" / "render_fwd.cuh").read_text()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if args.interp:
            chosen = args.designs.split(",") if args.designs else list(INTERP_DESIGNS)
            unknown = set(chosen) - set(INTERP_DESIGNS)
            if unknown:
                raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(INTERP_DESIGNS)}")
            designs = {k: v for k, v in INTERP_DESIGNS.items() if k in chosen}
            sources, alias = design_sources(Path(tmp), args.parent, designs, INTERP_UNITS)
        else:
            sources, alias = design_sources(Path(tmp), args.parent, DESIGNS)
        libs = compile_libraries(Path(tmp), sources)
        libs.update({a: libs[t] for a, t in alias.items()})
        fns = load_entries(libs, parent_has_width)
        print(f"builds: {time.perf_counter() - t0:.1f} s" + "".join(
            f"; {a} is the {t} library" for a, t in alias.items()))
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs, waccs = {}, []

        def call(cases, run, key, weights=False):
            design, lib, width = run
            shape, structure = key
            spec, pool, o, d, opt = cases[shape][structure]
            a, n_color = render_ops._kernel_args(spec, pool, o, d, d, opt, "render_fwd_ab")
            out = torch.empty(o.shape[0], n_color + 1, device=dev)
            wacc = torch.zeros(render_ops._n_tree_cells(spec), device=dev) if weights else None
            waccs.append(wacc)  # held for the launches, which write it
            kind = "f32" if isinstance(pool, torch.Tensor) and pool.dtype == torch.float32 else (
                "bf16" if isinstance(pool, torch.Tensor) else "i8")
            isfx = "_interp" if opt.interp else ""
            fn, has_width = fns[lib, cs.SUFFIX[structure] + isfx + render_ops.POOL_SUFFIX[kind]]
            if width is None:  # the parent's own choice
                width = render_ops._fwd_width(spec, pool, opt)
            tail = (width, dev.index, stream) if has_width else (dev.index, stream)
            w_ptr = None if wacc is None else wacc.data_ptr()

            def launch():
                err = fn(*a, opt.sigma_thresh, opt.stop_thresh, opt.max_steps, out.data_ptr(), w_ptr, *tail)
                if err:
                    raise RuntimeError(f"{design} {shape} {structure}: CUDA error {err}")
            outs[design, shape, structure] = out
            return launch

        def in_turns(cases, runs, weights=None):
            keys = [(s, st_) for s in cases for st_ in ("baked", "tree")]
            times = {(run[0], k): [] for k in keys for run in runs[k]}
            launches = {(run[0], k): call(cases, run, k, bool(weights and weights[k[0]])) for k in keys
                        for run in runs[k]}
            for i in range(ROUNDS):
                for k in keys:
                    for run in runs[k] if i % 2 == 0 else runs[k][::-1]:
                        times[run[0], k].append(cs.time_ms(launches[run[0], k], REPS))
            for k in keys:
                ref = outs[(runs[k][0][0], *k)]
                for ck in [(run[0], *k) for run in runs[k][1:]]:
                    if not torch.equal(outs[ck], ref):
                        raise AssertionError(f"{k}: {ck[0]} differs from {runs[k][0][0]}")
            return keys, times

        if args.interp:
            time_interp(interp_scenes(dev), in_turns, args.parent is not None, designs, card)
            return
        shapes, families = scenes(dev)
        res = {}
        parent_run = (("parent", "parent", None),) if args.parent is not None else ()
        runs = {(s, st_): (RUNS_W1 if s.startswith("deep_sg") else RUNS) + parent_run
                for s in shapes for st_ in ("baked", "tree")}
        keys, times = in_turns(shapes, runs)
        print(f"K2 float32 designs in turns, {ROUNDS} rounds, outputs equal bit for bit; CUDA events over "
              f"{REPS} launches; (a) depth-{cs.DEPTH} shell {cs.WIDTH}x{cs.HEIGHT} fx {cs.FX} (deep, deep_rot, and "
              f"the width-1 designs on an SG9 pool, deep_sg, deep_sg_rot), (b) depth-7 headline shell fx "
              f"{cs.BENCH_FX}, pixel order (headline) [{card}]")
        for k in keys:
            base = statistics.median(times["earlier", k])
            for run in runs[k]:
                v = times[run[0], k]
                med = statistics.median(v)
                res[f"{run[0]}_{k[0]}_{k[1]}_ms"] = med
                print(f"  {k[0]:11s} {k[1]:6s} {run[0]:10s} width {run[2] or '-'}: median {med:.4f} ms "
                      f"({base / med:.3f}x the earlier loop), rounds {[round(x, 4) for x in v]}")

        fam_runs = {}
        for label, fmt, bd, kind, _, _ in FAMILIES:
            vec = render_ops._vector_row(fmt, bd, 3 * bd + 1)
            r = parent_run + (("own_limit", "own_limit", 1), ("shipped_w1", "shipped", 1))
            if vec:
                r += (("shipped", "shipped", 4), ("row_only", "row_only", 4), ("pool_ahead", "pool_ahead", 4))
            if label in WIDE_FAMILIES:
                r += (("wide_1", "wide_1", 1), ("wide_5", "wide_5", 1))
            for st_ in ("baked", "tree"):
                fam_runs[label, st_] = r
        weights = {f[0]: f[5] for f in FAMILIES}
        keys, times = in_turns(families, fam_runs, weights)
        print(f"K2 families in turns, {ROUNDS} rounds, outputs equal bit for bit; CUDA events over {REPS} "
              f"launches; shape (a)'s structure and rays, the scene's SH9 pool or a seeded one [{card}]")
        for k in keys:
            ref = "parent" if args.parent is not None else "own_limit"
            base = statistics.median(times[ref, k])
            for run in fam_runs[k]:
                v = times[run[0], k]
                med = statistics.median(v)
                res[f"{run[0]}_{k[0].replace(' ', '_')}_{k[1]}_ms"] = med
                print(f"  {k[0]:16s} {k[1]:6s} {run[0]:10s} width {run[2] or '-'}: median {med:.4f} ms "
                      f"({base / med:.3f}x {ref}), rounds {[round(x, 4) for x in v]}")
        print(json.dumps(res))


if __name__ == "__main__":
    main()
