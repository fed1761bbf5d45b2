"""Designs of the backward march (K3 and K3+K4) side by side, on one CUDA GPU.

    python3 tools/render_bwd_ab.py [--parent DIR] [--designs A,B,...] [--families]
    python3 tools/render_bwd_ab.py --opacity [--parent DIR] [--designs A,B,...]

`csrc/render_bwd.cuh` at vector width 4 (the three-colour RGBA, SH1 and SH9
rows with no spare column) moves a sample's row in 16-byte loads and adds it
with vector float atomics; under interp it finds the corners from the
sample's own lookup, reads the corners' rows in one pass and adds w_n * G
into each. Width 1 is the earlier loop. This script compiles each design
with nvcc, every design a text patch of the header as it is, in a copy of
the sources (the eight `render_bwd*` compile units: both structures,
nearest and interp, float32 and bf16 pools):

  * ``shipped``: the header as it is;
  * ``pass1_scalars``: pass 1 of the two-pass mode adds the coefficient
    columns as 6 vectors and 3 scalars at SH9 (3 scalars at D = 4) instead of
    7 vectors with a 0 in the sigma lane;
  * ``lever1``: the tree walk's interp corners with the own corner's row
    reused and the other 7 looked up from the root (`kCornerReuse4` 1);
  * ``bound_6``, ``bound_8``: the kernel launched with a bound of 6 or 8
    blocks of 128 an SM;
  * ``match``: the lanes of a warp that add into the same row at once
    (`__match_any_sync`) sum their addends with shuffles, and one of them
    adds the sum (float32 units only);
  * ``no_adds``: a diagnostic, width 4 with no adds (the lookups and the
    row reads that sigma and L need; float32 units only), its gradient not
    checked;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    header, whose C entry may take no width (its kernel is then the earlier
    loop alone).

``--designs`` builds and times only the named ones (and ``parent``). It
prints each library's K3 kernels, the registers and spills of its SH9 and
RGBA instances by width, and every instance that spills. Then it times in
turns (ROUNDS rounds, the order reversed every other round, the medians;
CUDA events over REPS calls, each call zeroing the float32 (M, D) gradient
and launching, as the wrapper does), on both structures (the tree walk and
the bake):

  * ``CASES``: (a) the depth-9 SH9 shell on the 800x800 orbit camera
    (640,000 rays), exact single pass, with and without seeded per-voxel
    rotations, float32 and bf16 pools, nearest and interp; (b) the same in
    fast mode (two passes); (c) nearest, bench.py's depth-7 headline shell
    at 800x800, fx 880, rays in pixel order, step 1e-3 (the ``fwd_bwd_*``
    shape): ``parent``, ``shipped`` at width 1 (``w1``) and each design at
    width 4;
  * with ``--families``, the rows that keep width 1 (SH4, SH16, SG9, ASG25
    on seeded pools; nearest and interp) and K9a, the opacity VJP, which
    shares the header's march (nearest and interp, float32 and bf16, single
    pass and two passes): ``parent`` against ``shipped``.

With ``--opacity`` it times K9a's designs instead, in libraries whose K3
entry is stripped (it returns an error and instantiates no K3 kernel, so
that each builds in seconds; the parent's too). Each design but
``shipped`` puts `tools/opacity_designs.cuh` (every lever) in place of the
header's K9a section and sets its three levers (`kOpReuse`, `kOpLoop`,
`kOpSkip`):

  * ``none``: 9 lookups from the root under interp, the earlier loop, no
    skip (one kernel a mode and no other lever);
  * ``reuse``: the interp corners from the own lookup, the own row on the
    bake and also the path-started descents on the tree walk (K2+K4's
    levers); ``reuse1``: the own row alone on both structures;
  * ``loop1``: the rotated loop (K9b's); ``loop2``: the next sample's lookup
    issued before the sigma's test (the lookup ahead);
  * ``skip``: the shipped levers, and a ray whose coefficient g_alpha *
    L_ray is 0 returns first;
  * ``shipped``: the header as it is;

on `OPACITY_CASES` (a seeded unit cotangent) and on the aux training
step's mask loss (`MASK_CASES`: the cotangent of ``MASK_WEIGHT *
mean((alpha - target)^2)`` with alpha and the target from two seeded pools,
single pass), every instance (both structures, nearest and interp, float32
and bf16). It prints the census of the mask loss's rays (a zero cotangent,
an opaque ray, a zero coefficient) and counts the `MUFU.EX2` instructions
of each K9a kernel in the shipped library's SASS (`cuobjdump`): the single
pass's L is dead, so its kernels should issue none.

Every design's gradient is held to the parent's (or, without one, to
``shipped`` at width 1) within ATOMIC_RTOL * max(1, max|reference|) (the
atomics sum in another order), and the rows that receive a gradient must be
the reference's exactly. The forward outputs of the single pass come from
the plain forward on the bake (the two structures' exact renders are equal
bit for bit). Needs one CUDA GPU and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
import render_fwd_ab as fab  # noqa: E402
import svox_t_tpu_torch as stt  # noqa: E402
from svox_t_tpu_torch import _build  # noqa: E402
from svox_t_tpu_torch.ops import render as render_ops  # noqa: E402
from svox_t_tpu_torch.ops import render_aux as aux_ops  # noqa: E402
from svox_t_tpu_torch.utils.scenes import build_shell_tree, orbit_camera, random_lobes  # noqa: E402
from svox_t_tpu_torch.utils.spec import FORMAT_ASG, FORMAT_SG, FORMAT_SH  # noqa: E402

ROUNDS = 6
REPS = 10

BWD_UNITS = ("render_bwd", "render_bwd_baked", "render_bwd_interp", "render_bwd_baked_interp",
             "render_bwd_bf16", "render_bwd_baked_bf16", "render_bwd_interp_bf16",
             "render_bwd_baked_interp_bf16")
# `pass1_scalars`: pass 1 adds whole vectors up to the sigma column's, then
# its three coefficient columns one at a time (6 vectors and 3 scalars at
# SH9; 3 scalars at D = 4).
PASS1 = ("""#pragma unroll
    for (int e = 0; e < kD; e += 4) {
      atomicAdd(reinterpret_cast<float4*>(grow + e),
                make_float4(v(e), v(e + 1), v(e + 2), kSigma || e + 3 != kD - 1 ? v(e + 3) : 0.f));
    }
""", """#pragma unroll
    for (int e = 0; e < (kSigma ? kD : kD - 4); e += 4) {
      atomicAdd(reinterpret_cast<float4*>(grow + e), make_float4(v(e), v(e + 1), v(e + 2), v(e + 3)));
    }
    if constexpr (!kSigma) {
#pragma unroll
      for (int e = kD - 4; e < kD - 1; ++e) atomicAdd(grow + e, v(e));
    }
""")
REUSE4 = "constexpr int kCornerReuse4 = S::kBaked ? 1 : 2;\n"
KERNEL_BOUND = "__global__ void __launch_bounds__(kThreads) render_bwd_kernel("
# `add_row4`, the width-4 adds (the function's text up to its closing brace).
ADD_ROW4 = re.compile(r"template <int kD, bool kColor, bool kSigma, bool kScale>\n"
                      r"__device__ __forceinline__ void add_row4\(.*?\n}\n", re.S)
# `match`: the warp's lanes that add into the same row sum their addends
# with shuffles, and the lowest of them adds the sum.
MATCH = """template <int kD, bool kColor, bool kSigma, bool kScale>
__device__ __forceinline__ void add_row4(float* grow, const float* G, float w) {
  const unsigned peers = __match_any_sync(__activemask(), reinterpret_cast<unsigned long long>(grow));
  const bool leader = (peers & ((1u << (threadIdx.x & 31)) - 1)) == 0;
  const auto v = [&](int e) {
    const float x = kScale ? w * G[e] : G[e];
    float s = x;
    for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) s += __shfl_sync(peers, x, __ffs(rest) - 1);
    return s;
  };
  if constexpr (!kColor) {
    const float s = v(kD - 1);
    if (leader) atomicAdd(grow + kD - 1, s);
  } else {
#pragma unroll
    for (int e = 0; e < kD; e += 4) {
      const float a = v(e), b = v(e + 1), c = v(e + 2);
      const float d = kSigma || e + 3 != kD - 1 ? v(e + 3) : 0.f;
      if (leader) atomicAdd(reinterpret_cast<float4*>(grow + e), make_float4(a, b, c, d));
    }
  }
}
"""
# `no_adds` (a diagnostic, its gradient not checked): width 4 with no adds
# at all, the lookups and the row reads that sigma and L need.
NO_ADDS = ("template <int kD, bool kColor, bool kSigma, bool kScale>\n"
           "__device__ __forceinline__ void add_row4(float*, const float*, float) {}\n")
F32_UNITS = BWD_UNITS[:4]
# {design: (text patches of render_bwd.cuh, compile units)}.
DESIGNS = {
    "shipped": ((), BWD_UNITS),
    "pass1_scalars": ((PASS1,), BWD_UNITS),
    "lever1": (((REUSE4, "constexpr int kCornerReuse4 = 1;\n"),),
               ("render_bwd_interp", "render_bwd_interp_bf16")),
    "bound_6": (((KERNEL_BOUND, KERNEL_BOUND.replace("(kThreads)", "(kThreads, 6)")),), BWD_UNITS),
    "bound_8": (((KERNEL_BOUND, KERNEL_BOUND.replace("(kThreads)", "(kThreads, 8)")),), BWD_UNITS),
    "match": (((ADD_ROW4, MATCH),), F32_UNITS),
    "no_adds": (((ADD_ROW4, NO_ADDS),), F32_UNITS),
}
# Diagnostic designs: timed, their gradients not checked.
UNCHECKED = {"no_adds"}
# The designs that change only a mode or a structure: (fast only; tree
# walk interp only).
FAST_ONLY = {"pass1_scalars"}
TREE_INTERP_ONLY = {"lever1"}
# (label, interp, pool type, rotations, fast, shape) of the width-4 cases.
CASES = (
    ("SH9", False, "f32", False, False, "deep"),
    ("SH9 rot", False, "f32", True, False, "deep"),
    ("SH9 bf16", False, "bf16", False, False, "deep"),
    ("SH9 bf16 rot", False, "bf16", True, False, "deep"),
    ("SH9 fast", False, "f32", False, True, "deep"),
    ("SH9 bf16 fast", False, "bf16", False, True, "deep"),
    ("SH9 headline", False, "f32", False, False, "headline"),
    ("interp SH9", True, "f32", False, False, "deep"),
    ("interp SH9 rot", True, "f32", True, False, "deep"),
    ("interp SH9 bf16", True, "bf16", False, False, "deep"),
    ("interp SH9 bf16 rot", True, "bf16", True, False, "deep"),
    ("interp SH9 fast", True, "f32", False, True, "deep"),
    ("interp SH9 bf16 fast", True, "bf16", False, True, "deep"),
)
# (label, format, basis, interp) of the width-1 families, exact, float32.
FAMILIES = (
    ("SH4", FORMAT_SH, 4, False), ("SH16", FORMAT_SH, 16, False), ("SG9", FORMAT_SG, 9, False),
    ("ASG25", FORMAT_ASG, 25, False), ("interp SH4", FORMAT_SH, 4, True), ("interp SH16", FORMAT_SH, 16, True),
    ("interp SG9", FORMAT_SG, 9, True), ("interp ASG25", FORMAT_ASG, 25, True),
)
# (label, interp, pool type, fast) of K9a's cases.
OPACITY_CASES = tuple((f"{'interp ' if i else ''}{k}{' fast' if f else ''}", i, k, f)
                      for i in (False, True) for k in ("f32", "bf16") for f in (False, True))
# (label, interp, pool type) of K9a's mask-loss cases: exact, single pass.
MASK_CASES = tuple((f"{'interp ' if i else ''}{k}", i, k) for i in (False, True) for k in ("f32", "bf16"))
# K9a's designs: libraries with K3's entry stripped, the designs file in
# place of the K9a section where a design sets a lever.
K3_SWITCH = """  switch (format) {
    case svox::kRGBA: return launch<S, svox::kRGBA, 0>(p, stream);
    case svox::kSH: return launch_basis<S, svox::kSH>(p, stream);
    case svox::kSG: return launch_basis<S, svox::kSG>(p, stream);
    case svox::kASG: return launch_basis<S, svox::kASG>(p, stream);
    default: return cudaErrorInvalidValue;
  }
"""
STRIP_K3 = (K3_SWITCH, "  (void)p;\n  return cudaErrorInvalidValue;\n")
# The header's K9a section, which the designs replace by
# tools/opacity_designs.cuh (every lever, the shipped kernel's by default).
OPACITY_DESIGNS_FILE = Path(__file__).resolve().parent / "opacity_designs.cuh"
K9A_SECTION = re.compile(r"// -{69}\n// K9a: the opacity VJP.*?(?=// Basis instances hold)", re.S)
OP_REUSE = re.compile(r"constexpr int kOpReuse = [^;]*;\n")
OP_LOOP = re.compile(r"constexpr int kOpLoop = [^;]*;\n")
OP_SKIP = re.compile(r"constexpr bool kOpSkip = [^;]*;\n")
REUSE_LEVERS = "!svox::kInterp ? 0 : (S::kBaked ? 1 : 2)"
LOOP_LEVERS = "S::kBaked && svox::kFloatPool ? 2 : 0"


def op_levers(reuse: str, loop: str, skip: str) -> tuple:
    """The patches that strip K3, put the designs file in place of the K9a
    section and set its three levers."""
    section = "// " + "-" * 69 + "\n// K9a: the opacity VJP, the designs file\n" + OPACITY_DESIGNS_FILE.read_text() + "\n"
    return (STRIP_K3, (K9A_SECTION, lambda _: section), (OP_REUSE, f"constexpr int kOpReuse = {reuse};\n"),
            (OP_LOOP, f"constexpr int kOpLoop = {loop};\n"), (OP_SKIP, f"constexpr bool kOpSkip = {skip};\n"))


OPACITY_DESIGNS = {
    "shipped": ((STRIP_K3,), BWD_UNITS),
    "none": (op_levers("0", "0", "false"), BWD_UNITS),
    "reuse": (op_levers(REUSE_LEVERS, "0", "false"), BWD_UNITS),
    "reuse1": (op_levers("svox::kInterp ? 1 : 0", "0", "false"), BWD_UNITS),
    "loop1": (op_levers("0", "1", "false"), BWD_UNITS),
    "loop2": (op_levers("0", "2", "false"), BWD_UNITS),
    "skip": (op_levers(REUSE_LEVERS, LOOP_LEVERS, "true"), BWD_UNITS),
}
# K9a's kernels: structure and mode (none before the kernel a mode).
OPACITY_KERNEL = re.compile(r"opacity_bwd_kernelIN4svox\d+(TreeWalk|Baked)E(?:Lb([01])E)?")
MASK_WEIGHT = 0.1  # chip_smoke.py's weight of the mask loss
FMT_NAME = {FORMAT_SH: "SH", FORMAT_SG: "SG", FORMAT_ASG: "ASG"}
# K3's kernel instances: structure, format, basis capacity, rotation, width
# (none before the redesign).
K3_INSTANCE = re.compile(r"render_bwd_kernelIN4svox\d+(TreeWalk|Baked)ELi(\d+)ELi(\d+)ELb([01])E(?:Li(\d+)E)?")
POOL_OF_UNIT = {u: u.rsplit("_", 1)[1] if u.endswith("_bf16") else "f32" for u in BWD_UNITS}


def instance_name(unit: str, m: re.Match) -> str:
    structure, fmt, bd, rot, width = m.groups()
    fmt = {"0": "RGBA", "1": "SH", "2": "SG", "3": "ASG"}[fmt]
    return (f"{structure}{' interp' if '_interp' in unit else ''} {POOL_OF_UNIT[unit]} "
            f"{fmt}{bd if fmt != 'RGBA' else ''}{' rot' if rot == '1' else ''} width {width or '1'}")


def report(name: str, rows: list) -> None:
    """Print a library's K3 kernels: the SH9 and RGBA instances' registers
    and blocks an SM, and every instance that spills."""
    k3 = [(unit, r, s, m) for unit, e, r, s in rows for m in [K3_INSTANCE.search(e)] if m]
    main = [f"{instance_name(u, m)} {r} regs ({cs.blocks_per_sm(r)} blocks/SM, {s} B spilled)"
            for u, r, s, m in k3 if (m.group(2) == "1" and m.group(3) == "9") or m.group(2) == "0"]
    spills = [f"{instance_name(u, m)} {r} regs {s} B" for u, r, s, m in k3 if s]
    print(f"ptxas {name}: {len(k3)} K3 kernels, {sum(s for *_, s, _ in k3)} bytes spilled in all")
    print(f"  SH9 and RGBA: {'; '.join(main)}")
    print(f"  spilling ({len(spills)}): {'; '.join(spills) if spills else 'none'}")


def report_opacity(name: str, rows: list) -> None:
    """Print a library's K9a kernels: registers and spills of each."""
    k9a = [(unit, r, sp, m) for unit, e, r, sp in rows for m in [OPACITY_KERNEL.search(e)] if m]
    mode = {"0": "single pass", "1": "two passes", None: "both modes"}
    print(f"ptxas {name}: " + "; ".join(
        f"{u} {mode[m.group(2)]} {r} regs ({cs.blocks_per_sm(r)} blocks/SM"
        f"{f', {sp} B spilled' if sp else ''})" for u, r, sp, m in k9a))


def load_entries(libs: dict, parent_has_width: bool) -> dict:
    """{(library, entry suffix): (K3's C entry, has width, K9a's C entry)}."""
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for pool_sfx in ("", "_bf16"):
            for sfx in ("", "_baked", "_interp", "_baked_interp"):
                fn = getattr(lib, f"svox_render_bwd{sfx}{pool_sfx}", None)
                if fn is None:
                    continue
                has_width = name != "parent" or parent_has_width
                fn.argtypes = (render_ops._BWD_ARGS if has_width
                               else render_ops._BWD_ARGS[:-3] + render_ops._BWD_ARGS[-2:])
                fn.restype = ctypes.c_int
                op = getattr(lib, f"svox_opacity_bwd{sfx}{pool_sfx}")
                op.argtypes = aux_ops._OPACITY_ARGS
                op.restype = ctypes.c_int
                fns[name, sfx + pool_sfx] = (fn, has_width, op)
    return fns


def scenes(dev) -> dict:
    """{label: {structure: (spec, pool, origins, dirs, options)}} of
    `CASES`, `FAMILIES` and `OPACITY_CASES` (K9a's under ``"opacity " +
    label``)."""
    state, feats_np, _ = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    tree = stt.tree_from_numpy(state, device=dev)
    feats = torch.from_numpy(feats_np).to(dev)
    M = feats.shape[0]
    o, d = cs.camera_rays(dev)
    rot = cs.random_rotations(M, np.random.RandomState(0), dev)
    base = {"tree": tree._spec(), "baked": tree._baked_spec()}
    spin = {k: s.with_(transformation_matrices=rot) for k, s in base.items()}
    rend = {False: stt.VolumeRenderer(tree), True: stt.VolumeRenderer(tree, interp="trilinear")}
    state7, f7_np = build_shell_tree(depth=7, data_format="SH9", data_dim=28)[:2]
    t7 = stt.tree_from_numpy(state7, device=dev)
    f7 = torch.from_numpy(f7_np).to(dev)
    opt7 = stt.VolumeRenderer(t7, step_size=1e-3)._get_options(False)
    o7, d7 = render_ops.cam2world_rays(torch.as_tensor(orbit_camera(), device=dev), cs.WIDTH, cs.HEIGHT,
                                       cs.BENCH_FX, cs.BENCH_FX)
    o7, d7 = o7.contiguous(), d7.contiguous()
    out = {}
    for label, interp, kind, has_rot, fast, shape in CASES:
        if shape == "headline":
            out[label] = {"tree": (t7._spec(), f7, o7, d7, opt7), "baked": (t7._baked_spec(), f7, o7, d7, opt7)}
            continue
        pool = fab.as_pool(kind, feats)
        out[label] = {k: (s, pool, o, d, rend[interp]._get_options(fast))
                      for k, s in (spin if has_rot else base).items()}
    lobes = {f: torch.from_numpy(random_lobes(FMT_NAME[f], 25, seed=1)).to(dev) for f in (FORMAT_SG, FORMAT_ASG)}
    for i, (label, fmt, bd, interp) in enumerate(FAMILIES):
        pool = fab.seeded_device_pool(M, 3 * bd + 1, 10 + i, dev)
        opt = dataclasses.replace(rend[interp]._get_options(False), format=fmt, basis_dim=bd)
        ex = lobes[fmt][:bd].contiguous() if fmt in lobes else None
        out[label] = {k: (s.with_(extra_data=ex) if ex is not None else s, pool, o, d, opt)
                      for k, s in base.items()}
    for label, interp, kind, fast in OPACITY_CASES:
        out["opacity " + label] = {k: (s, fab.as_pool(kind, feats), o, d, rend[interp]._get_options(fast))
                                   for k, s in base.items()}
    targets = {}
    rng = np.random.RandomState(5)
    true_pool, pool0 = (cs.seeded_pool(rng, M, 28, dev) for _ in range(2))
    for label, interp, kind in MASK_CASES:
        out["opacity mask " + label] = {k: (s, fab.as_pool(kind, pool0), o, d, rend[interp]._get_options(False))
                                        for k, s in base.items()}
        targets["opacity mask " + label] = fab.as_pool(kind, true_pool)
    return out, targets


def opacity_sources(workdir: Path, parent: Path | None, designs: dict) -> dict:
    """K9a's libraries: each design's header patched (`OPACITY_DESIGNS`),
    and the parent's with its K3 entry stripped alike."""
    sources, alias = fab.design_sources(workdir, None, designs, BWD_UNITS, "render_bwd.cuh")
    if parent is not None:
        d = workdir / "parent"
        shutil.copytree(parent / "svox_t_tpu_torch" / "csrc", d)
        text = (d / "render_bwd.cuh").read_text()
        if text.count(K3_SWITCH) != 1:
            raise RuntimeError("the parent's render_bwd.cuh: K3's switch not found")
        (d / "render_bwd.cuh").write_text(text.replace(*STRIP_K3))
        sources["parent"] = (d, BWD_UNITS)
    return sources, alias


def ex2_census(lib: Path) -> None:
    """The MUFU.EX2 instructions of each K9a kernel in a library's SASS."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode:
        print(f"cuobjdump failed: {proc.stderr[:400]}")
        return
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            m = OPACITY_KERNEL.search(line)
            name = f"{m.group(1)} {'two passes' if m.group(2) == '1' else 'single pass'}" if m and m.group(2) else None
            if name:
                counts[name] = counts.get(name, [])
                counts[name].append(0)
        elif name and "MUFU.EX2" in line:
            counts[name][-1] += 1
    print("K9a MUFU.EX2 in SASS (a kernel a compile unit: tree, bake x nearest, interp x f32, bf16): "
          + "; ".join(f"{k} {v}" for k, v in counts.items()))


def kind_of(pool) -> str:
    return "f32" if pool.dtype == torch.float32 else "bf16"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K3 is timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--families", action="store_true",
                    help="also time the width-1 families and K9a against the parent")
    ap.add_argument("--opacity", action="store_true", help="time K9a's designs instead of K3's")
    ap.add_argument("--rounds", type=int, default=ROUNDS, help=f"rounds in turns (default {ROUNDS})")
    args = ap.parse_args()
    rounds = args.rounds
    if not torch.cuda.is_available():
        raise SystemExit("render_bwd_ab.py needs a CUDA GPU")
    table = OPACITY_DESIGNS if args.opacity else DESIGNS
    chosen = args.designs.split(",") if args.designs else list(table)
    unknown = set(chosen) - set(table)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(table)}")
    designs = {k: v for k, v in table.items() if k in chosen or k == "shipped"}
    parent_has_width = args.parent is not None and "float* grad, int width, int device" in (
        args.parent / "svox_t_tpu_torch" / "csrc" / "render_bwd.cuh").read_text()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if args.opacity:
            sources, alias = opacity_sources(Path(tmp), args.parent, designs)
        else:
            sources, alias = fab.design_sources(Path(tmp), args.parent, designs, BWD_UNITS, "render_bwd.cuh")
        libs = fab.compile_libraries(Path(tmp), sources, report_opacity if args.opacity else report)
        libs.update({a: libs[t] for a, t in alias.items()})
        fns = load_entries(libs, parent_has_width)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        if args.opacity:
            ex2_census(libs["shipped"])
        stream = torch.cuda.current_stream(dev).cuda_stream
        t0 = time.perf_counter()
        cases, targets = scenes(dev)
        if args.opacity:
            cases = {k: v for k, v in cases.items() if k.startswith("opacity")}
        rng = np.random.RandomState(17)
        grads_out, outs = {}, {}
        for label in cases:
            spec, pool, o, d, opt = cases[label]["baked"]
            n = 1 if label.startswith("opacity") else 4
            if label in targets:
                # The mask loss's cotangent: its alpha from this pool, the
                # target's from the other.
                with torch.no_grad():
                    a = render_ops.volume_render_plain(spec, pool, o, d, d, opt)[:, -1:].contiguous()
                    tgt = render_ops.volume_render_plain(spec, targets[label], o, d, d, opt)[:, -1:]
                grads_out[label] = ((2.0 * MASK_WEIGHT / o.shape[0]) * (a - tgt)).contiguous()
                outs[label] = a
                g, coef = grads_out[label], grads_out[label] * (1.0 - a)
                print(f"K9a census ({label}, the mask loss, {o.shape[0]} rays): zero cotangent "
                      f"{int((g == 0).sum())}, opaque (alpha 1) {int((a == 1).sum())}, zero coefficient "
                      f"{int((coef == 0).sum())}, alpha > 0 {int((a > 0).sum())}")
                continue
            grads_out[label] = torch.from_numpy(rng.randn(o.shape[0], n).astype(np.float32)).to(dev)
            single = opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0
            if single:
                key = (id(spec.transformation_matrices), id(spec.extra_data), opt, id(pool), id(o))
                if key not in outs:
                    with torch.no_grad():
                        outs[key] = render_ops.volume_render_plain(spec, pool, o, d, d, opt)
                out = outs[key]
                outs[label] = out[:, -1:].contiguous() if n == 1 else out
        print(f"scenes and plain forward outputs: {time.perf_counter() - t0:.1f} s")

        def call(label, structure, lib, width, grad):
            """A call of K3 (or K9a, for an ``opacity`` label) of library
            ``lib`` at ``width`` (None: the parent's entry as it is) into
            ``grad``, zeroed first, as the wrapper makes it."""
            spec, pool, o, d, opt = cases[label][structure]
            kind = kind_of(pool)
            fn, has_width, op = fns[lib, cs.SUFFIX[structure] + ("_interp" if opt.interp else "")
                                    + render_ops.POOL_SUFFIX[kind]]
            out = outs.get(label)
            g = grads_out[label]
            if label.startswith("opacity"):
                a = aux_ops._aux_args(spec, pool, o, d, opt, "render_bwd_ab")
                tail = (g.data_ptr(), None if out is None else out.data_ptr(), grad.data_ptr(), dev.index, stream)

                def launch():
                    grad.zero_()
                    err = op(*a, *tail)
                    if err:
                        raise RuntimeError(f"{lib} {label} {structure}: CUDA error {err}")
                return launch
            a, _ = render_ops._kernel_args(spec, pool, o, d, d, opt, "render_bwd_ab")
            if has_width and width is None:
                width = render_ops._fwd_width(spec, pool, opt)
            tail = ((width,) if has_width else ()) + (dev.index, stream)
            head = (opt.max_steps, g.data_ptr(), None if out is None else out.data_ptr(), grad.data_ptr())

            def launch():
                grad.zero_()
                err = fn(*a, *head, *tail)
                if err:
                    raise RuntimeError(f"{lib} {label} {structure} width {width}: CUDA error {err}")
            return launch

        def in_turns(runs: dict) -> dict:
            """{(run, key): [ms a round]} of ``runs`` ({(label, structure):
            [(run, library, width)]}), after holding every run's gradient
            to the first run's."""
            times = {}
            for key, rs in runs.items():
                label, structure = key
                spec, pool, *_ = cases[label][structure]
                shape = (pool.shape[0], pool.shape[1])
                ref = None
                for run, lib, width in rs:
                    if run in UNCHECKED:
                        continue
                    grad = torch.empty(shape, dtype=torch.float32, device=dev)
                    call(label, structure, lib, width, grad)()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = grad
                        check_nonzero(grad, f"{label} {structure} {run}")
                        continue
                    cs.atomic_err(grad, ref, f"{label} {structure}: {run} against {rs[0][0]}")
                    cs.check(torch.equal((grad != 0).any(1), (ref != 0).any(1)),
                             f"{label} {structure}: {run} has a gradient in other rows than {rs[0][0]}")
                del ref, grad
                g = torch.empty(shape, dtype=torch.float32, device=dev)
                launches = [call(label, structure, lib, width, g) for _, lib, width in rs]
                for run, _, _ in rs:
                    times[run, key] = []
                for i in range(rounds):
                    order = list(zip(rs, launches))
                    for (run, _, _), launch in (order if i % 2 == 0 else order[::-1]):
                        times[run, key].append(cs.time_ms(launch, REPS))
                del g
            return times

        def check_nonzero(grad, what):
            cs.check(bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0, f"{what}: no gradient")

        res = {}

        def show(title, runs, times):
            print(f"{title}, {rounds} rounds in turns; gradients within ATOMIC_RTOL of the first run's and the "
                  f"same rows; CUDA events over {REPS} calls (zero the gradient, launch) [{card}]")
            for key, rs in runs.items():
                base = statistics.median(times[rs[0][0], key])
                for run, _, width in rs:
                    v = times[run, key]
                    med = statistics.median(v)
                    res[f"{run}_{key[0].replace(' ', '_')}_{key[1]}_ms"] = med
                    print(f"  {key[0]:20s} {key[1]:6s} {run:14s} width {width or '-'}: median {med:.4f} ms "
                          f"({base / med:.3f}x {rs[0][0]}), rounds {[round(x, 4) for x in v]}")

        first = (("parent", "parent", None),) if args.parent is not None else ()
        if args.opacity:
            runs = {(label, st_): first + tuple((name, name, None) for name in designs)
                    for label in cases for st_ in ("baked", "tree")}
            show("K9a designs", runs, in_turns(runs))
            print(json.dumps(res))
            return
        runs = {}
        for label, interp, kind, _rot, fast, _shape in CASES:
            for st_ in ("baked", "tree"):
                rs = first + (("w1", "shipped", 1), ("shipped", "shipped", 4))
                for dname in designs:
                    if dname == "shipped" or (dname in FAST_ONLY and not fast) or (
                            dname in TREE_INTERP_ONLY and not (interp and st_ == "tree")) or (
                            kind != "f32" and DESIGNS[dname][1] == F32_UNITS):
                        continue
                    rs += ((dname, dname, 4),)
                runs[label, st_] = rs
        show("K3 and K3+K4 at width 4", runs, in_turns(runs))
        if args.families:
            ref = first or (("w1", "shipped", 1),)
            runs = {(label, st_): ref + (("shipped", "shipped", 1),) for label, *_ in FAMILIES
                    for st_ in ("baked", "tree")}
            runs.update({("opacity " + label, st_): ref + (("shipped", "shipped", None),)
                         for label, *_ in OPACITY_CASES for st_ in ("baked", "tree")})
            show("K3 width-1 families and K9a", runs, in_turns(runs))
        print(json.dumps(res))


if __name__ == "__main__":
    main()
