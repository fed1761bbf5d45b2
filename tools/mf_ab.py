"""Designs of the motion-feature march (K9c forward, K9d VJP) side by side,
on one CUDA GPU.

    python3 tools/mf_ab.py [--parent DIR] [--designs A,B,...] [--no-census]

`csrc/render_aux.cuh` has two instances of each kernel per Kd capacity,
picked by the entries' width argument: the vector one (width 4: nb == 4,
aligned tables and rows, Kd % 4 == 0) reads a contributing sample's LBS
rows in one float4 and one int4 load, the joint table from a shared-memory
copy in float4s and K9c's output (K9d's grad_out) rows in float4s; the
other (width 1) reads them as the earlier kernel did. K9d sums into a
shared table a block with one shared float atomicAdd a column (the earlier
kernel's adds); under interp both find the corners from the sample's own
lookup. This script compiles each design with nvcc, every design a text
patch of the header as it is, in a copy of the sources (the `render_aux*`
compile units: both structures, nearest and interp, float32, bf16 and int8
pools):

  * ``shipped``: the header as it is;
  * ``cas128``: K9d's adds 4 columns at a time, one 128-bit
    compare-and-swap loop each (rows padded to an odd number of float4s);
  * ``cas64``: as two 64-bit compare-and-swap loops;
  * ``warp_tables``: K9d's table, one copy a warp;
  * ``owned``: the warp marches its lanes in step, and after each step the
    lanes that own the table's columns add the contributing lanes' bones
    from staging rows with plain loads and stores (no atomic; 32 * J floats
    of tables a warp);
  * ``jf_ldg4``: the joint rows read as float4s from global memory
    (``__ldg``) instead of the shared copy;
  * ``no_bound``: both kernels compiled with no bound of blocks an SM
    (shipped: 7 blocks of 128, 72 registers, for K9c's Kd-16 instances and
    K9d's Kd-16 bake interp ones);
  * ``corners9``: the interp corners from 9 lookups (svox::sample_corners);
  * ``lever1``: K9c's tree-walk interp corners with the own corner's row
    reused and the other 7 looked up from the root, as K9d's are;
  * ``lever2_bwd``: K9d's tree-walk interp corners as K9c's: also the other
    corners' descents started on the own path;
  * ``no_adds``: a diagnostic, K9d with no adds (each bone's addends summed
    into a register that is never stored), its gradient not checked;
  * ``parent`` (with ``--parent DIR``, a checkout of an earlier commit, for
    example ``git archive`` of the parent unpacked in DIR): that commit's
    header.

``scalar`` runs ``shipped`` at width 1 on the same inputs: its other
instance.

It prints the registers and spills of every K9b-K9d instance of
``shipped`` and ``parent``, and the SASS opcodes of the shared-memory
atomics in each library's K9d (``cuobjdump -sass``: a native reduction or
a compare-and-swap loop). Then, unless ``--no-census``, the census of K9d's
adds (`tools/mf_census.py`) on the aux scene's deep camera (depth-9 SH9 shell,
800x800, 32 joints, Kd 16, 4 bones), nearest and interp, with the aux
scene's seeded skinning and with the dynamic path's (each leaf's 4 nearest
joints). Then it times in turns (ROUNDS rounds, the order reversed every
other round, the medians; CUDA events over REPS calls, each zeroing the
gradient as the wrapper does) every instance of K9c and K9d (both
structures, nearest and interp, float32, bf16 and int8 pools) on that
scene: ``parent``, ``shipped`` and, on float32 pools, each design and
``scalar``; and K9b's instances, ``parent`` against ``shipped``. K9c's
outputs must equal the first run's bit for bit, K9d's gradients lie within
ATOMIC_RTOL * max(1, max|first|) of the first run's. Needs one CUDA GPU
and nvcc; builds no other kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
from svox_t_tpu_torch.utils.scenes import build_shell_tree, skin_to_nearest_joints  # noqa: E402

import mf_census  # noqa: E402

ROUNDS = 6
REPS = 10

AUX_UNITS = ("render_aux", "render_aux_baked", "render_aux_interp", "render_aux_baked_interp",
             "render_aux_bf16", "render_aux_baked_bf16", "render_aux_interp_bf16",
             "render_aux_baked_interp_bf16", "render_aux_i8", "render_aux_baked_i8",
             "render_aux_interp_i8", "render_aux_baked_interp_i8")
F32_UNITS = AUX_UNITS[:4]
INTERP_UNITS = ("render_aux_interp", "render_aux_baked_interp")
REUSE = "constexpr int kCornerReuseMf = S::kBaked || kBackward ? 1 : 2;\n"
# K9d's gradient table: its rows Kd | 1 floats apart; the compare-and-swap
# designs pad them to an odd number of float4s, 16-byte aligned.
STRIDE = ("__host__ __device__ constexpr int table_stride(int kd) { return kd | 1; }\n",
          "__host__ __device__ constexpr int table_stride(int kd) { return 4 * (((kd + 3) / 4) | 1); }\n")
ADD_BONE = re.compile(r"template <int KD>\n__device__ __forceinline__ void add_bone\(.*?\n\}\n", re.S)
ADD_BONE4 = """template <int KD>
__device__ __forceinline__ void add_bone(float* row, float w, const float* gb, int Kd) {
#pragma unroll
  for (int q = 0; q < KD / 4; ++q) {
    if (4 * q < Kd) {
      atomic_add4(row + 4 * q, make_float4(w * gb[4 * q], w * gb[4 * q + 1], w * gb[4 * q + 2], w * gb[4 * q + 3]));
    }
  }
}
"""
# `cas128`: a bone's addends 4 columns at a time, one 128-bit
# compare-and-swap loop each (`ATOMS.CAS.128`).
CAS128 = """__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  float4 old = *reinterpret_cast<const float4*>(dst);
  for (;;) {
    const unsigned long long o_lo = (static_cast<unsigned long long>(__float_as_uint(old.y)) << 32) |
                                    __float_as_uint(old.x);
    const unsigned long long o_hi = (static_cast<unsigned long long>(__float_as_uint(old.w)) << 32) |
                                    __float_as_uint(old.z);
    const unsigned long long n_lo = (static_cast<unsigned long long>(__float_as_uint(old.y + v.y)) << 32) |
                                    __float_as_uint(old.x + v.x);
    const unsigned long long n_hi = (static_cast<unsigned long long>(__float_as_uint(old.w + v.w)) << 32) |
                                    __float_as_uint(old.z + v.z);
    unsigned long long r_lo, r_hi;
    asm volatile(
        "{.reg .b128 cmp, val, res; mov.b128 cmp, {%2, %3}; mov.b128 val, {%4, %5}; "
        "atom.shared.cas.b128 res, [%6], cmp, val; mov.b128 {%0, %1}, res;}"
        : "=l"(r_lo), "=l"(r_hi)
        : "l"(o_lo), "l"(o_hi), "l"(n_lo), "l"(n_hi), "r"(addr)
        : "memory");
    if (r_lo == o_lo && r_hi == o_hi) return;
    old = make_float4(__uint_as_float(static_cast<unsigned>(r_lo)), __uint_as_float(static_cast<unsigned>(r_lo >> 32)),
                      __uint_as_float(static_cast<unsigned>(r_hi)), __uint_as_float(static_cast<unsigned>(r_hi >> 32)));
  }
}
""" + ADD_BONE4
# `cas64`: two 64-bit compare-and-swap loops for each 4 columns.
CAS64 = """__device__ __forceinline__ void atomic_add2(float* dst, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(dst);
  unsigned long long old = *q;
  for (;;) {
    const float x = __uint_as_float(static_cast<unsigned>(old)), y = __uint_as_float(static_cast<unsigned>(old >> 32));
    const unsigned long long nv = (static_cast<unsigned long long>(__float_as_uint(y + b)) << 32) | __float_as_uint(x + a);
    const unsigned long long r = atomicCAS(q, old, nv);
    if (r == old) return;
    old = r;
  }
}
__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
  atomic_add2(dst, v.x, v.y);
  atomic_add2(dst + 2, v.z, v.w);
}
""" + ADD_BONE4
# `no_adds` (a diagnostic): each bone's addends summed into a register that
# is never stored.
NO_ADDS = """template <int KD>
__device__ __forceinline__ void add_bone(float* row, float w, const float* gb, int Kd) {
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KD; ++k) sum = sum + w * gb[k];
  if (sum == -1.2345e-30f) row[0] = sum;
}
"""
TABLE_BYTES = ("  const size_t table_bytes = backward ? static_cast<size_t>(table_floats(p.J, p.Kd)) * sizeof(float) "
               ": 0;\n")
# `warp_tables`: the gradient table, one copy a warp.
WARP_TABLES = (
    (TABLE_BYTES, TABLE_BYTES.replace("backward ? static_cast", "backward ? (kThreads / 32) * static_cast")),
    ("  float* sjf = table + table_floats(p.J, p.Kd);\n"
     "  for (int e = threadIdx.x; e < p.J * rs; e += blockDim.x) table[e] = 0.f;\n",
     "  const int tf = table_floats(p.J, p.Kd);\n"
     "  float* sjf = table + (kThreads / 32) * tf;\n"
     "  for (int e = threadIdx.x; e < (kThreads / 32) * tf; e += blockDim.x) table[e] = 0.f;\n"
     "  float* wtable = table + (threadIdx.x >> 5) * tf;\n"),
    ("add_bone<KD>(table + bo.j[n] * rs,", "add_bone<KD>(wtable + bo.j[n] * rs,"),
    ("add_bone<KD>(table + min(", "add_bone<KD>(wtable + min("),
    ("    const float v = table[j * rs + e - j * p.Kd];\n",
     "    float v = 0.f;\n    for (int w = 0; w < kThreads / 32; ++w) v = v + table[w * tf + j * rs + e - j * p.Kd];\n"),
)
JF_LDG4 = (
    ("      const float4* f = reinterpret_cast<const float4*>(sjf) + bo.j[n] * rs4;\n",
     "      const float4* f = reinterpret_cast<const float4*>(p.jf + static_cast<size_t>(bo.j[n]) * p.Kd);\n"),
    ("          const float4 v = f[q];\n", "          const float4 v = __ldg(f + q);\n"),
)
# `no_bound`: both kernels compiled with no bound of blocks an SM.
NO_BOUND = ("constexpr bool kMfBounded = KD == 16 && (!kBackward || (svox::kInterp && S::kBaked));\n",
            "constexpr bool kMfBounded = false;\n")
# `owned`: the warp marches its lanes in step; after a step, each
# contributing lane stores its addend base gb in a staging row and the
# lanes that own the columns (lane l: column l % KD of slot l / KD, bones
# l / KD, l / KD + 32 / KD, ...) add each contributing lane's bones into
# the warp's tables with plain loads and stores, no atomic (32 * J floats a
# warp); the block sums its warps' slots at its end.
BWD_KERNEL = re.compile(r"template <int KD, bool V>\n__device__ __forceinline__ void mf_bwd\(const MotionParams& p\) \{"
                        r".*?\n\}\n\n(?=// The kernels' entries)", re.S)
OWNED = """constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
__host__ __device__ constexpr int stage_stride(int kd_cap) { return kd_cap + 4; }
__host__ __device__ constexpr size_t owned_floats(int kd_cap, int J) {
  return static_cast<size_t>(kWarps) * 32 * J + static_cast<size_t>(kWarps) * 32 * stage_stride(kd_cap);
}

template <int KD>
__device__ __forceinline__ void owned_adds(const MotionParams& p, bool contrib, int32_t idx, const float* gb,
                                           float* tab, float* stage, int lane) {
  const unsigned m = __ballot_sync(kFullMask, contrib);
  if (m == 0) return;
  constexpr int kStage = stage_stride(KD);
  if (contrib) {
    float4* row = reinterpret_cast<float4*>(stage + lane * kStage);
#pragma unroll
    for (int q = 0; q < KD / 4; ++q) row[q] = make_float4(gb[4 * q], gb[4 * q + 1], gb[4 * q + 2], gb[4 * q + 3]);
  }
  __syncwarp();
  constexpr int kSlots = 32 / KD;
  const int slot = lane / KD, k = lane % KD;
  for (unsigned rest = m; rest; rest &= rest - 1) {
    const int s = __ffs(rest) - 1;
    const int32_t row = __shfl_sync(kFullMask, idx, s);
    if (k < p.Kd) {
      const float v = stage[s * kStage + k];
      const float* swr = p.sw + static_cast<size_t>(row) * p.nb;
      const int32_t* jir = p.ji + static_cast<size_t>(row) * p.nb;
      for (int n = slot; n < p.nb; n += kSlots) {
        const float w = __ldg(swr + n);
        if (w > 0.f) {
          float* dst = tab + (slot * p.J + min(max(__ldg(jir + n), 0), p.J - 1)) * KD + k;
          *dst = *dst + w * v;
        }
      }
    }
  }
  __syncwarp();
}

template <int KD, bool V>
__device__ __forceinline__ void mf_bwd(const MotionParams& p) {
  extern __shared__ float4 smem4[];
  float* tables = reinterpret_cast<float*>(smem4);
  float* stage = tables + kWarps * 32 * p.J;
  float* sjf = stage + kWarps * 32 * stage_stride(KD);
  for (int e = threadIdx.x; e < kWarps * 32 * p.J; e += blockDim.x) tables[e] = 0.f;
  if constexpr (V) load_joint_table(p, sjf);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wtab = tables + warp * 32 * p.J;
  float* wstage = stage + warp * 32 * stage_stride(KD);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  bool active = i < p.m.B && setup_ray(p.m, i, r, true);
  float g[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) g[k] = active && k < p.Kd ? __ldg(p.grad_out + static_cast<size_t>(i) * p.Kd + k) : 0.f;
  constexpr int kReuse = kCornerReuseMf<true>;
  typename S::Keep keep;
  init_keep<S, kReuse>(keep);
  float L = 1.f;
  float t = active ? r.tmin : 0.f;
  for (int step = 0;; ++step) {
    active = active && step < p.m.max_steps && t < r.tmax;
    if (!__any_sync(kFullMask, active)) break;
    bool contrib = false;
    int32_t idx = 0;
    float gb[KD];
    if (active) {
      const Sample s = sample_mf<S, kReuse>(p.m, r, t, keep);
      if (s.sigma > 0.f) {
        const float att = expf((-s.dt * r.ds) * s.sigma);
        if (!svox::kInterp || s.resident) {
          const float weight = L * (1.f - att);
          Bones4 bo;
          if constexpr (V) bo = load_bones4(p, s.idx);
          blend<KD, V>(p, sjf, bo, s.idx, gb);
#pragma unroll
          for (int k = 0; k < KD; ++k) {
            const float sk = svox::sigmoid(gb[k]);
            gb[k] = ((weight * sk) * (1.f - sk)) * g[k];
          }
          contrib = true;
          idx = s.idx;
        }
        L = L * att;
      }
      t = t + s.dt;
    }
    owned_adds<KD>(p, contrib, idx, gb, wtab, wstage, lane);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.J * p.Kd; e += blockDim.x) {
    const int j = e / p.Kd, k = e - j * p.Kd;
    float v = 0.f;
    for (int w = 0; w < kWarps * (32 / KD); ++w) v = v + tables[(w * p.J + j) * KD + k];
    if (v != 0.f) atomicAdd(p.out + e, v);
  }
}

"""
OWNED_PATCHES = ((BWD_KERNEL, OWNED),
                 (TABLE_BYTES, "  const size_t table_bytes = backward ? owned_floats(KD, p.J) * sizeof(float) : 0;\n"))
# {design: (text patches of render_aux.cuh, compile units)}.
DESIGNS = {
    "shipped": ((), AUX_UNITS),
    "cas128": ((STRIDE, (ADD_BONE, CAS128)), F32_UNITS),
    "cas64": ((STRIDE, (ADD_BONE, CAS64)), F32_UNITS),
    "warp_tables": (WARP_TABLES, F32_UNITS),
    "owned": (OWNED_PATCHES, F32_UNITS),
    "jf_ldg4": (JF_LDG4, F32_UNITS),
    "no_bound": ((NO_BOUND,), AUX_UNITS),
    "corners9": (((REUSE, "constexpr int kCornerReuseMf = 0;\n"),), INTERP_UNITS),
    "lever1": (((REUSE, "constexpr int kCornerReuseMf = 1;\n"),), ("render_aux_interp",)),
    "lever2_bwd": (((REUSE, "constexpr int kCornerReuseMf = S::kBaked ? 1 : 2;\n"),), ("render_aux_interp",)),
    "no_adds": (((ADD_BONE, NO_ADDS),), F32_UNITS),
}
UNCHECKED = {"no_adds"}
# Designs that change only K9d, or only K9c (a design runs on its units).
BWD_ONLY = {"cas128", "cas64", "warp_tables", "owned", "lever2_bwd", "no_adds"}
FWD_ONLY = {"lever1"}
POOLS = ("f32", "bf16", "i8")
STRUCTS = ("tree", "baked")
KERNEL = re.compile(r"(first_hit_kernel|mf_fwd_kernel|mf_bwd_kernel)(_7)?(?:ILi(\d+)E(?:Lb([01])E)?)?")
FUNC = re.compile(r"Function : (\S+)")
SASS_ATOM = re.compile(r"\b((?:ATOMS|ATOM|RED|ATOMG)\.[A-Z0-9_.]+)")


def report(name: str, rows: list) -> None:
    """Registers and spills of a library's K9b-K9d instances."""
    out = []
    for unit, entry, regs, spill in rows:
        m = KERNEL.search(entry)
        if m:
            kd = f"<{m.group(3)}{', V' if m.group(4) == '1' else ', scalar' if m.group(4) else ''}>" if m.group(3) else ""
            out.append(f"{unit} {m.group(1)}{m.group(2) or ''}{kd} {regs} regs ({cs.blocks_per_sm(regs)} blocks/SM) {spill} B spilled")
    print(f"ptxas {name}: {len(out)} K9b-K9d kernels, {sum(r[3] for r in rows if KERNEL.search(r[1]))} "
          f"bytes spilled in all")
    for line in out:
        print(f"  {line}")


def sass_atomics(lib: Path) -> dict:
    """{K9d instance: {atomic opcode: count}} of a library (cuobjdump)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode:
        return {"error": proc.stderr.strip()[:200]}
    found, fn = {}, None
    for line in proc.stdout.splitlines():
        m = FUNC.search(line)
        if m:
            k = KERNEL.search(m.group(1))
            fn = f"{k.group(1)}{k.group(2) or ''}<{k.group(3)}{', ' + k.group(4) if k.group(4) else ''}>" if k and k.group(
                1) == "mf_bwd_kernel" else None
            continue
        if fn is not None:
            a = SASS_ATOM.search(line)
            if a:
                found.setdefault(fn, {})
                found[fn][a.group(1)] = found[fn].get(a.group(1), 0) + 1
    return found


def load(libs: dict, no_width=()) -> dict:
    """{(library, kernel, suffix): C entry} of K9b-K9d; the libraries of
    ``no_width`` (an earlier commit's) have no width argument."""
    fns = {}
    args = {"first_hit": aux_ops._FIRST_HIT_ARGS, "mf_fwd": aux_ops._MF_FWD_ARGS, "mf_bwd": aux_ops._MF_BWD_ARGS}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for kernel, argtypes in args.items():
            if name in no_width and kernel != "first_hit":
                argtypes = argtypes[:-3] + argtypes[-2:]
            for st_ in ("", "_baked"):
                for interp in ("", "_interp"):
                    for pool in POOLS:
                        sfx = st_ + interp + render_ops.POOL_SUFFIX[pool]
                        fn = getattr(lib, f"svox_{kernel}{sfx}", None)
                        if fn is None:
                            continue
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name, kernel, sfx] = fn
    return fns


def scene(dev):
    """The aux scene (chip_smoke.py's, its skeleton from its own seed):
    (tree, pool, rays, joint table, skinning, the rig's skinning)."""
    state, feats_np, centers_np = build_shell_tree(depth=cs.DEPTH, data_format="SH9", data_dim=28)
    feats = torch.from_numpy(feats_np).to(dev)
    M = feats.shape[0]
    joints, jf, sw, ji = cs.skeleton(np.random.RandomState(3), M, dev)
    tree = stt.tree_from_numpy(dict(state, extra_data=joints), device=dev)
    rig = tuple(torch.from_numpy(a).to(dev) for a in skin_to_nearest_joints(centers_np, joints, cs.N_BONES))
    o, d = cs.camera_rays(dev)
    return tree, feats, o, d, jf, sw, ji, rig


def census(tree, feats, o, d, jf, sw, ji, rig, dev) -> dict:
    """The census of K9d's adds, nearest and interp, with both skinnings."""
    g = torch.from_numpy(np.random.RandomState(5).randn(o.shape[0], cs.JOINT_DIM).astype(np.float32)).to(dev)
    res = {}
    for label, (sw_, ji_), interp in (("aux", (sw, ji), False), ("aux interp", (sw, ji), True),
                                      ("rig", rig, False)):
        spec = tree._spec(joint_features=jf, skinning_weights=sw_, joint_index=ji_)
        opt = stt.VolumeRenderer(tree, interp="trilinear" if interp else "nearest")._get_options(False)
        t0 = time.perf_counter()
        _, c = mf_census.mf_census(spec, jf, feats, o, d, g, opt)
        n_hit = int(render_ops._ray_setup(spec, o, d, opt, cube_hit=True)[-1].sum())
        print(f"census {label} ({time.perf_counter() - t0:.1f} s; {n_hit} rays hit the cube): {json.dumps(c)}")
        print(f"  contributing samples {c['contrib']}, adds (sample, bone, sw > 0) {c['adds']} "
              f"({c['adds'] * cs.JOINT_DIM} scalar adds); runs of one row: {c['runs_row']} "
              f"({c['contrib'] / max(c['runs_row'], 1):.3f} samples a run), of one joint-index row: {c['runs_ji']} "
              f"({c['contrib'] / max(c['runs_ji'], 1):.3f}), adds left by merging those: {c['adds_merged_ji']} "
              f"({c['adds_merged_ji'] / max(c['adds'], 1):.3f} of the adds)")
        print(f"  warp-steps with a contributing lane {c['warp_steps']}, {c['lanes'] / max(c['warp_steps'], 1):.2f} "
              f"lanes each; per bone-step with an add {c['bone_lanes'] / max(c['bone_steps'], 1):.2f} lanes into "
              f"{c['bone_joints'] / max(c['bone_steps'], 1):.2f} joints, "
              f"{c['bone_peak'] / max(c['bone_steps'], 1):.2f} lanes on the most shared one")
        res[label] = c
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit whose K9b-K9d are timed beside this one's")
    ap.add_argument("--designs", default=None, help="a comma-separated subset of the designs")
    ap.add_argument("--no-census", action="store_true", help="skip the census")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mf_ab.py needs a CUDA GPU")
    chosen = args.designs.split(",") if args.designs else list(DESIGNS)
    unknown = set(chosen) - set(DESIGNS)
    if unknown:
        raise SystemExit(f"unknown designs {sorted(unknown)}; known: {sorted(DESIGNS)}")
    designs = {k: v for k, v in DESIGNS.items() if k in chosen or k == "shipped"}
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sources, alias = fab.design_sources(Path(tmp), args.parent, designs, AUX_UNITS, "render_aux.cuh")
        libs = fab.compile_libraries(Path(tmp), sources, report)
        print(f"builds: {time.perf_counter() - t0:.1f} s")
        for name in ("parent", "shipped"):
            if name in libs:
                print(f"SASS shared-memory atomics of {name}'s K9d: {json.dumps(sass_atomics(libs[name]))}")
        libs.update({a: libs[t] for a, t in alias.items()})
        no_width = set()
        if args.parent is not None and "float* out, int width," not in (
                args.parent / "svox_t_tpu_torch" / "csrc" / "render_aux.cuh").read_text():
            no_width.add("parent")
        fns = load(libs, no_width)
        tree, feats, o, d, jf, sw, ji, rig = scene(dev)
        if not args.no_census:
            res["census"] = census(tree, feats, o, d, jf, sw, ji, rig, dev)
        specs = {"tree": tree._spec(joint_features=jf, skinning_weights=sw, joint_index=ji),
                 "baked": tree._baked_spec(skinning_weights=sw, joint_index=ji)}
        opts = {i: stt.VolumeRenderer(tree, interp="trilinear" if i else "nearest")._get_options(False)
                for i in (False, True)}
        pools = {k: fab.as_pool(k, feats) for k in POOLS}
        g = torch.from_numpy(np.random.RandomState(9).randn(o.shape[0], cs.JOINT_DIM).astype(np.float32)).to(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        B, J, Kd = o.shape[0], jf.shape[0], jf.shape[1]

        def call(kernel, structure, interp, pool, lib, scalar, buf):
            """A launch of ``lib``'s kernel into ``buf`` (the gradient
            zeroed first for K9d), at width 4 or (``scalar``) 1."""
            spec = specs[structure]
            opt = opts[interp]
            sfx = cs.SUFFIX[structure] + ("_interp" if interp else "") + render_ops.POOL_SUFFIX[pool]
            fn = fns[lib, kernel, sfx]
            if kernel == "first_hit":
                a = aux_ops._aux_args(spec, pools[pool], o, d, opt, "mf_ab")
                found, t_hit, row, frac = buf
                tail = (opt.sigma_thresh, found.data_ptr(), t_hit.data_ptr(), row.data_ptr(), frac.data_ptr(),
                        dev.index, stream)

                def launch():
                    err = fn(*a, *tail)
                    if err:
                        raise RuntimeError(f"{lib} first_hit{sfx}: CUDA error {err}")
                return launch
            a, jf_ = aux_ops._mf_kernel_args(spec, jf, pools[pool], o, d, opt, "mf_ab", kernel == "mf_bwd")
            width = () if lib in no_width else (1 if scalar else 4,)
            if kernel == "mf_fwd":
                tail = (opt.sigma_thresh, opt.stop_thresh, opt.background_brightness, buf.data_ptr(), *width,
                        dev.index, stream)
            else:
                tail = (g.data_ptr(), buf.data_ptr(), *width, dev.index, stream)

            def launch():
                if kernel == "mf_bwd":
                    buf.zero_()
                err = fn(*a, *tail)
                if err:
                    raise RuntimeError(f"{lib} {kernel}{sfx}: CUDA error {err}")
            launch.keep = jf_  # the float32 joint table the arguments point at
            return launch

        def buffer(kernel):
            if kernel == "mf_fwd":
                return torch.empty(B, Kd, device=dev)
            if kernel == "mf_bwd":
                return torch.empty(J, Kd, device=dev)
            return (torch.empty(B, dtype=torch.bool, device=dev), torch.empty(B, device=dev),
                    torch.empty(B, dtype=torch.int32, device=dev), torch.empty(B, 3, device=dev))

        def in_turns(key, runs):
            """Times of ``runs`` [(run, library, scalar)] of the instance
            ``key`` (kernel, structure, interp, pool) in turns, after
            holding each run's result to the first run's."""
            kernel, structure, interp, pool = key
            ref = None
            launches = []
            for run, lib, scalar in runs:
                buf = buffer(kernel)
                launch = call(kernel, structure, interp, pool, lib, scalar, buf)
                what = f"{kernel} {structure} interp={interp} {pool}: {run} against {runs[0][0]}"
                try:
                    launch()
                    torch.cuda.synchronize()
                except Exception as e:
                    raise RuntimeError(f"{what}: {e}") from e
                got = buf if kernel != "first_hit" else torch.cat([b.float().reshape(B, -1) for b in buf], 1)
                if run not in UNCHECKED:
                    if ref is None:
                        ref = got.clone()
                        cs.check(bool(torch.isfinite(ref).all()), f"{what}: not finite")
                    elif kernel == "mf_bwd":
                        cs.atomic_err(got, ref, what)
                    else:
                        cs.check(torch.equal(got, ref), f"{what}: not bit for bit")
                launches.append((run, launch))
            times = {run: [] for run, _ in launches}
            for i in range(ROUNDS):
                for run, launch in (launches if i % 2 == 0 else launches[::-1]):
                    times[run].append(cs.time_ms(launch, REPS))
            base = statistics.median(times[runs[0][0]])
            for run, v in times.items():
                med = statistics.median(v)
                res[f"{kernel}_{structure}{'_interp' if interp else ''}_{pool}_{run}_ms"] = med
                print(f"  {kernel:9s} {structure:5s} {'interp' if interp else 'nearest':7s} {pool:4s} {run:12s}: "
                      f"median {med:.4f} ms ({base / med:.3f}x {runs[0][0]}), rounds {[round(x, 4) for x in v]}")

        first = (("parent", "parent", False),) if args.parent is not None else ()
        print(f"K9c and K9d, {ROUNDS} rounds in turns; CUDA events over {REPS} calls (K9d: zero the gradient, "
              f"launch); K9c bit for bit and K9d within ATOMIC_RTOL of the first run [{card}]")
        for kernel in ("mf_fwd", "mf_bwd"):
            for interp in (False, True):
                for structure in STRUCTS:
                    for pool in POOLS:
                        runs = first + (("shipped", "shipped", False),)
                        if pool == "f32":
                            runs += (("scalar", "shipped", True),)
                        unit = ("render_aux" + ("_baked" if structure == "baked" else "")
                                + ("_interp" if interp else "") + render_ops.POOL_SUFFIX[pool])
                        for dname in designs:
                            if dname == "shipped" or unit not in DESIGNS[dname][1] or (
                                    dname in BWD_ONLY and kernel != "mf_bwd") or (
                                    dname in FWD_ONLY and kernel != "mf_fwd"):
                                continue
                            runs += ((dname, dname, False),)
                        in_turns((kernel, structure, interp, pool), runs)
        if args.parent is not None:
            print(f"K9b, parent against shipped, {ROUNDS} rounds in turns [{card}]")
            for interp in (False, True):
                for structure in STRUCTS:
                    for pool in POOLS:
                        in_turns(("first_hit", structure, interp, pool), first + (("shipped", "shipped", False),))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
