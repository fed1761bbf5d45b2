// K9b-K9d: the first-hit march and the motion-feature (LBS) march,
// forward and backward, on either structure. (K9a, the opacity VJP, is the
// sigma-only instance of K3 in render_bwd.cuh.) Included by render_aux.cu
// (the tree walk: svox_first_hit, svox_mf_fwd, svox_mf_bwd) and
// render_aux_baked.cu (the bake: the same names with _baked), which define
// SVOX_STRUCTURE and SVOX_SUFFIX first.
//
// Replaces: svox_t_tpu/ops/render_aux.py `_first_hit` (behind
// `render_depth` and `motion_render`), `_motion_feature_fwd_impl` with
// `_mf_blend`, and `_motion_feature_bwd_impl`. The TPU versions marched
// all rays in K-sample rounds, picked each round's first hit with prefix
// masks and scattered joint-feature gradients through the compaction
// ladder; here, as in the CUDA reference's rt_kernel.cu, one thread
// marches one ray sample by sample.
//
// All three share K2's march rules (ops/render.py): the first sample at
// tmin, t += dt while t < tmax, at most max_steps samples; rows >= M (and
// negative rows) are empty space with sigma 0. On a bake, the first hit
// culls against the occupied box as K2 does; the motion-feature passes
// only clamp tmin/tmax to it and keep the cube test as their hit (a cube
// miss outputs 0, a hit that finds nothing the background).
//
//  * First hit: a sample is "over" where sigma > sigma_thresh and
//    "resident" where it is over and its row is < M. t_hit is the t of the
//    first over sample; found, the row and the in-leaf fraction come from
//    the first resident sample, where the march stops. The two coincide
//    unless sigma_thresh < 0 (empty space is then over); the fraction is
//    always that of the point o + t_hit * d, so in that case the thread
//    descends once more at t_hit.
//  * Motion-feature forward: attenuation where sigma > sigma_thresh;
//    contribution where, in addition, the row is < M. A contributing
//    sample blends sum_n w_n * joint_features[ji_n, :Kd] with
//    w_n = sw_n where sw_n > 0 (else 0), summed in bone order, and adds
//    weight * sigmoid(blend). Early stop as K2 (the stop sample counts,
//    then 1/(1 - L), no background); a hit ray that never stopped adds
//    L * bg; a ray that misses the cube outputs 0, not the background.
//  * Motion-feature backward (the corrected VJP): samples while t < tmax,
//    the gate sigma > 0, no early stop; per contributing sample and bone
//    with sw_n > 0 it adds sw_n * ((weight * s) * (1 - s)) * g into row
//    ji_n of the (J, Kd) gradient.
// Joint indices are clamped to [0, J) for reading and adding, as a JAX
// gather clamps, so a bad index cannot reach outside the table.
//
// Bound on an H100: latency, as K2 — a dependent descent chain per
// sample. The forward's extra reads are two (M, nb) tables (one row each
// per contributing sample) and a J x Kd joint table small enough to stay in
// shared memory or L1. The backward's problem is contention: every
// contributing sample of every hit ray adds into the same J * Kd floats
// (512 at J 32, Kd 16). Each block therefore sums into a copy of the table
// in shared memory and adds its non-zero entries to the global table once,
// at its end; it takes J * (Kd | 1) * 4 bytes of dynamic shared
// memory, J * (Kd | 1) <= kMaxJointTable (the wrapper raises above). Kd is
// a register capacity (4, 8, 16 or 32, template instances) with Kd a
// run-time bound inside, as K2 holds colors; nb is a run-time loop bound
// (4 in the vector instances).
//
// Feature pools (K5): the build (_build.POOL_INSTANCES) also defines
// SVOX_POOL (svox::PoolBF16, svox::PoolI8) on each structure, nearest and
// interp (svox_first_hit_bf16, ..., svox_mf_bwd_baked_interp_i8). The
// three passes read only a row's sigma, column D - 1: one 2-byte or
// 1-byte load (and the column's scale and zero) per sample, in float32
// from there on. The joint table stays float32.
//
// Trilinear interpolation (K4): render_aux_interp.cu and
// render_aux_baked_interp.cu define SVOX_INTERP 1 (svox_first_hit_interp,
// svox_mf_fwd_interp, svox_mf_bwd_interp and their _baked_interp twins).
// No ray is culled or clamped to the box; a sample's sigma is its 8
// corners' (the first hit and the motion-feature passes find the corners
// from the sample's own lookup: sample_mf), also in an empty leaf,
// which is then "over" but not resident for the first hit, and attenuates
// without blending in the motion-feature passes.
//
// Arithmetic follows the plain PyTorch versions (ops/render_aux.py)
// operation for operation, and the library is built with -fmad=false, so
// samples, hits and fractions agree bit for bit; only the order in which
// the backward's atomics sum differs.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// Largest joint table the backward holds in shared memory, in floats.
constexpr int kMaxJointTable = 48 * 1024 / 4;
using S = SVOX_STRUCTURE;

// What every aux march reads.
struct March {
  S st;
  const float* origins;
  const float* dirs;
  int B;
  const float* offset;
  const float* scaling;
  svox::Pool features;
  int M;
  int D;
  float step_size;
  int max_steps;
};

using svox::Ray;

// The ray's setup and its culled hit (cube_hit: the cube test, clamped
// to the box only).
__device__ __forceinline__ bool setup_ray(const March& m, int i, Ray& r,
                                          bool cube_hit = false) {
  const bool hit = svox::setup_ray(m.origins, m.dirs, m.offset, m.scaling, i, r);
  const bool culled = svox::march_cull(m.st, r, hit);
  return cube_hit ? hit : culled;
}

struct Sample {
  svox::Leaf leaf;
  float dt;
  int32_t idx;
  bool resident;  // row < M
  float sigma;    // 0 in empty space
};

// The sample at t: descent, in-leaf DDA step and the row's sigma.
__device__ __forceinline__ Sample sample_at(const March& m, const Ray& r, float t) {
  Sample s;
  s.leaf = svox::sample_leaf(m.st, r, t, m.step_size, s.dt);
  s.idx = s.leaf.row;
  s.resident = static_cast<uint32_t>(s.idx) < static_cast<uint32_t>(m.M);
  if constexpr (svox::kInterp) {
    // K4: the corners' sigma, also where the sample's own leaf is empty.
    const svox::Corners cn = svox::sample_corners(m.st, r, t, s.leaf.cube_sz, m.M);
    s.sigma = svox::interp_sum(cn, [&](int32_t row) {
      return svox::ld(m.features + static_cast<size_t>(row) * m.D + m.D - 1);
    });
  } else {
    s.sigma = s.resident ? svox::ld(m.features + static_cast<size_t>(s.idx) * m.D + m.D - 1) : 0.f;
  }
  return s;
}

static_assert(kThreads == svox::kPathStride, "a block's threads are its path stride");

// The tree walk's per-thread slot of the own descent's path (shared memory,
// as render_fwd.cuh's). A template, so that only the instances that read
// it hold the array.
template <class T>
__device__ __forceinline__ int32_t* path_slot() {
  __shared__ int32_t path[svox::kPathLevels * svox::kPathStride];
  return path + threadIdx.x;
}

// Templates on the structure T (= S), so that the branch a structure does
// not take is not compiled for it. The tree walk's own lookup keeps its path
// at any reuse level (TreeWalk::lookup_keep).
template <class T, int kReuse>
__device__ __forceinline__ void init_keep(typename T::Keep& keep) {
  if constexpr (svox::kInterp && !T::kBaked && kReuse > 0) keep.path = path_slot<T>();
}

// The sample at t of the first hit and the motion-feature marches:
// sample_at's, with the interp corners from the sample's own lookup.
template <class T, int kReuse>
__device__ __forceinline__ Sample sample_mf(const March& m, const Ray& r, float t,
                                            typename T::Keep& keep) {
  if constexpr (!svox::kInterp || kReuse == 0) {
    return sample_at(m, r, t);
  } else {
    Sample s;
    s.leaf = svox::sample_leaf_keep(m.st, r, t, m.step_size, s.dt, keep);
    s.idx = s.leaf.row;
    s.resident = static_cast<uint32_t>(s.idx) < static_cast<uint32_t>(m.M);
    const svox::Corners cn = svox::corners_keep<kReuse>(m.st, r, t, s.leaf, keep, m.M);
    s.sigma = svox::interp_sum(cn, [&](int32_t row) {
      return svox::ld(m.features + static_cast<size_t>(row) * m.D + m.D - 1);
    });
    return s;
  }
}

// ---------------------------------------------------------------------
// K9b: first hit
//
// The Hopper design (tools/first_hit_ab.py times each lever against an
// earlier commit's kernel, PERF.md §6). A sample reads one value, its row's
// sigma, so the march is its lookups' chains of dependent loads and the
// loop around them. Each instance takes what won at its callers' shapes:
//  * kFhLoop: 0 the earlier kernel's loop (a sample's lookup, step and
//    sigma at the top of each step: sample_at, or sample_mf's corners under
//    interp); 1 the loop rotated, the next sample's lookup at the end of a
//    step, after the branch (the tree walk's nearest instances: 1.12x on a
//    float32 pool, a tie on bf16 and int8);
//  * interp (K4): the corners from the sample's own lookup as K2+K4 finds
//    them (sample_mf, svox::corners_keep<kFhReuse>: the own corner's row,
//    and on the tree walk the other corner descents started on the own
//    path), the sigma summed in corner order; an empty own leaf is then
//    "over" but not resident.
// The lookup ahead, the tree walk's descents started on the previous
// sample's path and the bake's reused top and mid entries lost or tied on
// every instance; tools/first_hit_designs.cuh keeps them for the tool.
// Each lookup equals the root's bit for bit, so samples, hits and fractions
// are the earlier kernel's.

constexpr int kFhLoop = !S::kBaked && !svox::kInterp ? 1 : 0;
constexpr int kFhReuse = svox::kInterp ? (S::kBaked ? 1 : 2) : 0;
static_assert(kFhLoop == 0 || !svox::kInterp, "the rotated loop reads a nearest sample's sigma");

struct FirstHitParams {
  March m;
  float sigma_thresh;
  bool* found;     // (B,)
  float* t_hit;    // (B,)
  int32_t* row;    // (B,)
  float* frac;     // (B, 3)
};

__global__ void __launch_bounds__(kThreads) first_hit_kernel(const FirstHitParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.m.B) return;
  bool found = false, found_t = false, same = false;
  float t_hit = 0.f, fx = 0.f, fy = 0.f, fz = 0.f;
  int32_t row = 0;
  Ray r;
  if (setup_ray(p.m, i, r)) {
    float t = r.tmin;
    // A sample over the threshold: its t, and where it is resident, the hit.
    auto over = [&](const svox::Leaf& l, bool resident, float ts) {
      const bool first = !found_t;
      if (first) {
        found_t = true;
        t_hit = ts;
      }
      if (resident) {
        found = true;
        same = first;
        row = l.row;
        fx = l.fx;
        fy = l.fy;
        fz = l.fz;
      }
      return resident;
    };
    if constexpr (kFhLoop == 0) {
      typename S::Keep keep;
      init_keep<S, kFhReuse>(keep);
      for (int step = 0; step < p.m.max_steps; ++step) {
        const Sample s = sample_mf<S, kFhReuse>(p.m, r, t, keep);
        if (s.sigma > p.sigma_thresh && over(s.leaf, s.resident, t)) break;
        t = t + s.dt;
        if (!(t < r.tmax)) break;
      }
    } else {
      float x, y, z;
      svox::sample_pos(r, t, x, y, z);
      svox::Leaf l = p.m.st.lookup(x, y, z);
      for (int step = 0; step < p.m.max_steps; ++step) {
        const float dt = svox::step_dt(p.m.st, l, r, p.m.step_size);
        const bool resident = static_cast<uint32_t>(l.row) < static_cast<uint32_t>(p.m.M);
        const float sigma = resident ? svox::ld(p.m.features + static_cast<size_t>(l.row) * p.m.D + p.m.D - 1)
                                     : 0.f;
        const float t_next = t + dt;
        const bool more = step + 1 < p.m.max_steps && t_next < r.tmax;
        if (sigma > p.sigma_thresh && over(l, resident, t)) break;
        if (!more) break;
        t = t_next;
        svox::sample_pos(r, t, x, y, z);
        l = p.m.st.lookup(x, y, z);
      }
    }
    if (found && !same) {
      // sigma_thresh < 0: t_hit lies before the resident sample.
      float x, y, z;
      svox::sample_pos(r, t_hit, x, y, z);
      const svox::Leaf leaf = p.m.st.lookup(x, y, z);
      fx = leaf.fx;
      fy = leaf.fy;
      fz = leaf.fz;
    }
  }
  p.found[i] = found;
  p.t_hit[i] = t_hit;
  p.row[i] = row;
  p.frac[3 * i + 0] = fx;
  p.frac[3 * i + 1] = fy;
  p.frac[3 * i + 2] = fz;
}

// ---------------------------------------------------------------------
// K9c/K9d: motion features
//
// The Hopper design (tools/mf_ab.py times each lever against an earlier
// commit's kernels, PERF.md §6). Each kernel has two instances per Kd
// capacity; the caller picks one by the entry's width argument
// (ops/render_aux.py's mf_width), and launch_mf refuses a width 4 that the
// launch does not allow:
//  * V (vectors, width 4), where nb == 4, Kd % 4 == 0, the LBS tables and
//    K9c's output (K9d's grad_out) are 16-byte aligned and the joint table
//    fits in the shared-memory budget: a contributing sample's skinning weights in
//    one float4 load and its joint indices in one int4 load; the joint table
//    copied by each block into shared memory, its rows padded with zeros to
//    an odd number of float4s (so that 8 lanes of one load phase that read
//    different rows hit different banks unless the rows are equal mod 8),
//    each joint row read in Kd / 4 16-byte loads; the (B, Kd) output (K9d:
//    grad_out) row in float4s;
//  * !V (width 1), anywhere: nb scalar loads of each LBS row, the joint table
//    read from global memory a column at a time, the row in scalars (the
//    earlier kernel's reads).
// K9d sums into a copy of the (J, Kd) gradient in shared memory, its rows
// Kd | 1 apart (lanes adding one column into different joints hit
// different banks), with shared-memory float atomics, and adds each non-zero
// entry to the global table once, at the block's end: the earlier kernel's
// adds, which beat 128- and 64-bit compare-and-swap loops over 4 and 2
// columns and lane-owned warp tables (tools/mf_ab.py's cas128, cas64,
// owned).
// Interp (K4): the corners from the sample's own lookup as K2+K4 finds them
// (svox::corners_keep, kCornerReuseMf), the sigma summed in corner order.
// K9c's Kd-16 instances, and K9d's Kd-16 bake interp ones, are compiled for 7
// resident blocks an SM (kMfBounded).
// The addends (sw_n * ((weight * s) * (1 - s)) * g, bones in order), their
// gate (sw > 0), the clamped joint index and the blend's arithmetic order
// are the earlier kernel's: K9c's output is unchanged and K9d's gradient
// differs only in the order of its sums.

// Shared memory a vector instance may take for the joint table (and K9d's
// gradient table), in bytes (ops/render_aux.py's KERNEL_MF_VECTOR_SMEM).
// A K9d table of more (up to 48 KB, J * (Kd | 1) <= kMaxJointTable) takes
// the !V instance, which raises the launch's dynamic shared memory
// attribute to its size, leaving room for the tree walk's interp path
// slots.
constexpr size_t kSmemBudget = 40 * 1024;

struct MotionParams {
  March m;
  const float* jf;    // (J, Kd) joint features
  int J;
  int Kd;
  const float* sw;    // (>= M, nb) skinning weights
  const int32_t* ji;  // (>= M, nb) joint indices
  int nb;
  float sigma_thresh;
  float stop_thresh;
  float bg;
  const float* grad_out;  // (B, Kd), backward
  float* out;             // (B, Kd) forward output, or the (J, Kd) gradient
};

// Kd capacity of the instance that runs Kd columns, or 0 past the largest.
__host__ __device__ constexpr int kd_capacity(int kd) {
  return kd < 1 ? 0 : kd <= 4 ? 4 : kd <= 8 ? 8 : kd <= 16 ? 16 : kd <= 32 ? 32 : 0;
}

// Floats a row of a vector instance's shared joint table: Kd padded to an
// odd number of float4s.
__host__ __device__ constexpr int row_stride(int kd) { return 4 * (((kd + 3) / 4) | 1); }

// Floats a row of K9d's shared gradient table, and the floats before the
// joint table that follows it (16-byte aligned).
__host__ __device__ constexpr int table_stride(int kd) { return kd | 1; }
__host__ __device__ constexpr int table_floats(int J, int kd) { return (J * table_stride(kd) + 3) / 4 * 4; }

// K4's corner lookups in the motion-feature marches (svox::corners_keep):
// K9c's on the tree walk the own corner's row and the other corners'
// descents started on the own path (2), as K2+K4's width 4 makes them
// (render_fwd.cuh kCornerReuse); K9d's, and both on the bake, the own
// corner's row alone (1: the path's registers cost K9d more than its loads
// save, tools/mf_ab.py's lever2_bwd); 0 is svox::sample_corners' 9 lookups
// (sample_at). The rows equal sample_corners' bit for bit.
template <bool kBackward>
constexpr int kCornerReuseMf = S::kBaked || kBackward ? 1 : 2;

// Whether a kernel instance is compiled for 7 resident blocks of kThreads an
// SM (72 registers a thread; its _7 entry): K9c's Kd-16 instances and
// K9d's Kd-16 bake interp ones, where the resident warps gained beat what
// the cap costs (7-13% on the bake's interp instances, 0-1% elsewhere). The
// others have no bound: K9d's other Kd-16 instances tied or lost up to 1%
// under it (tools/mf_ab.py's no_bound), the cap would spill the Kd-32
// instances (104-128 registers without it), and a bound of one block an SM
// is no bound: its K9d ran 1.2x slower.
template <bool kBackward, int KD>
constexpr bool kMfBounded = KD == 16 && (!kBackward || (svox::kInterp && S::kBaked));

// Copies jf into a shared table of rows row_stride(Kd) apart, zero past Kd.
__device__ __forceinline__ void load_joint_table(const MotionParams& p, float* sjf) {
  const int row = row_stride(p.Kd);
  for (int e = threadIdx.x; e < p.J * row; e += blockDim.x) {
    const int j = e / row, k = e - j * row;
    sjf[e] = k < p.Kd ? __ldg(p.jf + static_cast<size_t>(j) * p.Kd + k) : 0.f;
  }
}

// Row idx's bones (vector instances): the weights as stored, the joint
// indices clamped to [0, J).
struct Bones4 {
  float w[4];
  int j[4];
};

__device__ __forceinline__ Bones4 load_bones4(const MotionParams& p, int32_t idx) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(p.sw) + idx);
  const int4 q = __ldg(reinterpret_cast<const int4*>(p.ji) + idx);
  return {{s.x, s.y, s.z, s.w},
          {min(max(q.x, 0), p.J - 1), min(max(q.y, 0), p.J - 1), min(max(q.z, 0), p.J - 1),
           min(max(q.w, 0), p.J - 1)}};
}

// The LBS blend into b[0, KD): bones in order, weight sw > 0 ? sw : 0,
// joint index clamped to [0, J). V: the bones of bo and the shared joint
// table (its zero columns add 0 past Kd); else row idx's bones and jf.
template <int KD, bool V>
__device__ __forceinline__ void blend(const MotionParams& p, const float* sjf, const Bones4& bo, int32_t idx,
                                      float* b) {
#pragma unroll
  for (int k = 0; k < KD; ++k) b[k] = 0.f;
  if constexpr (V) {
    const int rs4 = row_stride(p.Kd) / 4;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float w = bo.w[n] > 0.f ? bo.w[n] : 0.f;
      const float4* f = reinterpret_cast<const float4*>(sjf) + bo.j[n] * rs4;
#pragma unroll
      for (int q = 0; q < KD / 4; ++q) {
        if (4 * q < p.Kd) {
          const float4 v = f[q];
          b[4 * q] = b[4 * q] + w * v.x;
          b[4 * q + 1] = b[4 * q + 1] + w * v.y;
          b[4 * q + 2] = b[4 * q + 2] + w * v.z;
          b[4 * q + 3] = b[4 * q + 3] + w * v.w;
        }
      }
    }
  } else {
    const float* swr = p.sw + static_cast<size_t>(idx) * p.nb;
    const int32_t* jir = p.ji + static_cast<size_t>(idx) * p.nb;
    for (int n = 0; n < p.nb; ++n) {
      const float s = __ldg(swr + n);
      const float w = s > 0.f ? s : 0.f;
      const float* f = p.jf + static_cast<size_t>(min(max(__ldg(jir + n), 0), p.J - 1)) * p.Kd;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        if (k < p.Kd) b[k] = b[k] + w * __ldg(f + k);
      }
    }
  }
}

template <int KD, bool V>
__device__ __forceinline__ void mf_fwd(const MotionParams& p) {
  extern __shared__ float4 smem4[];
  float* sjf = reinterpret_cast<float*>(smem4);
  if constexpr (V) {
    load_joint_table(p, sjf);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.m.B) return;
  float* out = p.out + static_cast<size_t>(i) * p.Kd;
  Ray r;
  if (!setup_ray(p.m, i, r, true)) {
    // A ray that misses the cube outputs 0.
    if constexpr (V) {
#pragma unroll
      for (int q = 0; q < KD / 4; ++q) {
        if (4 * q < p.Kd) reinterpret_cast<float4*>(out)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int k = 0; k < p.Kd; ++k) out[k] = 0.f;
    }
    return;
  }
  float acc[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) acc[k] = 0.f;
  float L = 1.f;
  bool stopped = false;
  constexpr int kReuse = kCornerReuseMf<false>;
  typename S::Keep keep;
  init_keep<S, kReuse>(keep);
  float t = r.tmin;
  for (int step = 0; step < p.m.max_steps; ++step) {
    const Sample s = sample_mf<S, kReuse>(p.m, r, t, keep);
    if (s.sigma > p.sigma_thresh) {
      const float att = expf((-s.dt * r.ds) * s.sigma);
      if (s.resident) {
        const float weight = L * (1.f - att);
        Bones4 bo;
        if constexpr (V) bo = load_bones4(p, s.idx);
        float b[KD];
        blend<KD, V>(p, sjf, bo, s.idx, b);
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          if (k < p.Kd) acc[k] = acc[k] + weight * svox::sigmoid(b[k]);
        }
      }
      L = L * att;
      if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
        stopped = true;
        break;
      }
    }
    t = t + s.dt;
    if (!(t < r.tmax)) break;
  }
#pragma unroll
  for (int k = 0; k < KD; ++k) acc[k] = stopped ? acc[k] * (1.f / (1.f - L)) : acc[k] + L * p.bg;
  if constexpr (V) {
#pragma unroll
    for (int q = 0; q < KD / 4; ++q) {
      if (4 * q < p.Kd) {
        reinterpret_cast<float4*>(out)[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (k < p.Kd) out[k] = acc[k];
    }
  }
}

// One bone's addends w * gb[k] into its row of the gradient table, one
// shared-memory atomic a column.
template <int KD>
__device__ __forceinline__ void add_bone(float* row, float w, const float* gb, int Kd) {
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    if (k < Kd) atomicAdd(row + k, w * gb[k]);
  }
}

template <int KD, bool V>
__device__ __forceinline__ void mf_bwd(const MotionParams& p) {
  // Shared memory: this block's (J, Kd) gradient, rows table_stride(Kd)
  // apart, then (V) the joint table.
  extern __shared__ float4 smem4[];
  const int rs = table_stride(p.Kd);
  float* table = reinterpret_cast<float*>(smem4);
  float* sjf = table + table_floats(p.J, p.Kd);
  for (int e = threadIdx.x; e < p.J * rs; e += blockDim.x) table[e] = 0.f;
  if constexpr (V) load_joint_table(p, sjf);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  if (i < p.m.B && setup_ray(p.m, i, r, true)) {
    float g[KD];
    const float* go = p.grad_out + static_cast<size_t>(i) * p.Kd;
#pragma unroll
    for (int q = 0; q < KD / 4; ++q) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (V) {
        if (4 * q < p.Kd) v = __ldg(reinterpret_cast<const float4*>(go) + q);
      } else {
        v.x = 4 * q < p.Kd ? __ldg(go + 4 * q) : 0.f;
        v.y = 4 * q + 1 < p.Kd ? __ldg(go + 4 * q + 1) : 0.f;
        v.z = 4 * q + 2 < p.Kd ? __ldg(go + 4 * q + 2) : 0.f;
        v.w = 4 * q + 3 < p.Kd ? __ldg(go + 4 * q + 3) : 0.f;
      }
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
    constexpr int kReuse = kCornerReuseMf<true>;
    typename S::Keep keep;
    init_keep<S, kReuse>(keep);
    float L = 1.f;
    float t = r.tmin;
    for (int step = 0; step < p.m.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      const Sample s = sample_mf<S, kReuse>(p.m, r, t, keep);
      if (s.sigma > 0.f) {
        const float att = expf((-s.dt * r.ds) * s.sigma);
        // Under interp an empty leaf attenuates but has no LBS row to add to.
        if (!svox::kInterp || s.resident) {
          const float weight = L * (1.f - att);
          Bones4 bo;
          if constexpr (V) bo = load_bones4(p, s.idx);
          float gb[KD];
          blend<KD, V>(p, sjf, bo, s.idx, gb);
#pragma unroll
          for (int k = 0; k < KD; ++k) {
            const float sk = svox::sigmoid(gb[k]);
            gb[k] = ((weight * sk) * (1.f - sk)) * g[k];
          }
          if constexpr (V) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              if (bo.w[n] > 0.f) add_bone<KD>(table + bo.j[n] * rs, bo.w[n], gb, p.Kd);
            }
          } else {
            const float* swr = p.sw + static_cast<size_t>(s.idx) * p.nb;
            const int32_t* jir = p.ji + static_cast<size_t>(s.idx) * p.nb;
            for (int n = 0; n < p.nb; ++n) {
              const float w = __ldg(swr + n);
              if (w > 0.f) add_bone<KD>(table + min(max(__ldg(jir + n), 0), p.J - 1) * rs, w, gb, p.Kd);
            }
          }
        }
        L = L * att;
      }
      t = t + s.dt;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.J * p.Kd; e += blockDim.x) {
    const int j = e / p.Kd;
    const float v = table[j * rs + e - j * p.Kd];
    if (v != 0.f) atomicAdd(p.out + e, v);
  }
}

// The kernels' entries, with and without the bound (kMfBounded).
template <int KD, bool V>
__global__ void __launch_bounds__(kThreads) mf_fwd_kernel(const MotionParams p) { mf_fwd<KD, V>(p); }
template <int KD, bool V>
__global__ void __launch_bounds__(kThreads, 7) mf_fwd_kernel_7(const MotionParams p) { mf_fwd<KD, V>(p); }
template <int KD, bool V>
__global__ void __launch_bounds__(kThreads) mf_bwd_kernel(const MotionParams p) { mf_bwd<KD, V>(p); }
template <int KD, bool V>
__global__ void __launch_bounds__(kThreads, 7) mf_bwd_kernel_7(const MotionParams p) { mf_bwd<KD, V>(p); }

// The entry of an instance (only that one is compiled).
template <int KD, bool V, bool kBackward>
void (*mf_kernel())(MotionParams) {
  if constexpr (kBackward) {
    if constexpr (kMfBounded<true, KD>) return mf_bwd_kernel_7<KD, V>;
    else return mf_bwd_kernel<KD, V>;
  } else {
    if constexpr (kMfBounded<false, KD>) return mf_fwd_kernel_7<KD, V>;
    else return mf_fwd_kernel<KD, V>;
  }
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int KD, bool V>
cudaError_t launch_mf(const MotionParams& p, bool backward, size_t table_bytes, size_t jf_bytes,
                      cudaStream_t stream) {
  const dim3 grid((p.m.B + kThreads - 1) / kThreads);
  const size_t smem = table_bytes + (V ? jf_bytes : 0);
  if (!backward) {
    const auto kernel = mf_kernel<KD, V, false>();
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  const auto kernel = mf_kernel<KD, V, true>();
  if (smem > kSmemBudget) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instance of the launch's width: V at 4, which the launch must allow
// (else cudaErrorInvalidValue), !V at 1.
template <int KD>
cudaError_t launch_mf(const MotionParams& p, bool backward, int width, cudaStream_t stream) {
  const size_t table_bytes = backward ? static_cast<size_t>(table_floats(p.J, p.Kd)) * sizeof(float) : 0;
  const size_t jf_bytes = static_cast<size_t>(p.J) * row_stride(p.Kd) * sizeof(float);
  if (width == 1) return launch_mf<KD, false>(p, backward, table_bytes, jf_bytes, stream);
  if (width != 4 || p.nb != 4 || p.Kd % 4 != 0 || !aligned16(p.sw) || !aligned16(p.ji) ||
      !aligned16(backward ? p.grad_out : p.out) || table_bytes + jf_bytes > kSmemBudget) {
    return cudaErrorInvalidValue;
  }
  return launch_mf<KD, true>(p, backward, table_bytes, jf_bytes, stream);
}

cudaError_t run_mf(const MotionParams& p, bool backward, int width, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (p.m.B <= 0) return cudaSuccess;
  if (p.J < 1 || p.nb < 0) return cudaErrorInvalidValue;
  if (backward && p.J * (p.Kd | 1) > kMaxJointTable) return cudaErrorInvalidValue;
  switch (kd_capacity(p.Kd)) {
    case 4: return launch_mf<4>(p, backward, width, stream);
    case 8: return launch_mf<8>(p, backward, width, stream);
    case 16: return launch_mf<16>(p, backward, width, stream);
    case 32: return launch_mf<32>(p, backward, width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Leading arguments of the three entry points: s the structure
// (svox::StructDesc, host memory); rays (B, 3) f32 (origins, dirs; world
// space); offset/scaling (3,) f32; features (M, D) of the source's pool
// type, with scale and zero (D,) f32 for an int8 pool, else null (only
// column D - 1 is read). All pointers but s are device pointers. Each
// returns a cudaError_t.

// K9b. found (B,) bool, t_hit (B,) f32, row (B,) i32, frac (B, 3) f32.
extern "C" int SVOX_NAME(svox_first_hit)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, float sigma_thresh,
    bool* found, float* t_hit, int32_t* row, float* frac, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  const FirstHitParams p{{S::from(*s), origins, dirs, B, offset, scaling,
                          svox::make_pool<svox::Pool>(features, scale, zero), M, D, step_size,
                          max_steps},
                         sigma_thresh, found, t_hit, row, frac};
  const dim3 grid((B + kThreads - 1) / kThreads);
  first_hit_kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K9c. jf (J, Kd) f32 with Kd <= 32; sw (>= M, nb) f32; ji (>= M, nb)
// i32; out (B, Kd) f32; width 4 (the V instance, where the launch allows
// it) or 1.
extern "C" int SVOX_NAME(svox_mf_fwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, const float* jf, int J,
    int Kd, const float* sw, const int32_t* ji, int nb, float sigma_thresh,
    float stop_thresh, float bg, float* out, int width, int device, cudaStream_t stream) {
  const MotionParams p{{S::from(*s), origins, dirs, B, offset, scaling,
                        svox::make_pool<svox::Pool>(features, scale, zero), M, D, step_size,
                        max_steps},
                       jf, J, Kd, sw, ji, nb, sigma_thresh, stop_thresh, bg,
                       nullptr, out};
  return run_mf(p, false, width, device, stream);
}

// K9d. As svox_mf_fwd, plus grad_out (B, Kd) f32 and grad (J, Kd) f32,
// zeroed by the caller; J * (Kd | 1) <= 12288.
extern "C" int SVOX_NAME(svox_mf_bwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, const float* jf, int J,
    int Kd, const float* sw, const int32_t* ji, int nb, const float* grad_out,
    float* grad, int width, int device, cudaStream_t stream) {
  const MotionParams p{{S::from(*s), origins, dirs, B, offset, scaling,
                        svox::make_pool<svox::Pool>(features, scale, zero), M, D, step_size,
                        max_steps},
                       jf, J, Kd, sw, ji, nb, 0.f, 0.f, 0.f, grad_out, grad};
  return run_mf(p, true, width, device, stream);
}
