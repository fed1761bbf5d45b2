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
// sample. The forward's extra reads are two (M, nb) tables (one row
// each per contributing sample) and a J x Kd joint table small enough to
// stay in L1 (__ldg). The backward's problem is contention: every
// contributing sample of every hit ray adds into the same J * Kd floats
// (512 at J 32, Kd 16). Each block therefore sums into a copy of the
// table in shared memory and adds its non-zero entries to the global
// table once, at its end. The copy's rows are padded to an odd stride
// (Kd | 1), so lanes adding one column into different joints hit
// different banks; it takes J * (Kd | 1) * 4 bytes of dynamic shared
// memory, at most 48 KB (the wrapper raises above). Kd is a register capacity (4, 8, 16
// or 32, template instances) with Kd a run-time bound inside, as K2 holds
// colors; nb is a run-time loop bound.
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
// corners' (sample_at), also in an empty leaf, which is then "over" but
// not resident for the first hit, and attenuates without blending in the
// motion-feature passes.
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

// ---------------------------------------------------------------------
// K9b: first hit

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
    for (int step = 0; step < p.m.max_steps; ++step) {
      const Sample s = sample_at(p.m, r, t);
      if (s.sigma > p.sigma_thresh) {
        const bool first = !found_t;
        if (first) {
          found_t = true;
          t_hit = t;
        }
        if (s.resident) {
          found = true;
          same = first;
          row = s.idx;
          fx = s.leaf.fx;
          fy = s.leaf.fy;
          fz = s.leaf.fz;
          break;
        }
      }
      t = t + s.dt;
      if (!(t < r.tmax)) break;
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

// The LBS blend of row idx into b[0, Kd): bones in order, weight
// sw > 0 ? sw : 0.
template <int KD>
__device__ __forceinline__ void blend(const MotionParams& p, int32_t idx, float* b) {
#pragma unroll
  for (int k = 0; k < KD; ++k) b[k] = 0.f;
  const float* swr = p.sw + static_cast<size_t>(idx) * p.nb;
  const int32_t* jir = p.ji + static_cast<size_t>(idx) * p.nb;
  for (int n = 0; n < p.nb; ++n) {
    const float s = __ldg(swr + n);
    const float w = s > 0.f ? s : 0.f;
    const int j = min(max(__ldg(jir + n), 0), p.J - 1);
    const float* f = p.jf + static_cast<size_t>(j) * p.Kd;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (k < p.Kd) b[k] = b[k] + w * __ldg(f + k);
    }
  }
}

template <int KD>
__global__ void __launch_bounds__(kThreads) mf_fwd_kernel(const MotionParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.m.B) return;
  float* out = p.out + static_cast<size_t>(i) * p.Kd;
  Ray r;
  if (!setup_ray(p.m, i, r, true)) {
    for (int k = 0; k < p.Kd; ++k) out[k] = 0.f;
    return;
  }
  float acc[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) acc[k] = 0.f;
  float L = 1.f;
  bool stopped = false;
  float t = r.tmin;
  for (int step = 0; step < p.m.max_steps; ++step) {
    const Sample s = sample_at(p.m, r, t);
    if (s.sigma > p.sigma_thresh) {
      const float att = expf((-s.dt * r.ds) * s.sigma);
      if (s.resident) {
        const float weight = L * (1.f - att);
        float b[KD];
        blend<KD>(p, s.idx, b);
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
  for (int k = 0; k < KD; ++k) {
    if (k < p.Kd) out[k] = stopped ? acc[k] * (1.f / (1.f - L)) : acc[k] + L * p.bg;
  }
}

template <int KD>
__global__ void __launch_bounds__(kThreads) mf_bwd_kernel(const MotionParams p) {
  extern __shared__ float table[];  // this block's (J, Kd) gradient, rows `stride` apart
  const int stride = p.Kd | 1;
  for (int j = threadIdx.x; j < p.J * stride; j += blockDim.x) table[j] = 0.f;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  if (i < p.m.B && setup_ray(p.m, i, r, true)) {
    float g[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) g[k] = k < p.Kd ? p.grad_out[static_cast<size_t>(i) * p.Kd + k] : 0.f;
    float L = 1.f;
    float t = r.tmin;
    for (int step = 0; step < p.m.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      const Sample s = sample_at(p.m, r, t);
      if constexpr (svox::kInterp) {
        // An empty leaf attenuates but has no LBS row to add to.
        if (s.sigma > 0.f && !s.resident) {
          L = L * expf((-s.dt * r.ds) * s.sigma);
          t = t + s.dt;
          continue;
        }
      }
      if (s.sigma > 0.f) {
        const float att = expf((-s.dt * r.ds) * s.sigma);
        const float weight = L * (1.f - att);
        float gb[KD];
        blend<KD>(p, s.idx, gb);
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          const float sk = svox::sigmoid(gb[k]);
          gb[k] = ((weight * sk) * (1.f - sk)) * g[k];
        }
        const float* swr = p.sw + static_cast<size_t>(s.idx) * p.nb;
        const int32_t* jir = p.ji + static_cast<size_t>(s.idx) * p.nb;
        for (int n = 0; n < p.nb; ++n) {
          const float w = __ldg(swr + n);
          if (w > 0.f) {
            float* dst = table + min(max(__ldg(jir + n), 0), p.J - 1) * stride;
#pragma unroll
            for (int k = 0; k < KD; ++k) {
              if (k < p.Kd) atomicAdd(dst + k, w * gb[k]);
            }
          }
        }
        L = L * att;
      }
      t = t + s.dt;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.J * p.Kd; j += blockDim.x) {
    const float v = table[(j / p.Kd) * stride + j % p.Kd];
    if (v != 0.f) atomicAdd(p.out + j, v);
  }
}

template <int KD>
cudaError_t launch_mf(const MotionParams& p, bool backward, cudaStream_t stream) {
  const dim3 grid((p.m.B + kThreads - 1) / kThreads);
  if (backward) {
    const size_t smem = static_cast<size_t>(p.J) * (p.Kd | 1) * sizeof(float);
    mf_bwd_kernel<KD><<<grid, kThreads, smem, stream>>>(p);
  } else {
    mf_fwd_kernel<KD><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t run_mf(const MotionParams& p, bool backward, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (p.m.B <= 0) return cudaSuccess;
  if (p.J < 1 || p.nb < 0) return cudaErrorInvalidValue;
  if (backward && p.J * (p.Kd | 1) > kMaxJointTable) return cudaErrorInvalidValue;
  switch (kd_capacity(p.Kd)) {
    case 4: return launch_mf<4>(p, backward, stream);
    case 8: return launch_mf<8>(p, backward, stream);
    case 16: return launch_mf<16>(p, backward, stream);
    case 32: return launch_mf<32>(p, backward, stream);
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
// i32; out (B, Kd) f32.
extern "C" int SVOX_NAME(svox_mf_fwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, const float* jf, int J,
    int Kd, const float* sw, const int32_t* ji, int nb, float sigma_thresh,
    float stop_thresh, float bg, float* out, int device, cudaStream_t stream) {
  const MotionParams p{{S::from(*s), origins, dirs, B, offset, scaling,
                        svox::make_pool<svox::Pool>(features, scale, zero), M, D, step_size,
                        max_steps},
                       jf, J, Kd, sw, ji, nb, sigma_thresh, stop_thresh, bg,
                       nullptr, out};
  return run_mf(p, false, device, stream);
}

// K9d. As svox_mf_fwd, plus grad_out (B, Kd) f32 and grad (J, Kd) f32,
// zeroed by the caller; J * (Kd | 1) <= 12288.
extern "C" int SVOX_NAME(svox_mf_bwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, const float* jf, int J,
    int Kd, const float* sw, const int32_t* ji, int nb, const float* grad_out,
    float* grad, int device, cudaStream_t stream) {
  const MotionParams p{{S::from(*s), origins, dirs, B, offset, scaling,
                        svox::make_pool<svox::Pool>(features, scale, zero), M, D, step_size,
                        max_steps},
                       jf, J, Kd, sw, ji, nb, 0.f, 0.f, 0.f, grad_out, grad};
  return run_mf(p, true, device, stream);
}
