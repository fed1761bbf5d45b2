// K3: the backward ray march, the gradient of a render with respect to
// the feature pool, on either structure. Included by render_bwd.cu (the
// tree walk: svox_render_bwd, svox_opacity_bwd) and render_bwd_baked.cu
// (the bake: the same names with _baked), which define SVOX_STRUCTURE and
// SVOX_SUFFIX first. The structure's lookup, cull and skip boxes are K2's
// (common.cuh).
//
// Replaces: svox_t_tpu/ops/render.py `_volume_render_bwd_impl` with
// `_grad_rows`, `_round_grad_rows`, and the TPU scatter workarounds
// `_compact_map`, `_scatter_add_compact` and `_tape_append`. The TPU
// version re-marched all rays in K-sample rounds and scattered each
// round's gradient rows through a compaction ladder or a tape; this
// kernel is shaped like the CUDA reference's trace_ray_backward: one
// thread per ray re-marches its ray sample by sample and adds each
// contributing sample's gradient row into the (M, D) buffer with float
// atomicAdd. The wrapper zeroes the buffer.
//
// The backward marches under its own rules, which differ from the
// forward's: a ray takes samples while hit and t < tmax (a ray with
// tmin == tmax takes none), up to max_steps; a sample contributes where
// its row is < M and sigma > 0, whatever sigma_thresh is; there is no
// early stop; L attenuates on every contributing sample. Per sample:
//   weight      = L * (1 - att),  att = exp(-dt * delta_scale * sigma)
//   s_c         = sigmoid color (RGBA) or sigmoid of the windowed basis
//                 sum (SH/SG/ASG; re-evaluated per sample from the
//                 rotated view direction when matrices are given)
//   total_color = sum_c s_c * g_c
//   coefficient gradient at column c * basis_dim + k (RGBA: c):
//                 (weight * s_c (1 - s_c)) * g_c * basis_k
//   sigma gradient at column D - 1:
//                 dt*ds * (total_color * L_after - acc_after)
//                 + dt*ds * (g_alpha * L_ray)
// Single pass (exact mode with the forward output): acc starts at
// sum_c out_c * g_c and falls by weight * total_color per contributing
// sample, L_ray = 1 - out_alpha; one march writes both. Two passes
// otherwise: pass 1 writes the coefficient rows and sums accum, then adds
// L_ray * bg * sum_c g_c with L_ray its own final L; pass 2 re-marches and
// writes only the sigma column. One thread runs both passes in turn.
//
// Bound on an H100: latency, as K2 — the same dependent descent chain per
// sample — plus atomics: every contributing sample adds D floats into a
// 157 MB buffer (depth-9 SH9 scene), which does not fit in the 50 MB L2,
// and neighbouring rays of a warp often hit the same leaf row, so their
// atomics on one address serialize. The design answer: one thread per ray
// with the basis, the colors' output gradients and the ray totals in
// registers (format, rotation and the basis capacity are template
// parameters, as in K2);
// fire-and-forget atomicAdd (no return value, so the compiler emits RED
// operations that do not stall the thread); and no work at all for
// samples in empty space or with sigma 0, which are most of a ray.
//
// Arithmetic follows the plain PyTorch version (ops/render.py
// `volume_render_backward_plain`) operation for operation, and the
// library is built with -fmad=false, so the samples are the plain
// version's; only the order in which atomics sum differs.
//
// K9a, the opacity VJP (svox_opacity_bwd, `opacity_bwd_kernel`), runs the
// sigma-only instance of this kernel's march (kSigmaOnly). Replaces: svox_t_tpu/ops/render_aux.py
// `_opacity_bwd_impl`, the gradient of `opacity_render` (the forward is
// K2's alpha column). A thread reads only the sigma column of a row: no
// basis, no colors, no color gradients. Per contributing sample
// (row < M, sigma > 0) it adds dt*ds * (g_alpha * L_ray) into column
// D - 1. Single pass with the forward alpha (L_ray = 1 - alpha, exact
// options); otherwise pass A forms L_ray under the backward's sigma > 0
// rule and writes nothing, then pass B adds. This equals K3's sigma
// column with zero color gradients (ops/render_aux.py
// `opacity_backward_plain`). Bound on an H100: as K3, the descent chain
// per sample; one 4-byte atomic per contributing sample.
//
// Feature pools (K5): the build defines SVOX_POOL svox::PoolBF16
// on each structure, nearest and interp (svox_render_bwd_bf16,
// svox_opacity_bwd_bf16, ...): the row loads are bf16, the arithmetic and
// the atomics into the (M, D) gradient float32; the wrapper casts the
// float32 gradient to bf16 once. A quantized pool takes no gradient, so
// there is no int8 instance.
//
// Trilinear interpolation (K4): render_bwd_interp.cu and
// render_bwd_baked_interp.cu define SVOX_INTERP 1 (svox_render_bwd_interp,
// svox_opacity_bwd_interp and their _baked_interp twins), whose `march`
// takes its `if constexpr (svox::kInterp)` step: no cull, every sample
// reads its 8 corners, a sample contributes where the interpolated sigma
// is > 0, and each of its gradients goes to the corners' rows, weighted
// (8x the atomics; the simple version, not yet made fast).

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxColor = 16;

template <class S>
struct Params {
  S st;
  const float* origins;
  const float* dirs;
  const float* vdirs;
  int B;
  const float* offset;
  const float* scaling;
  svox::Pool features;
  int M;
  int D;
  const float* tmats;
  const float* extra;
  int ld_extra;
  int basis_dim;
  int min_comp;
  int max_comp;
  int n_color;
  float step_size;
  float bg;
  int max_steps;
  const float* grad_out;
  const float* out_res;  // forward output for the single pass, else null
  float* grad;
};

// The tree-space ray and its view direction.
struct Ray : svox::Ray {
  float vx, vy, vz;
};

// Add v * w_n into column col of every corner's gradient row.
template <class S>
__device__ __forceinline__ void add_corners(const Params<S>& p, const svox::Corners& cn, int col,
                                            float v) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (cn.row[n] >= 0) atomicAdd(p.grad + static_cast<size_t>(cn.row[n]) * p.D + col, cn.w[n] * v);
  }
}

// One backward march. kColor: add the coefficient rows and sum accum
// upward; kSigma: add the sigma column, with acc falling from its start.
// kSigmaOnly: read only sigma and add dt*ds * (g_alpha * L_ray) (with
// kSigma) or nothing (pass A). Returns the final L in L.
template <class S, int FMT, int BD, bool kRot, bool kColor, bool kSigma, bool kSigmaOnly>
__device__ __forceinline__ void march(const Params<S>& p, const Ray& r,
                                      float* basis, const float* g,
                                      float g_alpha, float L_ray, float& L,
                                      float& acc) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  const int nc = p.n_color;
  const int nb = FMT == svox::kSH ? BD : p.basis_dim;
  float t = r.tmin;
  L = 1.f;
  for (int step = 0; step < p.max_steps; ++step) {
    if (!(t < r.tmax)) break;
    float dt;
    const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
    const int32_t idx = leaf.row;
    if constexpr (svox::kInterp) {
      // K4: every sample reads its 8 corners and contributes where the
      // interpolated sigma is > 0, also in an empty leaf; it rotates its
      // basis by its own row's matrix (row 0 where that is empty, as in the
      // JAX package), and each gradient goes into the corners' rows
      // weighted by w_n: coefficient k of color c gets w_n * (a_c *
      // basis_k), column D - 1 gets w_n * the sigma gradient. Up to 8x the
      // atomics of nearest mode.
      const svox::Corners cn = svox::sample_corners(p.st, r, t, leaf.cube_sz, p.M);
      const float sigma = svox::interp_sum(cn, [&](int32_t row) {
        return svox::ld(p.features + static_cast<size_t>(row) * p.D + p.D - 1);
      });
      if (sigma > 0.f) {
        const float att = expf((-dt * r.ds) * sigma);
        if constexpr (kSigmaOnly) {
          if constexpr (kSigma) add_corners(p, cn, p.D - 1, (dt * r.ds) * (g_alpha * L_ray));
          L = L * att;
          t = t + dt;
          continue;
        }
        const float weight = L * (1.f - att);
        if constexpr (FMT != svox::kRGBA && kRot) {
          const int32_t gi = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0;
          const float* m = p.tmats + static_cast<size_t>(gi) * 16;
          const float rx = (m[0] * r.vx + m[1] * r.vy) + m[2] * r.vz;
          const float ry = (m[4] * r.vx + m[5] * r.vy) + m[6] * r.vz;
          const float rz = (m[8] * r.vx + m[9] * r.vy) + m[10] * r.vz;
          svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb, p.min_comp, p.max_comp,
                                    basis);
        }
        float z[kMaxColor];
        svox::interp_logits<FMT, kB, kMaxColor>(cn, p.features, p.D, nc, nb, basis, z);
        float total_color = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxColor; ++c) {
          if (c < nc) {
            const float s = svox::sigmoid(z[c]);
            total_color = total_color + s * g[c];
            if constexpr (kColor) {
              const float a = (weight * (s * (1.f - s))) * g[c];
              // The corner loop is not unrolled (see svox::interp_logits).
#pragma unroll 1
              for (int n = 0; n < 8; ++n) {
                if (cn.row[n] < 0) continue;
                float* grow = p.grad + static_cast<size_t>(cn.row[n]) * p.D;
                const float w = cn.w[n];
                if constexpr (FMT == svox::kRGBA) {
                  atomicAdd(grow + c, w * a);
                } else {
#pragma unroll
                  for (int k = 0; k < kB; ++k) {
                    if (k < nb) atomicAdd(grow + c * nb + k, w * (a * basis[k]));
                  }
                }
              }
            }
          }
        }
        const float L_after = L * att;
        if constexpr (kSigma) {
          const float acc_after = acc - weight * total_color;
          const float dts = dt * r.ds;
          add_corners(p, cn, p.D - 1,
                      dts * (total_color * L_after - acc_after) + dts * (g_alpha * L_ray));
          acc = acc_after;
        } else {
          acc = acc + weight * total_color;
        }
        L = L_after;
      }
    } else if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
      const auto row = p.features + static_cast<size_t>(idx) * p.D;
      float* grow = p.grad + static_cast<size_t>(idx) * p.D;
      const float sigma = svox::ld(row + p.D - 1);
      if (sigma > 0.f) {
        const float att = expf((-dt * r.ds) * sigma);
        if constexpr (kSigmaOnly) {
          if constexpr (kSigma) atomicAdd(grow + p.D - 1, (dt * r.ds) * (g_alpha * L_ray));
          L = L * att;
          t = t + dt;
          continue;
        }
        const float weight = L * (1.f - att);
        if constexpr (FMT != svox::kRGBA && kRot) {
          const float* m = p.tmats + static_cast<size_t>(idx) * 16;
          const float rx = (m[0] * r.vx + m[1] * r.vy) + m[2] * r.vz;
          const float ry = (m[4] * r.vx + m[5] * r.vy) + m[6] * r.vz;
          const float rz = (m[8] * r.vx + m[9] * r.vy) + m[10] * r.vz;
          svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb,
                                    p.min_comp, p.max_comp, basis);
        }
        float total_color = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxColor; ++c) {
          if (c < nc) {
            float s;
            if constexpr (FMT == svox::kRGBA) {
              s = svox::sigmoid(svox::ld(row + c));
            } else {
              const auto coef = row + c * nb;
              float z = basis[0] * svox::ld(coef);
#pragma unroll
              for (int k = 1; k < kB; ++k) {
                if (k < nb) z = z + basis[k] * svox::ld(coef + k);
              }
              s = svox::sigmoid(z);
            }
            total_color = total_color + s * g[c];
            if constexpr (kColor) {
              const float a = (weight * (s * (1.f - s))) * g[c];
              if constexpr (FMT == svox::kRGBA) {
                atomicAdd(grow + c, a);
              } else {
#pragma unroll
                for (int k = 0; k < kB; ++k) {
                  if (k < nb) atomicAdd(grow + c * nb + k, a * basis[k]);
                }
              }
            }
          }
        }
        const float L_after = L * att;
        if constexpr (kSigma) {
          const float acc_after = acc - weight * total_color;
          const float dts = dt * r.ds;
          atomicAdd(grow + p.D - 1,
                    dts * (total_color * L_after - acc_after) + dts * (g_alpha * L_ray));
          acc = acc_after;
        } else {
          acc = acc + weight * total_color;
        }
        L = L_after;
      }
    }
    t = t + dt;
  }
}

template <class S, int FMT, int BD, bool kRot>
__global__ void __launch_bounds__(kThreads) render_bwd_kernel(const Params<S> p) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const int nc = p.n_color;

  // Rays that miss add nothing.
  Ray r;
  if (!svox::march_cull(p.st, r, svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r))) return;
  r.vx = p.vdirs[3 * i + 0];
  r.vy = p.vdirs[3 * i + 1];
  r.vz = p.vdirs[3 * i + 2];

  float basis[kB];
  if constexpr (FMT != svox::kRGBA && !kRot) {
    svox::eval_basis<FMT, BD>(r.vx, r.vy, r.vz, p.extra, p.ld_extra,
                              FMT == svox::kSH ? BD : p.basis_dim, p.min_comp,
                              p.max_comp, basis);
  }
  const float* go = p.grad_out + static_cast<size_t>(i) * (nc + 1);
  float g[kMaxColor];
#pragma unroll
  for (int c = 0; c < kMaxColor; ++c) g[c] = c < nc ? go[c] : 0.f;
  const float g_alpha = go[nc];

  // Sums over colors run in channel order, as in the plain version; the
  // loops run to kMaxColor so that g stays in registers.
  float L, acc;
  if (p.out_res != nullptr) {
    const float* o = p.out_res + static_cast<size_t>(i) * (nc + 1);
    acc = o[0] * g[0];
#pragma unroll
    for (int c = 1; c < kMaxColor; ++c) {
      if (c < nc) acc = acc + o[c] * g[c];
    }
    const float L_ray = 1.f - o[nc];
    march<S, FMT, BD, kRot, true, true, false>(p, r, basis, g, g_alpha, L_ray, L, acc);
  } else {
    acc = 0.f;
    march<S, FMT, BD, kRot, true, false, false>(p, r, basis, g, g_alpha, 0.f, L, acc);
    const float L_ray = L;
    float total_grad = g[0];
#pragma unroll
    for (int c = 1; c < kMaxColor; ++c) {
      if (c < nc) total_grad = total_grad + g[c];
    }
    acc = acc + (L_ray * p.bg) * total_grad;
    march<S, FMT, BD, kRot, false, true, false>(p, r, basis, g, g_alpha, L_ray, L, acc);
  }
}

template <class S, int FMT, int BD>
cudaError_t launch(const Params<S>& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) {
      render_bwd_kernel<S, FMT, BD, true><<<grid, kThreads, 0, stream>>>(p);
      return cudaGetLastError();
    }
  }
  render_bwd_kernel<S, FMT, BD, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K9a: the sigma-only instance. grad_out and out_res are (B, 1): g_alpha
// and the forward alpha (single pass), or out_res is null (two passes).
template <class S>
__global__ void __launch_bounds__(kThreads) opacity_bwd_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  Ray r;
  if (!svox::march_cull(p.st, r, svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r))) return;
  float L, acc = 0.f, L_ray;
  if (p.out_res != nullptr) {
    L_ray = 1.f - p.out_res[i];
  } else {
    march<S, svox::kRGBA, 0, false, false, false, true>(p, r, nullptr, nullptr, 0.f, 0.f, L,
                                                        acc);
    L_ray = L;
  }
  march<S, svox::kRGBA, 0, false, false, true, true>(p, r, nullptr, nullptr, p.grad_out[i],
                                                     L_ray, L, acc);
}

// Basis instances hold 1, 4, 9, 16 or 25 terms (svox::basis_capacity).
// The bf16 and int8 pool instances (K5) run SG and ASG of every size on the
// 25-term instance, behind its run-time bound: the same result, fewer
// instances to compile.
template <class S, int FMT>
cudaError_t launch_basis(const Params<S>& p, cudaStream_t stream) {
  if constexpr (FMT != svox::kSH && !svox::kFloatPool) {
    if (svox::basis_capacity(FMT, p.basis_dim) == 0) return cudaErrorInvalidValue;
    return launch<S, FMT, svox::kMaxBasis>(p, stream);
  } else {
    switch (svox::basis_capacity(FMT, p.basis_dim)) {
      case 1: return launch<S, FMT, 1>(p, stream);
      case 4: return launch<S, FMT, 4>(p, stream);
      case 9: return launch<S, FMT, 9>(p, stream);
      case 16: return launch<S, FMT, 16>(p, stream);
      case 25: return launch<S, FMT, 25>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// Arguments as svox_render_fwd, plus grad_out (B, n_color + 1) f32,
// out_res (B, n_color + 1) f32 (the forward output: single pass) or null
// (two passes), and grad (M, D) f32 whatever the pool's type, zeroed by
// the caller. All pointers but s are device pointers. Returns a
// cudaError_t.
extern "C" int SVOX_NAME(svox_render_bwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs,
    const float* vdirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, const float* tmats, int format, const float* extra,
    int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color, float step_size,
    float bg, int max_steps, const float* grad_out, const float* out_res,
    float* grad, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor) return cudaErrorInvalidValue;
  using S = SVOX_STRUCTURE;
  const Params<S> p{S::from(*s), origins, dirs, vdirs, B,
                    offset, scaling, svox::make_pool<svox::Pool>(features, scale, zero), M, D,
                    tmats, extra, ld_extra, basis_dim, min_comp, max_comp, n_color, step_size,
                    bg, max_steps, grad_out, out_res, grad};
  switch (format) {
    case svox::kRGBA: return launch<S, svox::kRGBA, 0>(p, stream);
    case svox::kSH: return launch_basis<S, svox::kSH>(p, stream);
    case svox::kSG: return launch_basis<S, svox::kSG>(p, stream);
    case svox::kASG: return launch_basis<S, svox::kASG>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K9a. s the structure; rays (B, 3) f32: origins, dirs; the rest as
// svox_render_fwd; grad_out (B, 1) f32; out_res (B, 1) f32 (the forward
// alpha: single pass) or null (two passes); grad (M, D) f32, zeroed by the
// caller, of which only column D - 1 is written. All pointers but s are
// device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_opacity_bwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, float step_size, int max_steps, const float* grad_out,
    const float* out_res, float* grad, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || M <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  const Params<S> p{S::from(*s), origins, dirs, dirs, B,
                    offset, scaling, svox::make_pool<svox::Pool>(features, scale, zero), M, D,
                    nullptr, nullptr, 0,
                    0, 0, 0, 0, step_size, 0.f,
                    max_steps, grad_out, out_res, grad};
  const dim3 grid((B + kThreads - 1) / kThreads);
  opacity_bwd_kernel<S><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
