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
// Two vector widths (the template parameter W, as K2's and K13d's). Width
// 1 is the earlier loop (`march`), kept as it was: every other row (SH4,
// SH16, SG, ASG, spare columns) and the reference width 4 is timed and
// held against. Width 4 (`march4`) takes the three-colour RGBA, SH1 and
// SH9 rows with no spare column (D = 4, 4, 28; n_color and D template
// constants, as K13c learned that run-time sizes cost 58%). The earlier
// loop read a row a column at a time and issued one scalar reduction per
// column (28 a contributing sample at SH9), and under interp one per
// column per corner (224), after 9 lookups from the root: the reductions
// into the 157 MB buffer, not the bytes, set its time. Width 4 changes
// loads, lookups and the grouping of the atomics, never an addend: the
// sample's row moves in 16-byte loads (8 of a bf16 row) into registers,
// each column is overwritten with its addend once it has been read (as
// K13d's put_grad), and the row is added with Hopper's vector float
// atomics, 7 reductions at SH9 (1 at D = 4). Under interp the corners come
// from the sample's own lookup (svox::corners_keep with K2+K4's levers,
// kCornerReuse4), sigma and the colours from one pass over the corners'
// rows in vectors (svox::interp_row4_pass), and the sample's gradient row
// G is formed once in registers, then w_n * G is added into each corner's
// row that exists: 56 vector reductions a sample at SH9 instead of 224
// scalar ones. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6),
// the reductions still hold 85-90% of K3+K4's time at the depth-9 SH9
// camera (a build without them ran 6.7x and 12.8x faster on the tree walk
// and the bake). Summing a warp's addends to one row first
// (`__match_any_sync` and shuffles) ran 1.02-2.26x slower; bounds of 6 or
// 8 blocks an SM won up to 8% on some cases, lost up to 12% on others and
// spilled the width-1 instances, so the kernel keeps ptxas's own register
// limit. tools/render_bwd_ab.py times the designs beside an earlier
// checkout's.
//
// Arithmetic follows the plain PyTorch version (ops/render.py
// `volume_render_backward_plain`) operation for operation, and the
// library is built with -fmad=false, so the samples are the plain
// version's; only the order in which atomics sum differs.
//
// K9a, the opacity VJP (svox_opacity_bwd, `opacity_bwd_kernel`), runs a
// sigma-only march of its own (`opacity_march`, below). Replaces:
// svox_t_tpu/ops/render_aux.py `_opacity_bwd_impl`, the gradient of
// `opacity_render` (the forward is K2's alpha column). A thread reads only
// the sigma column of a row: no basis, no colors, no color gradients. Per
// contributing sample (row < M, sigma > 0) it adds dt*ds * (g_alpha *
// L_ray) into column D - 1. Single pass with the forward alpha (L_ray = 1 -
// alpha, exact options); otherwise pass A forms L_ray under the backward's
// sigma > 0 rule and writes nothing, then pass B adds. This equals K3's
// sigma column with zero color gradients (ops/render_aux.py
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
// (8x the atomics; width 4 as above).

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
  int width;  // the vector width (1 or 4)
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
// Returns the final L in L.
template <class S, int FMT, int BD, bool kRot, bool kColor, bool kSigma>
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

// K3+K4's corner lookups at width 4, as K2+K4's width 4 makes them
// (render_fwd.cuh `kCornerReuse`): on the tree walk the own corner's row
// and the other corners' descents started on the own path (levers 1-2), on
// the bake the own corner's row (lever 1). The corner rows equal
// svox::sample_corners' bit for bit (ops/corner_lookup.py mirrors them).
template <class S>
constexpr int kCornerReuse4 = S::kBaked ? 1 : 2;

static_assert(kThreads == svox::kPathStride, "a block's threads are its path stride");

// The tree walk's per-thread slot of the own descent's path (shared memory,
// as render_fwd.cuh's). A template, so that only the instances that read
// it hold the array.
template <class S>
__device__ __forceinline__ int32_t* path_slot() {
  __shared__ int32_t path[svox::kPathLevels * svox::kPathStride];
  return path + threadIdx.x;
}

// Add G (or w * G, kScale) into the gradient row grow of kD columns: every
// column (the single pass: kColor and kSigma), the coefficient columns
// (pass 1: kColor; the last vector's sigma lane 0, so 7 vectors at SH9,
// which beat 6 vectors and 3 scalars in 7 of 8 cases, by up to 4%) or the
// sigma column alone
// (pass 2: kSigma), with Hopper's vector float atomics where more than one
// column goes (grow is 16-byte aligned: kD is 4 or 28, and the launch
// checks grad).
template <int kD, bool kColor, bool kSigma, bool kScale>
__device__ __forceinline__ void add_row4(float* grow, const float* G, float w) {
  const auto v = [&](int e) { return kScale ? w * G[e] : G[e]; };
  if constexpr (!kColor) {
    atomicAdd(grow + kD - 1, v(kD - 1));
  } else {
#pragma unroll
    for (int e = 0; e < kD; e += 4) {
      atomicAdd(reinterpret_cast<float4*>(grow + e),
                make_float4(v(e), v(e + 1), v(e + 2), kSigma || e + 3 != kD - 1 ? v(e + 3) : 0.f));
    }
  }
}

// The basis at the view direction rotated by row rr's 3x3 block
// (tmats[rr][:3, :3] in three 16-byte loads: the width-4 launch checks
// tmats' alignment), the arithmetic `march`'s.
template <int FMT, int BD, class S>
__device__ __forceinline__ void rotated_basis4(const Params<S>& p, int32_t rr, const Ray& r,
                                               float* basis) {
  const float4* m = reinterpret_cast<const float4*>(p.tmats + static_cast<size_t>(rr) * 16);
  const float4 a = __ldg(m), b = __ldg(m + 1), c = __ldg(m + 2);
  const float rx = (a.x * r.vx + a.y * r.vy) + a.z * r.vz;
  const float ry = (b.x * r.vx + b.y * r.vy) + b.z * r.vz;
  const float rz = (c.x * r.vx + c.y * r.vy) + c.z * r.vz;
  svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, BD, p.min_comp, p.max_comp, basis);
}

// A contributing sample's colours at width 4, as `march` forms them: s_c =
// sigmoid(z_c), total_color = sum_c s_c * g_c in channel order (returned),
// and (kColor) G's coefficient column c * nb + k := a_c * basis_k (RGBA:
// column c := a_c), a_c = (weight * (s_c (1 - s_c))) * g_c. Then the sigma
// column's addend (kSigma) into G[kD - 1], acc, and L, as `march`.
template <int FMT, int kB, int kD, bool kColor, bool kSigma>
__device__ __forceinline__ void sample_grad4(const float* z, const float* g, const float* basis,
                                             float weight, float att, float dts, float g_alpha,
                                             float L_ray, float& L, float& acc, float* G) {
  float total_color = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = svox::sigmoid(z[c]);
    total_color = total_color + s * g[c];
    if constexpr (kColor) {
      const float a = (weight * (s * (1.f - s))) * g[c];
      if constexpr (FMT == svox::kRGBA) {
        G[c] = a;
      } else {
#pragma unroll
        for (int k = 0; k < kB; ++k) G[c * kB + k] = a * basis[k];
      }
    }
  }
  const float L_after = L * att;
  if constexpr (kSigma) {
    const float acc_after = acc - weight * total_color;
    G[kD - 1] = dts * (total_color * L_after - acc_after) + dts * (g_alpha * L_ray);
    acc = acc_after;
  } else {
    acc = acc + weight * total_color;
  }
  L = L_after;
}

// `march` at width 4 (the three-colour RGBA, SH1 and SH9 rows with no
// spare column: kD = 4, 4, 28): the same samples, the
// same addends, grouped into vector atomics (see the top of this file).
// Nearest: the sample's row in registers, each column overwritten with its
// addend once read, the row added in one go. Interp: the corners from the
// own lookup, one pass over their rows in vectors for sigma and the
// colours, the gradient row G in registers, w_n * G added into each
// corner's row.
template <class S, int FMT, int BD, bool kRot, bool kColor, bool kSigma>
__device__ __forceinline__ void march4(const Params<S>& p, const Ray& r, float* basis, const float* g,
                                       float g_alpha, float L_ray, float& L, float& acc) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  constexpr int kD = (FMT == svox::kRGBA ? 3 : 3 * BD) + 1;
  float t = r.tmin;
  L = 1.f;
  if constexpr (svox::kInterp) {
    typename S::Keep keep;
    if constexpr (!S::kBaked) keep.path = path_slot<S>();
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      const svox::Leaf leaf = svox::sample_leaf_keep(p.st, r, t, p.step_size, dt, keep);
      const svox::Corners cn = svox::corners_keep<kCornerReuse4<S>>(p.st, r, t, leaf, keep, p.M);
      if constexpr (FMT != svox::kRGBA && kRot) {
        // The own row's rotation (row 0 where it is empty), where a corner
        // has a row: sigma is 0 otherwise.
        bool any = false;
#pragma unroll
        for (int n = 0; n < 8; ++n) any = any || cn.row[n] >= 0;
        if (any) {
          const int32_t idx = leaf.row;
          rotated_basis4<FMT, BD>(p, static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0, r,
                                  basis);
        }
      }
      float z[3];
      const float sigma = svox::interp_row4_pass<FMT, kB, kD>(cn, p.features, kB, basis, z);
      if (sigma > 0.f) {
        const float att = expf((-dt * r.ds) * sigma);
        float G[kD];
        sample_grad4<FMT, kB, kD, kColor, kSigma>(z, g, basis, L * (1.f - att), att, dt * r.ds, g_alpha,
                                                  L_ray, L, acc, G);
        // The corner loop is not unrolled, as svox::interp_row4_pass's.
#pragma unroll 1
        for (int n = 0; n < 8; ++n) {
          if (cn.row[n] < 0) continue;
          add_row4<kD, kColor, kSigma, true>(p.grad + static_cast<size_t>(cn.row[n]) * kD, G, cn.w[n]);
        }
      }
      t = t + dt;
    }
  } else {
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      const int32_t idx = leaf.row;
      if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
        const auto row = p.features + static_cast<size_t>(idx) * kD;
        float G[kD];
#pragma unroll
        for (int e = 0; e < kD; e += 4) svox::load_row4(row, G, e);
        const float sigma = G[kD - 1];
        if (sigma > 0.f) {
          const float att = expf((-dt * r.ds) * sigma);
          if constexpr (FMT != svox::kRGBA && kRot) rotated_basis4<FMT, BD>(p, idx, r, basis);
          // Every colour's sum before any of its columns is overwritten.
          float z[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) z[c] = svox::color_logit<FMT, kB, 4>(row, G, c, kB, basis);
          sample_grad4<FMT, kB, kD, kColor, kSigma>(z, g, basis, L * (1.f - att), att, dt * r.ds, g_alpha,
                                                    L_ray, L, acc, G);
          add_row4<kD, kColor, kSigma, false>(p.grad + static_cast<size_t>(idx) * kD, G, 1.f);
        }
      }
      t = t + dt;
    }
  }
}

// One march of the launch's width: `march` (W = 1) or `march4`.
template <class S, int FMT, int BD, bool kRot, int W, bool kColor, bool kSigma>
__device__ __forceinline__ void march_w(const Params<S>& p, const Ray& r, float* basis, const float* g,
                                        float g_alpha, float L_ray, float& L, float& acc) {
  if constexpr (W == 4) {
    march4<S, FMT, BD, kRot, kColor, kSigma>(p, r, basis, g, g_alpha, L_ray, L, acc);
  } else {
    march<S, FMT, BD, kRot, kColor, kSigma>(p, r, basis, g, g_alpha, L_ray, L, acc);
  }
}

template <class S, int FMT, int BD, bool kRot, int W>
__global__ void __launch_bounds__(kThreads) render_bwd_kernel(const Params<S> p) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const int nc = W == 4 ? 3 : p.n_color;

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
    march_w<S, FMT, BD, kRot, W, true, true>(p, r, basis, g, g_alpha, L_ray, L, acc);
  } else {
    acc = 0.f;
    march_w<S, FMT, BD, kRot, W, true, false>(p, r, basis, g, g_alpha, 0.f, L, acc);
    const float L_ray = L;
    float total_grad = g[0];
#pragma unroll
    for (int c = 1; c < kMaxColor; ++c) {
      if (c < nc) total_grad = total_grad + g[c];
    }
    acc = acc + (L_ray * p.bg) * total_grad;
    march_w<S, FMT, BD, kRot, W, false, true>(p, r, basis, g, g_alpha, L_ray, L, acc);
  }
}

template <class S, int FMT, int BD, int W>
cudaError_t launch_rot(const Params<S>& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) {
      render_bwd_kernel<S, FMT, BD, true, W><<<grid, kThreads, 0, stream>>>(p);
      return cudaGetLastError();
    }
  }
  render_bwd_kernel<S, FMT, BD, false, W><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The launch's vector width (p.width, 1 or 4, alignment checked by the
// entry point). Width 4 exists for the three-colour RGBA, SH1 and SH9 rows
// with no spare column (D = 4, 4, 28), nearest and interp, and refuses any
// other row.
template <class S, int FMT, int BD>
cudaError_t launch(const Params<S>& p, cudaStream_t stream) {
  if (p.width == 1) return launch_rot<S, FMT, BD, 1>(p, stream);
  if constexpr (FMT == svox::kRGBA || (FMT == svox::kSH && (BD == 1 || BD == 9))) {
    constexpr int kD3 = (FMT == svox::kRGBA ? 3 : 3 * BD) + 1;
    if (p.n_color == 3 && p.D == kD3) return launch_rot<S, FMT, BD, 4>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// K9a: the opacity VJP (see the top of this file). A sample reads one
// value, its row's sigma (under interp its 8 corners' sigmas), so the march
// is its lookups' chains of dependent loads; a contributing sample adds one
// value (8 under interp). The Hopper design (tools/render_bwd_ab.py
// --opacity times it against an earlier commit's kernel and against the
// levers that did not ship, tools/opacity_designs.cuh; PERF.md §6, NVIDIA
// H100 80GB HBM3 at 700 W):
//  * interp: the corners from the sample's own lookup, as K2+K4 finds them
//    (svox::corners_keep<kOpReuse>: 1 the own corner's row, on the bake; 2
//    also the other corners' descents started on the own path, on the tree
//    walk), in place of svox::sample_corners' 9 lookups from the root; the
//    corner rows are sample_corners' bit for bit (ops/corner_lookup.py
//    mirrors them). On the tree walk 1.12x against 9 lookups, 1.02x with
//    the own row alone; on the bake a tie exact, 1.07x in two passes;
//  * nearest, kOpAhead (the bake's float32 instance): the next sample's
//    lookup issued before the sigma's test (the lookup ahead), 3-8% there;
//    it lost up to 2% on the other exact instances, as on K2, and the loop
//    rotated as K9b's tree walk tied, so they keep the earlier loop;
//  * one kernel a mode (kTwoPass), so that the single pass, whose L is dead,
//    issues no exp at all (its SASS has no MUFU.EX2): 1.04-1.07x on the tree
//    walk's interp instances with 9 lookups.
template <class S>
constexpr int kOpReuse = S::kBaked ? 1 : 2;
template <class S>
constexpr bool kOpAhead = S::kBaked && svox::kFloatPool;

// A contributing sample of the nearest march: with kAdd its add into column
// D - 1 of its row, and its attenuation of L (dead with kAdd: the caller
// drops it).
template <class S, bool kAdd>
__device__ __forceinline__ void opacity_sample(const Params<S>& p, const Ray& r, int32_t idx, float sigma,
                                               float dt, float coef, float& L) {
  if (sigma > 0.f) {
    if constexpr (kAdd) atomicAdd(p.grad + static_cast<size_t>(idx) * p.D + p.D - 1, (dt * r.ds) * coef);
    L = L * expf((-dt * r.ds) * sigma);
  }
}

// K9a's march: kAdd false is pass A (the final L under the backward's
// sigma > 0 rule, nothing written), true the adds of (dt * ds) * coef into
// column D - 1 of every contributing sample's row, or w_n times that into
// its corners' rows under interp. The samples and the rule are `march`'s.
template <class S, bool kAdd>
__device__ __forceinline__ float opacity_march(const Params<S>& p, const Ray& r, float coef) {
  float t = r.tmin;
  float L = 1.f;
  if constexpr (svox::kInterp) {
    typename S::Keep keep;
    if constexpr (!S::kBaked) keep.path = path_slot<S>();
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      const svox::Leaf leaf = svox::sample_leaf_keep(p.st, r, t, p.step_size, dt, keep);
      const svox::Corners cn = svox::corners_keep<kOpReuse<S>>(p.st, r, t, leaf, keep, p.M);
      const float sigma = svox::interp_sum(cn, [&](int32_t row) {
        return svox::ld(p.features + static_cast<size_t>(row) * p.D + p.D - 1);
      });
      if (sigma > 0.f) {
        if constexpr (kAdd) add_corners(p, cn, p.D - 1, (dt * r.ds) * coef);
        L = L * expf((-dt * r.ds) * sigma);
      }
      t = t + dt;
    }
  } else if constexpr (!kOpAhead<S>) {
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      const int32_t idx = leaf.row;
      if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
        const float sigma = svox::ld(p.features + static_cast<size_t>(idx) * p.D + p.D - 1);
        opacity_sample<S, kAdd>(p, r, idx, sigma, dt, coef, L);
      }
      t = t + dt;
    }
  } else {
    if (!(t < r.tmax) || p.max_steps <= 0) return L;
    float x, y, z;
    svox::sample_pos(r, t, x, y, z);
    svox::Leaf leaf = p.st.lookup(x, y, z);
    for (int step = 0;; ++step) {
      const float dt = svox::step_dt(p.st, leaf, r, p.step_size);
      const int32_t idx = leaf.row;
      const bool resident = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M);
      const float sigma = resident ? svox::ld(p.features + static_cast<size_t>(idx) * p.D + p.D - 1) : 0.f;
      const float t_next = t + dt;
      const bool more = step + 1 < p.max_steps && t_next < r.tmax;
      svox::Leaf next = leaf;
      if (more) {
        svox::sample_pos(r, t_next, x, y, z);
        next = p.st.lookup(x, y, z);
      }
      opacity_sample<S, kAdd>(p, r, idx, sigma, dt, coef, L);
      if (!more) break;
      leaf = next;
      t = t_next;
    }
  }
  return L;
}

// K9a, one instance a mode: the single pass (grad_out and out_res (B, 1),
// g_alpha and the forward alpha: L_ray = 1 - alpha) or, kTwoPass, pass A
// for L_ray and then the adds.
template <class S, bool kTwoPass>
__global__ void __launch_bounds__(kThreads) opacity_bwd_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  Ray r;
  if (!svox::march_cull(p.st, r, svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r))) return;
  float L_ray;
  if constexpr (kTwoPass) {
    L_ray = opacity_march<S, false>(p, r, 0.f);
  } else {
    L_ray = 1.f - p.out_res[i];
  }
  opacity_march<S, true>(p, r, p.grad_out[i] * L_ray);
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
// the caller. width: the vector width, 1 or 4; 4 takes only the
// three-colour RGBA, SH1 and SH9 rows (D = 4, 4, 28), with the pool aligned
// to 4 values and tmats and grad to 16 bytes. All pointers but s are
// device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_render_bwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs,
    const float* vdirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, const float* tmats, int format, const float* extra,
    int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color, float step_size,
    float bg, int max_steps, const float* grad_out, const float* out_res,
    float* grad, int width, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width != 1 && width != 4) return cudaErrorInvalidValue;
  if (width == 4 && (!svox::vector_aligned(features, scale, zero) ||
                     reinterpret_cast<uintptr_t>(tmats) % 16 != 0 ||
                     reinterpret_cast<uintptr_t>(grad) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor) return cudaErrorInvalidValue;
  using S = SVOX_STRUCTURE;
  const Params<S> p{S::from(*s), origins, dirs, vdirs, B,
                    offset, scaling, svox::make_pool<svox::Pool>(features, scale, zero), M, D,
                    tmats, extra, ld_extra, basis_dim, min_comp, max_comp, n_color, step_size,
                    bg, max_steps, grad_out, out_res, grad, width};
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
                    max_steps, grad_out, out_res, grad, 1};
  const dim3 grid((B + kThreads - 1) / kThreads);
  if (out_res != nullptr) {
    opacity_bwd_kernel<S, false><<<grid, kThreads, 0, stream>>>(p);
  } else {
    opacity_bwd_kernel<S, true><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}
