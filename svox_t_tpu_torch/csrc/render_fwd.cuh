// K2: the forward ray march (exact and thresholded), RGBA, SH, SG and ASG,
// with optional per-leaf weight accumulation, on either structure.
// Included by render_fwd.cu (the tree walk, svox_render_fwd) and
// render_fwd_baked.cu (the bake, svox_render_fwd_baked), which define
// SVOX_STRUCTURE and SVOX_SUFFIX first; each instantiates the kernels for
// its structure, so the two compile in parallel.
//
// Replaces: svox_t_tpu/ops/render.py `_volume_render_fwd_impl` with
// `_ray_setup`, `_clip_to_occupied`, `_march_round`, `_lookup_leaf_xyz`,
// `_phase2_radiometry` (including its weight accumulation),
// `_round_sigma`, `_round_colors`, `_step_basis` and `_colors`. The TPU version marched all rays in chunks of K-sample
// rounds; this kernel is shaped like the CUDA reference's trace_ray
// instead: one thread per ray, one sample at a time, leaving the loop
// when the ray leaves the cube, reaches max_steps samples or stops early.
//
// Ray setup culls against the bake's occupied box (Baked::cull; a no-op on
// the tree). Per sample: find the leaf (S::lookup: the descent or the
// baked lookup, common.cuh), step
// delta_t = (sub_tmax - sub_tmin) / cube_sz + step_size from the in-leaf
// DDA (or a skip box's, step_dt), read the leaf's feature row, and
// composite only when
// sigma > sigma_thresh: att = exp(-dt * delta_scale * sigma),
// weight = L * (1 - att), colors sigmoid(feat) (RGBA) or
// sigmoid(sum_k basis_k * feat[c * basis_dim + k]) (SH/SG/ASG,
// channel-major). The basis comes from the view direction as passed,
// windowed to [min_comp, max_comp]; with per-voxel transformation
// matrices the view direction is rotated by the row's 3x3 block and the
// basis re-evaluated per sample. With stop_thresh > 0 the sample that
// brings L to or below stop_thresh still counts, then the color is
// renormalized by 1/(1-L) and no background is added. With a weight
// buffer, every compositing sample (the stop sample included) adds its
// weight to its tree cell's slot with atomicAdd (a baked cell's through
// src_map).
//
// Bound on an H100: latency. A sample is a dependent chain of depth
// child-table loads (on the bake: two or three table loads), one
// data-table load and one feature-row load, then a few dozen flops; the
// tables of the depth-9 scene (9.5 MB child, 9.5 MB data, 157 MB pool) are mostly L2 and HBM reads with no reuse inside a
// thread. The design answer is occupancy: a ray per thread, the basis and
// the color sums held in registers (format, rotation and the basis
// capacity are template parameters, so every basis index is a
// compile-time constant; SG/ASG sizes between capacities run behind a
// run-time bound), and small blocks, so enough warps are resident to
// hide the chains. Rays in a warp are neighbouring pixels, so their
// descents touch the same nodes. The weight atomics are one per
// compositing sample into a 9.5 MB buffer that stays in L2.
//
// Arithmetic follows the plain PyTorch version (ops/render.py) operation
// for operation, and the library is built with -fmad=false, so the sample
// positions agree bit for bit with it.
//
// Feature pools (K5): the build (_build.POOL_INSTANCES) also defines
// SVOX_POOL (svox::PoolBF16, svox::PoolI8) on each structure, nearest and
// interp (svox_render_fwd_bf16, ..._baked_interp_i8): every row load is
// svox::ld of the pool's type, float32 from there on (common.cuh).
//
// Trilinear interpolation (K4): render_fwd_interp.cu and
// render_fwd_baked_interp.cu define SVOX_INTERP 1 (svox_render_fwd_interp,
// svox_render_fwd_baked_interp). Their rays are not culled (march_cull);
// every sample, in an empty leaf too, reads its 8 corners
// (svox::sample_corners, 8 lookups), sums sigma over them and, where it
// composites, each color's pre-sigmoid sum as sum_n w_n * (basis . row_n)
// (interp_sum, row_logit), so no interpolated D-wide row is held; the own
// row (0 where it is empty) only picks the rotation, and the weight adds
// into the own cell. Bound on an H100: as above, with 9 lookup chains per
// sample instead of one; the 8 corner chains are independent, so their
// latency overlaps.

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
  float sigma_thresh;
  float stop_thresh;
  int max_steps;
  float* out;
  float* waccum;
};

// FMT: svox::kRGBA / kSH / kSG / kASG. BD: basis capacity (0 for RGBA;
// svox::basis_capacity). kRot: per-voxel rotation of the view direction by
// tmats[row][:3, :3]. kWeights: accumulate weights into p.waccum (a
// template parameter, so that the plain render keeps the leaf id out of
// its live registers).
template <class S, int FMT, int BD, bool kRot, bool kWeights>
__global__ void __launch_bounds__(kThreads) render_fwd_kernel(const Params<S> p) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const int nc = p.n_color;
  const int nb = FMT == svox::kSH ? BD : p.basis_dim;
  float* out = p.out + static_cast<size_t>(i) * (nc + 1);

  svox::Ray r;
  const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  if (!svox::march_cull(p.st, r, hit)) {
    for (int c = 0; c < nc; ++c) out[c] = p.bg;
    out[nc] = 0.f;
    return;
  }

  const float vx = p.vdirs[3 * i + 0];
  const float vy = p.vdirs[3 * i + 1];
  const float vz = p.vdirs[3 * i + 2];
  float basis[kB];
  if constexpr (FMT != svox::kRGBA && !kRot) {
    svox::eval_basis<FMT, BD>(vx, vy, vz, p.extra, p.ld_extra, nb, p.min_comp,
                              p.max_comp, basis);
  }

  float acc[kMaxColor];
#pragma unroll
  for (int c = 0; c < kMaxColor; ++c) acc[c] = 0.f;
  float t = r.tmin;
  float L = 1.f;
  bool stopped = false;
  for (int step = 0; step < p.max_steps; ++step) {
    float dt;
    const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
    const int32_t idx = leaf.row;
    if constexpr (svox::kInterp) {
      // K4: sigma and colors from the 8 corners, in every leaf; the own row
      // (row 0 where it is empty, as in the JAX package) only rotates.
      const svox::Corners cn = svox::sample_corners(p.st, r, t, leaf.cube_sz, p.M);
      const float sigma = svox::interp_sum(cn, [&](int32_t row) {
        return svox::ld(p.features + static_cast<size_t>(row) * p.D + p.D - 1);
      });
      if (sigma > p.sigma_thresh) {
        const float att = expf((-dt * r.ds) * sigma);
        const float weight = L * (1.f - att);
        if constexpr (FMT != svox::kRGBA && kRot) {
          const int32_t gi = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0;
          const float* m = p.tmats + static_cast<size_t>(gi) * 16;
          const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
          const float ry = (m[4] * vx + m[5] * vy) + m[6] * vz;
          const float rz = (m[8] * vx + m[9] * vy) + m[10] * vz;
          svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb,
                                    p.min_comp, p.max_comp, basis);
        }
        float z[kMaxColor];
        svox::interp_logits<FMT, kB, kMaxColor>(cn, p.features, p.D, nc, nb, basis, z);
#pragma unroll
        for (int c = 0; c < kMaxColor; ++c) {
          if (c < nc) acc[c] = acc[c] + weight * svox::sigmoid(z[c]);
        }
        if constexpr (kWeights) atomicAdd(p.waccum + p.st.tree_cell(leaf.flat), weight);
        L = L * att;
        if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
          stopped = true;
          break;
        }
      }
    } else if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
      // Rows >= M (and negative rows) are empty space. Their sigma is 0 and
      // a sample with sigma 0 adds weight 0 and leaves L unchanged, so it is
      // skipped.
      const auto row = p.features + static_cast<size_t>(idx) * p.D;
      const float sigma = svox::ld(row + p.D - 1);
      if (sigma > p.sigma_thresh) {
        const float att = expf((-dt * r.ds) * sigma);
        const float weight = L * (1.f - att);
        if constexpr (FMT != svox::kRGBA && kRot) {
          const float* m = p.tmats + static_cast<size_t>(idx) * 16;
          const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
          const float ry = (m[4] * vx + m[5] * vy) + m[6] * vz;
          const float rz = (m[8] * vx + m[9] * vy) + m[10] * vz;
          svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb,
                                    p.min_comp, p.max_comp, basis);
        }
#pragma unroll
        for (int c = 0; c < kMaxColor; ++c) {
          if (c < nc) {
            float s;
            if constexpr (FMT == svox::kRGBA) {
              s = svox::ld(row + c);
            } else {
              const auto coef = row + c * nb;
              s = basis[0] * svox::ld(coef);
#pragma unroll
              for (int k = 1; k < kB; ++k) {
                if (k < nb) s = s + basis[k] * svox::ld(coef + k);
              }
            }
            acc[c] = acc[c] + weight * svox::sigmoid(s);
          }
        }
        if constexpr (kWeights) atomicAdd(p.waccum + p.st.tree_cell(leaf.flat), weight);
        L = L * att;
        if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
          stopped = true;
          break;
        }
      }
    }
    t = t + dt;
    if (!(t < r.tmax)) break;
  }

#pragma unroll
  for (int c = 0; c < kMaxColor; ++c) {
    if (c < nc) {
      if (stopped) {
        out[c] = acc[c] * (1.f / (1.f - L));
      } else {
        out[c] = acc[c] + L * p.bg;
      }
    }
  }
  out[nc] = 1.f - L;
}

template <class S, int FMT, int BD, bool kRot>
cudaError_t launch_weights(const Params<S>& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  if (p.waccum != nullptr) {
    render_fwd_kernel<S, FMT, BD, kRot, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    render_fwd_kernel<S, FMT, BD, kRot, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <class S, int FMT, int BD>
cudaError_t launch(const Params<S>& p, cudaStream_t stream) {
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) return launch_weights<S, FMT, BD, true>(p, stream);
  }
  return launch_weights<S, FMT, BD, false>(p, stream);
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

// s: the structure (svox::StructDesc, host memory); rays (B, 3) f32:
// origins, dirs, vdirs (world space); offset/scaling (3,) f32; features
// (M, D) of the source's pool type (svox::Pool: f32, bf16 or int8), with
// scale and zero (D,) f32 for an int8 pool, else null; tmats (M, 4, 4) f32 or null; extra (basis_dim, ld_extra) f32
// for SG/ASG (else null); out (B, n_color + 1) f32; waccum (n_tree_cells,)
// f32 or null. format: 0 RGBA, 1 SH, 2 SG, 3 ASG. All pointers but s are
// device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_render_fwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs,
    const float* vdirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, const float* tmats, int format, const float* extra,
    int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color, float step_size,
    float bg, float sigma_thresh, float stop_thresh, int max_steps,
    float* out, float* waccum, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor) return cudaErrorInvalidValue;
  using S = SVOX_STRUCTURE;
  const Params<S> p{S::from(*s), origins, dirs, vdirs, B,
                    offset, scaling, svox::make_pool<svox::Pool>(features, scale, zero), M, D,
                    tmats, extra, ld_extra, basis_dim, min_comp, max_comp, n_color, step_size,
                    bg, sigma_thresh, stop_thresh, max_steps, out, waccum};
  switch (format) {
    case svox::kRGBA: return launch<S, svox::kRGBA, 0>(p, stream);
    case svox::kSH: return launch_basis<S, svox::kSH>(p, stream);
    case svox::kSG: return launch_basis<S, svox::kSG>(p, stream);
    case svox::kASG: return launch_basis<S, svox::kASG>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}
