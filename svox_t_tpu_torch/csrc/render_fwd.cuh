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
// tables of the depth-9 scene (9.5 MB child, 9.5 MB data, 157 MB pool) are
// mostly L2 and HBM reads with no reuse inside a thread. The design answer
// is occupancy: a ray per thread, the basis and the color sums held in
// registers (format, rotation and the basis capacity are template
// parameters, so every basis index is a compile-time constant; SG/ASG
// sizes between capacities run behind a run-time bound), and small
// blocks, so enough warps are resident to hide the chains. Rays in a warp
// are neighbouring pixels, so their descents touch the same nodes. The
// weight atomics are one per compositing sample into a 9.5 MB buffer that
// stays in L2.
//
// The earlier loop ran each sample as one serial chain: the lookup, then
// the row's sigma (one scalar load, and the branch on it), then its
// colour coefficients (27 scalar loads at SH9), then the compositing, and
// only then the next sample's lookup. The deep camera's marching rays fill
// 2-4 waves of blocks (chip_smoke.py's `K2 waves`), so resident warps hide
// the chains, and registers, which bound them, are the price of any
// overlap inside a thread. The width-4 instance (the three-colour RGBA, SH1
// and SH9 rows with no spare column, as K13c's; n_color and D template
// constants) changes loads and their order, never the arithmetic or its
// order: a row moves, sigma included, in one round trip of 16-byte loads
// (8 of a bf16 row, 4 of an int8 one with its columns' scale and zero) into
// registers. On the bake with a float32 pool it also starts the loads of a
// sample's row, the 3x3 block of its rotation (three 16-byte loads) and its
// weight cell (src_map), then the next sample's lookup, under the
// conditions on which the loop would reach it, and only then composites:
// the next position depends only on this sample's lookup, so the row's
// round trip overlaps the next lookup (kLookAhead). Loading the next
// sample's row into a second register row lost (more registers, fewer
// resident warps). Width 1 (every other row: SH4, SH16, SG, ASG, spare
// columns) is the earlier loop's text, so it
// compiles as before but for the few instances that spilled (kWide).
// tools/render_fwd_ab.py times the designs, beside an earlier checkout's.
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
// every sample, in an empty leaf too, reads its 8 corners, sums sigma over
// them and, where it composites, each color's pre-sigmoid sum as sum_n w_n
// * (basis . row_n), so no interpolated D-wide row is held; the own row (0
// where it is empty) only picks the rotation, and the weight adds into the
// own cell. Bound on an H100: the corner lookups and rows. The earlier
// loop made 9 lookups a sample, one after the other (each a loop with a
// data-dependent exit; on the depth-9 tree walk 9 chains of about 11
// dependent loads), and read every corner row a column at a time. The
// redesign changes loads and their order, never the arithmetic or its
// order. svox::corners_keep finds the corners from the sample's own lookup
// (S::lookup_keep): the corner in the own cell takes the own row (lever 1;
// on each axis one of b and b + 1 is the own cell), and on the tree walk
// each other corner's descent may start on the own path (lever 2,
// TreeWalk::corner_row: for N a power of two at the own path's node of the
// first level whose digits part, usually the last one or two).
// kCornerReuse picks the levers per structure, format and width. At width
// 4 (the RGBA, SH1 and SH9 rows with no spare column, as nearest) a
// corner's whole row moves in 16-, 8- or 4-byte loads, one corner's row
// live at a time in the rolled corner loop, sigma and colours summed in
// one pass. No lookup is made ahead (registers spent on overlap lose the
// resident warps of a multi-wave march, as K2's lookup ahead showed) and
// nothing is culled (a coarse empty leaf's corners reach a whole cell of
// its size, so no box cull is exact). The interp instances keep ptxas's
// own register limit: bounds of 4 and 5 blocks an SM for all of them
// spilled 16-29 KB and cost the SH9 main path 5-15%. Under it two width-4
// instances spill 24 bytes each (CUDA 12.8 for sm_90a: the tree walk's
// int8 SH9 with weights, the bake's bf16 SH9 with rotations and weights);
// at 6 blocks an SM (80 registers) they spill nothing but ran 11-12%
// slower (`wide_interp`). tools/render_fwd_ab.py --interp times the
// designs beside an earlier checkout's.

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
  int width;  // the vector width (1 or 4)
};

// Whether a width-4 instance on structure S starts sample k's loads (its
// row, rotation and weight cell), then sample k + 1's lookup, before
// sample k composites, so that the loads are in flight during the lookup's
// chain. It pays on the bake with a float32 pool, whose lookup is short
// (two or three table loads) and whose row is the largest, so that the
// row's round trip is a large part of a sample's chain. On the tree walk,
// and on the bake with a bf16 or int8 pool, the row held in registers
// across the lookup costs more resident warps than the overlap saves.
// tools/render_fwd_ab.py times every choice (its `ahead_only` design, the
// lookup ahead at width 1, patches the width-4 loop to take width 1).
template <class S>
constexpr bool kLookAhead = S::kBaked && svox::kFloatPool;

// K2+K4's corner lookups (svox::corners_keep) by structure, format and
// width: 2 reuses the own lookup's row and starts each other corner's
// descent on the own path (the tree walk only, TreeWalk::corner_row), 1
// only its row (each other corner a lookup from the root), 0 none
// (svox::sample_corners, the earlier loop's 9 lookups). From
// tools/render_fwd_ab.py --interp against the earlier kernel in turns
// (PERF.md §6): at width 4 the tree walk gains most with both, the bake
// with the row alone (its lookup is two loads; a reuse of the own lookup's
// table entries lost 2% to the registers it kept); at width 1 the reuse
// lost on the tree walk (up to 12% on SG9 and int8 SH9) and on the bake's
// 25-term SG/ASG instances of the bf16 and int8 pools (7% on SG9), so those
// keep the 9 lookups.
template <class S, int FMT, int W>
constexpr int kCornerReuse = W == 4 ? (S::kBaked ? 1 : 2)
                                    : (S::kBaked && (svox::kFloatPool || FMT == svox::kSH) ? 1 : 0);

static_assert(kThreads == svox::kPathStride, "a block's threads are its path stride");

// The tree walk's per-thread slot of the own descent's path (shared memory,
// svox::kPathLevels levels, svox::kPathStride apart). A template, so that
// only the instances that read it hold the array.
template <class S>
__device__ __forceinline__ int32_t* path_slot() {
  __shared__ int32_t path[svox::kPathLevels * svox::kPathStride];
  return path + threadIdx.x;
}

// The 3x3 block of row r's rotation, tmats[r][:3, :3], into m (row major):
// three 16-byte loads (kVec, tmats aligned to 16 bytes), or nine scalars.
template <bool kVec>
__device__ __forceinline__ void load_rot(const float* tmats, int32_t r, float* m) {
  const float* t = tmats + static_cast<size_t>(r) * 16;
  if constexpr (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(t));
    const float4 b = __ldg(reinterpret_cast<const float4*>(t + 4));
    const float4 c = __ldg(reinterpret_cast<const float4*>(t + 8));
    m[0] = a.x, m[1] = a.y, m[2] = a.z;
    m[3] = b.x, m[4] = b.y, m[5] = b.z;
    m[6] = c.x, m[7] = c.y, m[8] = c.z;
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = __ldg(t + (k / 3) * 4 + k % 3);
  }
}

// The basis at the view direction rotated by m (row major, load_rot).
template <int FMT, int BD, class P>
__device__ __forceinline__ void rotated_basis(const P& p, const float* m, float vx, float vy, float vz,
                                              int nb, float* basis) {
  const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
  const float ry = (m[3] * vx + m[4] * vy) + m[5] * vz;
  const float rz = (m[6] * vx + m[7] * vy) + m[8] * vz;
  svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb, p.min_comp, p.max_comp, basis);
}

// FMT: svox::kRGBA / kSH / kSG / kASG. BD: basis capacity (0 for RGBA;
// svox::basis_capacity). kRot: per-voxel rotation of the view direction by
// tmats[row][:3, :3]. kWeights: accumulate weights into p.waccum (a
// template parameter, so that the plain render keeps the leaf id out of
// its live registers). W: the vector width of a sample's row: 1 runs the
// earlier loop, which reads the row a column at a time, sigma first (so do
// the interp instances, from each corner's row); 4 (three colours, D = 3 *
// BD + 1, or 4 for RGBA: n_color and D are constants) loads the whole row
// into registers, 4 columns a load (under interp each corner's row in turn,
// sigma and colours in one pass).
template <class S, int FMT, int BD, bool kRot, bool kWeights, int W>
__device__ __forceinline__ void render_fwd_ray(const Params<S>& p) {
  static_assert(W == 1 || W == 4, "widths 1 and 4");
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  constexpr int kD = (FMT == svox::kRGBA ? 3 : 3 * BD) + 1;  // width 4's row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const int nc = W == 4 ? 3 : p.n_color;
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
  if constexpr (svox::kInterp) {
    // K4: sigma and colors from the 8 corners, in every leaf; the own row
    // (row 0 where it is empty, as in the JAX package) only rotates. The
    // own lookup keeps what the corners reuse (svox::corners_keep,
    // kCornerReuse); at width 4 each corner's row moves in 16-byte loads,
    // one row live at a time, sigma and colours in one pass (the rotation's
    // basis first, where any corner has a row).
    constexpr int kReuse = kCornerReuse<S, FMT, W>;
    typename S::Keep keep;
    if constexpr (!S::kBaked && kReuse > 0) keep.path = path_slot<S>();
    for (int step = 0; step < p.max_steps; ++step) {
      float dt;
      svox::Leaf leaf;
      svox::Corners cn;
      if constexpr (kReuse == 0) {
        leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
        cn = svox::sample_corners(p.st, r, t, leaf.cube_sz, p.M);
      } else {
        leaf = svox::sample_leaf_keep(p.st, r, t, p.step_size, dt, keep);
        cn = svox::corners_keep<kReuse>(p.st, r, t, leaf, keep, p.M);
      }
      const int32_t idx = leaf.row;
      float sigma;
      float z[W == 4 ? 3 : kMaxColor];
      if constexpr (W == 4) {
        if constexpr (FMT != svox::kRGBA && kRot) {
          bool any = false;
#pragma unroll
          for (int n = 0; n < 8; ++n) any = any || cn.row[n] >= 0;
          if (any) {
            float m[9];
            load_rot<true>(p.tmats, static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0, m);
            rotated_basis<FMT, BD>(p, m, vx, vy, vz, nb, basis);
          }
        }
        sigma = svox::interp_row4_pass<FMT, kB, kD>(cn, p.features, nb, basis, z);
      } else {
        sigma = svox::interp_sum(cn, [&](int32_t row) {
          return svox::ld(p.features + static_cast<size_t>(row) * p.D + p.D - 1);
        });
      }
      if (sigma > p.sigma_thresh) {
        const float att = expf((-dt * r.ds) * sigma);
        const float weight = L * (1.f - att);
        if constexpr (W == 1) {
          if constexpr (FMT != svox::kRGBA && kRot) {
            const int32_t gi = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M) ? idx : 0;
            const float* m = p.tmats + static_cast<size_t>(gi) * 16;
            const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
            const float ry = (m[4] * vx + m[5] * vy) + m[6] * vz;
            const float rz = (m[8] * vx + m[9] * vy) + m[10] * vz;
            svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb,
                                      p.min_comp, p.max_comp, basis);
          }
          svox::interp_logits<FMT, kB, kMaxColor>(cn, p.features, p.D, nc, nb, basis, z);
        }
#pragma unroll
        for (int c = 0; c < (W == 4 ? 3 : kMaxColor); ++c) {
          if (c < nc) acc[c] = acc[c] + weight * svox::sigmoid(z[c]);
        }
        if constexpr (kWeights) atomicAdd(p.waccum + p.st.tree_cell(leaf.flat), weight);
        L = L * att;
        if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
          stopped = true;
          break;
        }
      }
      t = t + dt;
      if (!(t < r.tmax)) break;
    }
  } else if constexpr (W == 1) {
    // The earlier loop, kept as it was so that it compiles as it did: the
    // reference width 4 is timed and held against.
    for (int step = 0; step < p.max_steps; ++step) {
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      const int32_t idx = leaf.row;
      if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
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

  } else {
    // Width 4. With the lookup ahead (kLookAhead: the bake), sample k's
    // loads (its whole row, the 3x3 block of its rotation and, with
    // weights, its tree cell) start, then sample k + 1's lookup, where the
    // earlier loop would make it (step + 1 < max_steps and t + dt < tmax),
    // then sample k composites: the next position and step depend only on
    // this sample's lookup, never on the compositing, so this sample's
    // loads are in flight during the next lookup's chain. After the
    // stop_thresh break the lookup made ahead goes unused. Without it (the
    // tree walk) a sample's row is loaded after its own lookup.
    constexpr bool kAhead = kLookAhead<S>;
    constexpr int kRotN = FMT != svox::kRGBA && kRot ? 9 : 1;
    float dt = 0.f;
    svox::Leaf leaf{};
    if constexpr (kAhead) leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
    for (int step = 0; step < p.max_steps; ++step) {
      if constexpr (!kAhead) leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      const int32_t idx = leaf.row;
      const int32_t flat = leaf.flat;
      const float dt_k = dt;
      // Rows >= M (and negative rows) are empty space, skipped as in the
      // earlier loop.
      const bool resident = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M);
      const auto row = p.features + static_cast<size_t>(idx) * kD;
      float buf[kD];
      float m[kRotN];
      int32_t cell = 0;
      float sigma = 0.f;
      if (resident) {
        svox::load_row<kD>(p.features, idx, p.M, buf);
        if constexpr (kAhead) {
          if constexpr (kRotN == 9) load_rot<true>(p.tmats, idx, m);
          if constexpr (kWeights) cell = p.st.tree_cell(flat);
        }
      }
      bool more = false;
      float t_next = 0.f;
      if constexpr (kAhead) {
        t_next = t + dt_k;
        more = step + 1 < p.max_steps && t_next < r.tmax;
        if (more) leaf = svox::sample_leaf(p.st, r, t_next, p.step_size, dt);
      }
      if (resident) {
        sigma = svox::row_col<W>(row, buf, kD - 1);
        if (sigma > p.sigma_thresh) {
          const float att = expf((-dt_k * r.ds) * sigma);
          const float weight = L * (1.f - att);
          if constexpr (FMT != svox::kRGBA && kRot) {
            if constexpr (!kAhead) load_rot<false>(p.tmats, idx, m);
            const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
            const float ry = (m[3] * vx + m[4] * vy) + m[5] * vz;
            const float rz = (m[6] * vx + m[7] * vy) + m[8] * vz;
            svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb,
                                      p.min_comp, p.max_comp, basis);
          }
#pragma unroll
          for (int c = 0; c < kMaxColor; ++c) {
            if (c < nc) {
              acc[c] = acc[c] + weight * svox::sigmoid(
                  svox::color_logit<FMT, kB, W>(row, buf, c, nb, basis));
            }
          }
          if constexpr (kWeights) {
            atomicAdd(p.waccum + (kAhead ? cell : p.st.tree_cell(flat)), weight);
          }
          L = L * att;
          if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
            stopped = true;
            break;
          }
        }
      }
      if constexpr (kAhead) {
        if (!more) break;
        t = t_next;
      } else {
        t = t + dt_k;
        if (!(t < r.tmax)) break;
      }
    }
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

template <class S, int FMT, int BD, bool kRot, bool kWeights, int W>
__global__ void __launch_bounds__(kThreads) render_fwd_kernel(const Params<S> p) {
  render_fwd_ray<S, FMT, BD, kRot, kWeights, W>(p);
}

// The nearest width-1 instances that spill under ptxas's own register
// limit (8-480 bytes each, CUDA 12.8 for sm_90a; tools/render_fwd_ab.py's
// `own_limit` design lists them): on the bake, float32 SG1 with rotations
// and ASG1 with rotations and no weights, and bf16 SH9 with weights and no
// rotations; on the tree walk, int8 SH4 and int8 SH16 with weights, both
// without rotations. They launch with kWideBlocks blocks of 128 an SM, a
// limit of 80 registers, and none spills. They run within 1.5% of the
// earlier spilling kernels, but bf16 SH9 with weights on the bake (a pool
// off its 8-byte alignment: an aligned one takes width 4), 20% slower at
// 77 registers against 72. One block an SM (`wide_1`) cost the bake's SG1
// and ASG1 with rotations 29%. Every other instance keeps ptxas's own
// limit: given one block an SM, the bake's SH9 and SG9 width-1 instances
// ran 5-23% slower (`all_wide`).
constexpr int kWideBlocks = 6;
template <class S, int FMT, int BD, bool kRot, bool kWeights>
constexpr bool kWide =
    S::kBaked ? (svox::kFloatPool && BD == 1 && kRot &&
                 (FMT == svox::kSG || (FMT == svox::kASG && !kWeights))) ||
                    (std::is_same<svox::Pool, svox::PoolBF16>::value && FMT == svox::kSH &&
                     BD == 9 && kWeights && !kRot)
              : std::is_same<svox::Pool, svox::PoolI8>::value && FMT == svox::kSH && !kRot &&
                    (BD == 4 || (BD == 16 && kWeights));

template <class S, int FMT, int BD, bool kRot, bool kWeights, int W>
__global__ void __launch_bounds__(kThreads, kWideBlocks) render_fwd_kernel_wide(const Params<S> p) {
  render_fwd_ray<S, FMT, BD, kRot, kWeights, W>(p);
}

template <class S, int FMT, int BD, bool kRot, bool kWeights, int W>
void launch_kernel(const Params<S>& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  if constexpr (W == 1 && !svox::kInterp && kWide<S, FMT, BD, kRot, kWeights>) {
    render_fwd_kernel_wide<S, FMT, BD, kRot, kWeights, W><<<grid, kThreads, 0, stream>>>(p);
  } else {
    render_fwd_kernel<S, FMT, BD, kRot, kWeights, W><<<grid, kThreads, 0, stream>>>(p);
  }
}

template <class S, int FMT, int BD, bool kRot, int W>
cudaError_t launch_weights(const Params<S>& p, cudaStream_t stream) {
  if (p.waccum != nullptr) {
    launch_kernel<S, FMT, BD, kRot, true, W>(p, stream);
  } else {
    launch_kernel<S, FMT, BD, kRot, false, W>(p, stream);
  }
  return cudaGetLastError();
}

template <class S, int FMT, int BD, int W>
cudaError_t launch_rot(const Params<S>& p, cudaStream_t stream) {
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) return launch_weights<S, FMT, BD, true, W>(p, stream);
  }
  return launch_weights<S, FMT, BD, false, W>(p, stream);
}

// The launch's vector width (p.width, 1 or 4, alignment checked by the
// entry point). Width 4 exists in nearest mode for the three-colour RGBA,
// SH1 and SH9 rows with no spare column (D = 4, 4, 28), as K13c's, and
// refuses any other row.
template <class S, int FMT, int BD>
cudaError_t launch(const Params<S>& p, cudaStream_t stream) {
  if (p.width == 1) return launch_rot<S, FMT, BD, 1>(p, stream);
  if constexpr (FMT == svox::kRGBA || (FMT == svox::kSH && (BD == 1 || BD == 9))) {
    constexpr int kD3 = (FMT == svox::kRGBA ? 3 : 3 * BD) + 1;
    if (p.n_color == 3 && p.D == kD3) return launch_rot<S, FMT, BD, 4>(p, stream);
  }
  return cudaErrorInvalidValue;
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
// f32 or null. format: 0 RGBA, 1 SH, 2 SG, 3 ASG. width: the vector width,
// 1 or 4; 4 takes only the nearest instances' three-colour RGBA, SH1 and
// SH9 rows (D = 4, 4, 28), with the pool aligned to 4 values (an int8
// pool's scale and zero, and tmats, to 16 bytes). All pointers but s are
// device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_render_fwd)(
    const svox::StructDesc* s, const float* origins, const float* dirs,
    const float* vdirs, int B,
    const float* offset, const float* scaling, const void* features, const float* scale,
    const float* zero, int M, int D, const float* tmats, int format, const float* extra,
    int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color, float step_size,
    float bg, float sigma_thresh, float stop_thresh, int max_steps,
    float* out, float* waccum, int width, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width != 1 && width != 4) return cudaErrorInvalidValue;
  if (width == 4 && (!svox::vector_aligned(features, scale, zero) ||
                     reinterpret_cast<uintptr_t>(tmats) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor) return cudaErrorInvalidValue;
  using S = SVOX_STRUCTURE;
  const Params<S> p{S::from(*s), origins, dirs, vdirs, B,
                    offset, scaling, svox::make_pool<svox::Pool>(features, scale, zero), M, D,
                    tmats, extra, ld_extra, basis_dim, min_comp, max_comp, n_color, step_size,
                    bg, sigma_thresh, stop_thresh, max_steps, out, waccum, width};
  switch (format) {
    case svox::kRGBA: return launch<S, svox::kRGBA, 0>(p, stream);
    case svox::kSH: return launch_basis<S, svox::kSH>(p, stream);
    case svox::kSG: return launch_basis<S, svox::kSG>(p, stream);
    case svox::kASG: return launch_basis<S, svox::kASG>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}
