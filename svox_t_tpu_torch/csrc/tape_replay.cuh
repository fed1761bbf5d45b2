// K13c, K13d and K13e: the replay of a recorded sample tape, forward and
// backward. No structure walk, so no structure axis: a compile picks the
// pass with SVOX_TAPE_PASS (0 the forward, svox_tape_replay_fwd and
// svox_tape_replay_fwd_frames; 1 the backward, svox_tape_replay_bwd and
// svox_tape_replay_bwd_frames) and the pool type with SVOX_POOL (K5).
// tape_replay_fwd.cu and tape_replay_bwd.cu are the float32 pool's
// compiles; the bf16 and int8 instances come from `_build.POOL_INSTANCES`
// (svox_tape_replay_fwd_bf16, ..._fwd_frames_i8, ..._bwd_bf16,
// ..._bwd_frames_bf16; a quantized pool takes no gradient).
//
// Replaces: svox_t_tpu/ops/tape.py `_replay_fwd_impl` (K13c, with its
// weight accumulation and `_resolve_cells`; its frame axis the scan of
// `_replay_call_frames`), `_replay_bwd_impl` (K13d, exact mode) and
// `_replay_bwd_frames_impl` (K13e: N independent replay gradients of one
// tape over a stack of N pools). The TPU version replayed (K, C) rounds of
// count-sorted chunks through flat round programs, and K13e flushed the N
// frames' rows in one wide scatter; here one thread replays one ray's run
// of the flat tape (tape_record.cuh): samples offsets[i] to offsets[i + 1],
// each a streamed (row, dt) pair. Both passes have a frame axis,
// blockIdx.y: thread (i, n) runs ray i on frame n's pool rows and writes
// (and for the backward reads) frame n's output rows. K13c and K13d are
// their launches with one frame; svox_tape_replay_fwd_frames and K13e
// launch the N frames at once, and the frames read the same tape streams,
// which stay in L2 after the first frame's blocks have read them.
//
// Per sample the radiometry is K2's (render_fwd.cuh) operation for
// operation, and the backward's K3's single pass (render_bwd.cuh): rows
// outside [0, M) are empty space; the forward composites where sigma >
// sigma_thresh (att = exp((-dt * delta_scale) * sigma), weight = L * (1 -
// att), colors as K2), stops where stop_thresh > 0 and L <= stop_thresh
// (then colors scale by 1 / (1 - L) and no background is added), adds each
// weight into its recorded tree cell with weights, and finalizes as K2. A
// ray with no samples (a miss) gives bg + 0 and alpha 0, K2's miss row bit
// for bit. The backward (exact options only; the wrapper takes K3 for
// thresholded ones) starts acc at sum_c out_c g_c and L_ray = 1 - alpha
// from the saved forward output, and per sample with sigma > 0 adds the
// coefficient rows and the sigma column with float atomicAdd.
//
// A data-indirect tape holds tree cells; its row is table[cell], the
// frame's flat index table (JAX `_resolve_cells`): a cell outside the
// table, a negative entry or one >= M is empty. The choice is made once per
// ray (table null or not), and each branch inlines its own sample loop, so
// a direct tape pays no per-sample test: on an H100 a test per sample cost
// this kernel 7.5-8.2% (tools/tape_resolve_ab.py), at the price of compile
// time.
//
// Bound on an H100: the replay has no descent. A sample is two streamed
// loads (row 4 bytes, dt 4 bytes; a neighbouring thread's run lies
// elsewhere, so a warp's loads are not coalesced) and, where the row is
// occupied, one feature-row load (28 floats at SH9) and K2's few dozen
// flops: latency-bound, with no dependent chain between samples but the
// compositing. The scalar design paid two or three dependent round trips
// a sample: the row's sigma, then its dt and its 27 coefficients one load
// each, and the next sample's row index only after this sample had
// composited; at the minibatch step's shape (about 1.9 samples a ray,
// about 15 warps an SM) nothing hid them, and the forward took longer than
// its own backward. The forward (K13c) answers with changes to its loads,
// none to its arithmetic or its order. Its width-4 instance (the
// three-colour RGBA, SH1 and SH9 rows with no spare column, as the
// backward's) moves a row, sigma included, in one round trip of 16-byte
// loads (8 of a bf16 row, 4 of an int8 one with its columns' scale and
// zero) into registers; width 1 keeps the scalar row. And both widths load
// ahead: before sample k composites, sample k + 1's step, cell and recorded
// row or cell; at width 4 that row also resolved (through the table on an
// indirect tape) and loaded whole into a second register row, and sample
// k + 2's recorded row or cell before that. A sample whose row is resident
// then composites from registers with no load in its way. On an H100
// (tools/tape_fwd_ab.py) the row loaded ahead beat the row loaded in its
// own sample's iteration, sigma first or whole, at the deep tape's and the
// minibatch step's shapes, though its SH9 instance holds 90 registers
// against 56; the scalar row was slower with its row resolved ahead, so it
// resolves the row in the sample's own iteration. Otherwise K2's design: a ray
// per thread, basis and color sums in registers, format, rotation and the
// basis capacity as template parameters, small blocks. K13e's bound is N
// times K13d's rows and gradient bytes plus one read of the streams: the
// frame axis lets the N frames' blocks share the streams through L2
// instead of N launches each reading them; the forward's frame axis does
// the same for N replays.
//
// The backward's gradient (K13d, K13e) is the tape's heaviest traffic: per
// occupied sample it reads a D-float row and adds D floats at that row with
// float atomics, and the 32 lanes of a warp hold 32 different rows, so
// each atomic instruction is up to 32 separate L2 reductions (1,373,886
// samples x 28 at SH9 on the deep shell's tape: about 38.5M reductions
// against a byte bound of 0.10 ms). A thread keeps one ray (the acc / L
// chain runs along it) and moves its row in vectors instead: the width-4
// instance (a template parameter chosen once per launch by the wrapper)
// loads the row 4 columns at a time (16 bytes of a float32 row, 8 of a
// bf16 one) into registers, overwrites each column with its addend once
// read, and adds the row with Hopper's vector float atomics (atomicAdd on
// float4, red.global.add.v4.f32: compute capability 9.x, each element
// atomic on its own): 7 loads and 7 reductions a sample at SH9 instead of
// 28 and 28. It exists for the three-colour RGBA, SH1 and SH9 rows with
// no spare column (D = 4, 4, 28: the main paths), where n_color and D are
// template constants and the addends fall in row order in registers.
// Every other row (SH4, SH16, SG, ASG, spare columns) takes width 1, the
// scalar design: staging the row in shared memory to vectorize those was
// slower than width 1 at the minibatch step's shape on an H100. The sums
// are the same; only the atomics' grouping, and so their order, differs.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxColor = 16;

struct Params {
  const int32_t* offsets;  // (B + 1,)
  const int32_t* idx;      // rows, or tree cells on a data-indirect tape
  const float* dt;
  const int32_t* cell;     // tree cells (weights)
  const float* dscale;
  const float* vdirs;
  int B;
  const int32_t* table;    // data-indirect: the flat index table, else null
  int n_table;
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
  float bg;
  float sigma_thresh;
  float stop_thresh;
  float* out;
  float* waccum;
  const float* grad_out;
  const float* out_res;
  float* grad;
  int n_frames;            // the frame axis (1 but for the frames entries)
  int width;               // the vector width (1 or 4)
};

// The row of a recorded value v: v itself, or on a data-indirect tape the
// table's entry for the recorded cell v (-1, empty, outside the table).
template <bool kIndirect>
__device__ __forceinline__ int32_t resolve_row(const Params& p, int32_t v) {
  if constexpr (kIndirect) {
    return static_cast<uint32_t>(v) < static_cast<uint32_t>(p.n_table) ? __ldg(p.table + v) : -1;
  } else {
    return v;
  }
}

// The row of sample k.
template <bool kIndirect>
__device__ __forceinline__ int32_t sample_row(const Params& p, int32_t k) {
  return resolve_row<kIndirect>(p, __ldg(p.idx + k));
}

// The pool row's vector loads, shared with K2 (common.cuh).
using svox::color_logit;
using svox::load_row;
using svox::load_row4;
using svox::row_col;
using svox::vector_aligned;

// Frame n's pool in a stack of (M, D) pools, off = n * M * D values in (an
// int8 stack's scale and zero: qoff = n * D values in).
__device__ __forceinline__ const float* frame_features(const float* f, size_t off, size_t) {
  return f + off;
}
__device__ __forceinline__ const uint16_t* frame_features(const uint16_t* f, size_t off, size_t) {
  return f + off;
}
__device__ __forceinline__ svox::PoolI8 frame_features(const svox::PoolI8& f, size_t off,
                                                       size_t qoff) {
  return {f.q + off, f.scale + qoff, f.zero + qoff};
}

#if SVOX_TAPE_PASS == 0

// K13c on ray i of frame n. FMT: svox::kRGBA / kSH / kSG / kASG; BD: basis
// capacity (0 for RGBA); kRot: per-voxel rotation; W: the vector width.
// Frame n's pool and output lie n (M, D) and n (B, n_color + 1) blocks into
// their stacks. W = 1 reads the row a column at a time, sigma first; W = 4
// (three colours, D = 3 * BD + 1, or 4 for RGBA: n_color and D are
// constants) loads the whole row into registers, 4 columns a load. Either
// width loads sample k + 1's step, cell and recorded row or cell before
// sample k composites; W = 4 also resolves that row and loads it whole, and
// loads sample k + 2's recorded value (guarded at the run's end; after the
// stop_thresh break they go unused). With p.waccum, each compositing
// sample adds its weight at its recorded cell: a run-time test (K2 makes
// weights a template parameter to keep the leaf id out of the plain
// march's live registers), uniform across the launch.
template <int FMT, int BD, bool kRot, bool kIndirect, int W>
__device__ __forceinline__ void replay_fwd(const Params& p, int i, int n) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  constexpr bool kVec = W == 4;
  constexpr int kD = kVec ? (FMT == svox::kRGBA ? 3 : 3 * BD) + 1 : 1;
  const int nc = kVec ? 3 : p.n_color;
  const int nb = FMT == svox::kSH ? BD : p.basis_dim;
  const int D = kVec ? kD : p.D;
  const auto features = frame_features(p.features, static_cast<size_t>(n) * p.M * p.D,
                                       static_cast<size_t>(n) * p.D);
  float* out = p.out + (static_cast<size_t>(n) * p.B + i) * (nc + 1);

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
  float buf[kD];
  const float ds = p.dscale[i];
  float L = 1.f;
  bool stopped = false;
  int32_t k = p.offsets[i];
  const int32_t end = p.offsets[i + 1];
  // Loaded one sample ahead of their use: sample k's step and cell, and its
  // row, as recorded at W = 1, resolved at W = 4 with its values in nbuf;
  // at W = 4 also sample k + 1's recorded row or cell (the scalar row
  // measured slower with its row resolved ahead).
  int32_t next = 0;
  float dt_next = 0.f;
  int32_t cell_next = 0;
  int32_t v_after = 0;
  float nbuf[kD];
  if (k < end) {
    next = __ldg(p.idx + k);
    dt_next = __ldg(p.dt + k);
    if (p.waccum != nullptr) cell_next = __ldg(p.cell + k);
    if constexpr (kVec) {
      next = resolve_row<kIndirect>(p, next);
      load_row<kD>(features, next, p.M, nbuf);
      if (k + 1 < end) v_after = __ldg(p.idx + k + 1);
    }
  }
  for (; k < end; ++k) {
    const int32_t cur = next;
    const float dt = dt_next;
    const int32_t cell = cell_next;
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; ++e) buf[e] = nbuf[e];
    }
    if (k + 1 < end) {
      dt_next = __ldg(p.dt + k + 1);
      if (p.waccum != nullptr) cell_next = __ldg(p.cell + k + 1);
      if constexpr (kVec) {
        next = resolve_row<kIndirect>(p, v_after);
        load_row<kD>(features, next, p.M, nbuf);
        if (k + 2 < end) v_after = __ldg(p.idx + k + 2);
      } else {
        next = __ldg(p.idx + k + 1);
      }
    }
    const int32_t idx = kVec ? cur : resolve_row<kIndirect>(p, cur);
    if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(p.M)) continue;
    const auto row = features + static_cast<size_t>(idx) * D;
    const float sigma = row_col<W>(row, buf, D - 1);
    if (!(sigma > p.sigma_thresh)) continue;
    const float att = expf((-dt * ds) * sigma);
    const float weight = L * (1.f - att);
    if constexpr (FMT != svox::kRGBA && kRot) {
      const float* m = p.tmats + static_cast<size_t>(idx) * 16;
      const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
      const float ry = (m[4] * vx + m[5] * vy) + m[6] * vz;
      const float rz = (m[8] * vx + m[9] * vy) + m[10] * vz;
      svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb, p.min_comp, p.max_comp,
                                basis);
    }
    if constexpr (!kVec && kB >= 16) {
      // The scalar row's 16- and 25-term colours one at a time: unrolled
      // over 16 colours, their loads wanted more registers than a thread
      // has, and the int8 pool's instances spilled 7.5 KB (ptxas, H100).
#pragma unroll 1
      for (int c = 0; c < nc; ++c) {
        acc[c] = acc[c] + weight * svox::sigmoid(color_logit<FMT, kB, W>(row, buf, c, nb, basis));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kMaxColor; ++c) {
        if (c < nc) {
          acc[c] = acc[c] + weight * svox::sigmoid(color_logit<FMT, kB, W>(row, buf, c, nb, basis));
        }
      }
    }
    if (p.waccum != nullptr) atomicAdd(p.waccum + cell, weight);
    L = L * att;
    if (p.stop_thresh > 0.f && L <= p.stop_thresh) {
      stopped = true;
      break;
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

// K13c on this thread's ray and frame: the table's branch taken once.
template <int FMT, int BD, bool kRot, int W>
__device__ __forceinline__ void replay_fwd_ray(const Params& p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  if (p.table != nullptr) {
    replay_fwd<FMT, BD, kRot, true, W>(p, i, blockIdx.y);
  } else {
    replay_fwd<FMT, BD, kRot, false, W>(p, i, blockIdx.y);
  }
}

template <int FMT, int BD, bool kRot, int W>
__global__ void __launch_bounds__(kThreads) replay_fwd_kernel(const Params p) {
  replay_fwd_ray<FMT, BD, kRot, W>(p);
}

// The scalar row's 16- and 25-term instances: under ptxas's own register
// limit (64 or 128) their rolled colour loop still spilled (88 bytes in the
// int8 pool's, H100); one block an SM lets them use up to 255 registers.
// The other instances keep the limit: given the same freedom, ptxas spent
// more registers on the SH9 ones (150 at int8 width 4, against 96).
template <int FMT, int BD, bool kRot, int W>
__global__ void __launch_bounds__(kThreads, 1) replay_fwd_kernel_wide(const Params p) {
  replay_fwd_ray<FMT, BD, kRot, W>(p);
}

template <int FMT, int BD, bool kRot, int W>
cudaError_t launch_rot(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads, p.n_frames);
  if constexpr (W == 1 && BD >= 16) {
    replay_fwd_kernel_wide<FMT, BD, kRot, W><<<grid, kThreads, 0, stream>>>(p);
  } else {
    replay_fwd_kernel<FMT, BD, kRot, W><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int FMT, int BD, int W>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) return launch_rot<FMT, BD, true, W>(p, stream);
  }
  return launch_rot<FMT, BD, false, W>(p, stream);
}

#else  // SVOX_TAPE_PASS == 1

// The addend of gradient column e: put in the register row in place of the
// column (W = 4), or added at once with a float atomic.
template <int W>
__device__ __forceinline__ void put_grad(float* grow, float* buf, int e, float v) {
  if constexpr (W == 4) {
    buf[e] = v;
  } else {
    atomicAdd(grow + e, v);
  }
}

// K13d on ray i of frame n, exact options: K3's single pass over the
// tape's samples. Frame n's pool, gradient, output and output gradient lie
// n (M, D) and n (B, n_color + 1) blocks into their stacks. W is the vector
// width: 1 reads the row a column at a time and adds each addend with a
// float atomic; 4 (three colours, D = 3 * BD + 1, or 4 for RGBA: n_color
// and D are constants) copies the row into registers 4 columns a load,
// overwrites each column with its addend once read, and adds the row 4
// columns at a time with Hopper's vector float atomics. The sums and their
// rounding are the same; only the grouping of the atomics differs.
template <int FMT, int BD, bool kRot, bool kIndirect, int W>
__device__ __forceinline__ void replay_bwd(const Params& p, int i, int n) {
  constexpr int kB = FMT == svox::kRGBA ? 1 : BD;
  constexpr bool kVec = W == 4;
  constexpr int kD = kVec ? (FMT == svox::kRGBA ? 3 : 3 * BD) + 1 : 1;
  const int nc = kVec ? 3 : p.n_color;
  const int nb = FMT == svox::kSH ? BD : p.basis_dim;
  const int D = kVec ? kD : p.D;
  float buf[kD];
  const size_t frame_pool = static_cast<size_t>(n) * p.M * p.D;
  const auto features = p.features + frame_pool;
  float* const grad = p.grad + frame_pool;
  const size_t ray = static_cast<size_t>(n) * p.B + i;
  const float vx = p.vdirs[3 * i + 0];
  const float vy = p.vdirs[3 * i + 1];
  const float vz = p.vdirs[3 * i + 2];
  float basis[kB];
  if constexpr (FMT != svox::kRGBA && !kRot) {
    svox::eval_basis<FMT, BD>(vx, vy, vz, p.extra, p.ld_extra, nb, p.min_comp, p.max_comp,
                              basis);
  }
  const float* go = p.grad_out + ray * (nc + 1);
  float g[kMaxColor];
#pragma unroll
  for (int c = 0; c < kMaxColor; ++c) g[c] = c < nc ? go[c] : 0.f;
  const float g_alpha = go[nc];
  // Sums over colors run in channel order, as K3 sums them.
  const float* o = p.out_res + ray * (nc + 1);
  float acc = o[0] * g[0];
#pragma unroll
  for (int c = 1; c < kMaxColor; ++c) {
    if (c < nc) acc = acc + o[c] * g[c];
  }
  const float L_ray = 1.f - o[nc];
  const float ds = p.dscale[i];
  float L = 1.f;
  const int32_t end = p.offsets[i + 1];
  for (int32_t k = p.offsets[i]; k < end; ++k) {
    const int32_t idx = sample_row<kIndirect>(p, k);
    if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(p.M)) continue;
    const auto row = features + static_cast<size_t>(idx) * D;
    float* grow = grad + static_cast<size_t>(idx) * D;
    const float sigma = svox::ld(row + D - 1);
    if (!(sigma > 0.f)) continue;
    const float dt = __ldg(p.dt + k);
    const float att = expf((-dt * ds) * sigma);
    const float weight = L * (1.f - att);
    if constexpr (FMT != svox::kRGBA && kRot) {
      const float* m = p.tmats + static_cast<size_t>(idx) * 16;
      const float rx = (m[0] * vx + m[1] * vy) + m[2] * vz;
      const float ry = (m[4] * vx + m[5] * vy) + m[6] * vz;
      const float rz = (m[8] * vx + m[9] * vy) + m[10] * vz;
      svox::eval_basis<FMT, BD>(rx, ry, rz, p.extra, p.ld_extra, nb, p.min_comp, p.max_comp,
                                basis);
    }
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; e += 4) load_row4(row, buf, e);
    }
    float total_color = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxColor; ++c) {
      if (c < nc) {
        float s;
        if constexpr (FMT == svox::kRGBA) {
          s = svox::sigmoid(row_col<W>(row, buf, c));
        } else {
          const int e0 = c * nb;
          float z = basis[0] * row_col<W>(row, buf, e0);
#pragma unroll
          for (int k2 = 1; k2 < kB; ++k2) {
            if (k2 < nb) z = z + basis[k2] * row_col<W>(row, buf, e0 + k2);
          }
          s = svox::sigmoid(z);
        }
        total_color = total_color + s * g[c];
        const float a = (weight * (s * (1.f - s))) * g[c];
        if constexpr (FMT == svox::kRGBA) {
          put_grad<W>(grow, buf, c, a);
        } else {
#pragma unroll
          for (int k2 = 0; k2 < kB; ++k2) {
            if (k2 < nb) put_grad<W>(grow, buf, c * nb + k2, a * basis[k2]);
          }
        }
      }
    }
    const float L_after = L * att;
    const float acc_after = acc - weight * total_color;
    const float dts = dt * ds;
    put_grad<W>(grow, buf, D - 1,
                dts * (total_color * L_after - acc_after) + dts * (g_alpha * L_ray));
    if constexpr (kVec) {
#pragma unroll
      for (int e = 0; e < kD; e += 4) {
        atomicAdd(reinterpret_cast<float4*>(grow + e),
                  make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]));
      }
    }
    acc = acc_after;
    L = L_after;
  }
}

template <int FMT, int BD, bool kRot, int W>
__global__ void __launch_bounds__(kThreads) replay_bwd_kernel(const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  if (p.table != nullptr) {
    replay_bwd<FMT, BD, kRot, true, W>(p, i, blockIdx.y);
  } else {
    replay_bwd<FMT, BD, kRot, false, W>(p, i, blockIdx.y);
  }
}

template <int FMT, int BD, int W>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.B + kThreads - 1) / kThreads, p.n_frames);
  if constexpr (FMT != svox::kRGBA) {
    if (p.tmats != nullptr) {
      replay_bwd_kernel<FMT, BD, true, W><<<grid, kThreads, 0, stream>>>(p);
      return cudaGetLastError();
    }
  }
  replay_bwd_kernel<FMT, BD, false, W><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

#endif  // SVOX_TAPE_PASS

// The launch's vector width (p.width, 1 or 4, alignment checked by the
// entry point). Width 4 exists for the three-colour RGBA, SH1 and SH9 rows
// with no spare column (D = 4, 4, 28) and refuses any other row.
template <int FMT, int BD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.width == 1) return launch_width<FMT, BD, 1>(p, stream);
  if constexpr (FMT == svox::kRGBA || (FMT == svox::kSH && (BD == 1 || BD == 9))) {
    constexpr int kD3 = (FMT == svox::kRGBA ? 3 : 3 * BD) + 1;
    if (p.n_color == 3 && p.D == kD3) return launch_width<FMT, BD, 4>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// Basis instances hold 1, 4, 9, 16 or 25 terms (svox::basis_capacity); the
// bf16 and int8 pools run SG and ASG of every size on the 25-term instance,
// as K2 and K3 do.
template <int FMT>
cudaError_t launch_basis(const Params& p, cudaStream_t stream) {
  if constexpr (FMT != svox::kSH && !svox::kFloatPool) {
    if (svox::basis_capacity(FMT, p.basis_dim) == 0) return cudaErrorInvalidValue;
    return launch<FMT, svox::kMaxBasis>(p, stream);
  } else {
    switch (svox::basis_capacity(FMT, p.basis_dim)) {
      case 1: return launch<FMT, 1>(p, stream);
      case 4: return launch<FMT, 4>(p, stream);
      case 9: return launch<FMT, 9>(p, stream);
      case 16: return launch<FMT, 16>(p, stream);
      case 25: return launch<FMT, 25>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

cudaError_t launch_format(const Params& p, int format, cudaStream_t stream) {
  switch (format) {
    case svox::kRGBA: return launch<svox::kRGBA, 0>(p, stream);
    case svox::kSH: return launch_basis<svox::kSH>(p, stream);
    case svox::kSG: return launch_basis<svox::kSG>(p, stream);
    case svox::kASG: return launch_basis<svox::kASG>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const int32_t* offsets, const int32_t* idx, const float* dt,
                   const float* dscale, const float* vdirs, int B, const int32_t* table,
                   int n_table, const void* features, const float* scale, const float* zero, int M,
                   int D, const float* tmats, const float* extra, int ld_extra, int basis_dim,
                   int min_comp, int max_comp, int n_color) {
  Params p{};
  p.offsets = offsets;
  p.idx = idx;
  p.dt = dt;
  p.dscale = dscale;
  p.vdirs = vdirs;
  p.B = B;
  p.table = table;
  p.n_table = n_table;
  p.features = svox::make_pool<svox::Pool>(features, scale, zero);
  p.M = M;
  p.D = D;
  p.tmats = tmats;
  p.extra = extra;
  p.ld_extra = ld_extra;
  p.basis_dim = basis_dim;
  p.min_comp = min_comp;
  p.max_comp = max_comp;
  p.n_color = n_color;
  p.n_frames = 1;
  p.width = 1;
  return p;
}

}  // namespace

#if SVOX_TAPE_PASS == 0

namespace {

// K13c over n_frames pools (svox_tape_replay_fwd_frames; one frame with
// the cells and weights: svox_tape_replay_fwd).
cudaError_t replay_fwd_entry(const int32_t* offsets, const int32_t* idx, const float* dt,
                             const int32_t* cell, const float* dscale, const float* vdirs, int B,
                             const int32_t* table, int n_table, const void* features,
                             const float* scale, const float* zero, int M, int D,
                             const float* tmats, int format, const float* extra, int ld_extra,
                             int basis_dim, int min_comp, int max_comp, int n_color, float bg,
                             float sigma_thresh, float stop_thresh, float* out, float* waccum,
                             int n_frames, int width, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width != 1 && width != 4) return cudaErrorInvalidValue;
  if (width == 4 && !vector_aligned(features, scale, zero)) return cudaErrorInvalidValue;
  if (B <= 0 || n_frames <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor || n_frames > 65535) return cudaErrorInvalidValue;
  if (waccum != nullptr && (cell == nullptr || n_frames != 1)) return cudaErrorInvalidValue;
  Params p = make_params(offsets, idx, dt, dscale, vdirs, B, table, n_table, features, scale,
                         zero, M, D, tmats, extra, ld_extra, basis_dim, min_comp, max_comp,
                         n_color);
  p.cell = cell;
  p.bg = bg;
  p.sigma_thresh = sigma_thresh;
  p.stop_thresh = stop_thresh;
  p.out = out;
  p.waccum = waccum;
  p.n_frames = n_frames;
  p.width = width;
  return launch_format(p, format, stream);
}

}  // namespace

// K13c. The tape: offsets (B + 1,) int32, idx (offsets[B],) int32 rows (or
// tree cells with a table), dt (offsets[B],) f32, cell (offsets[B],) int32
// tree cells or null (needed with waccum), dscale (B,) f32, vdirs (B, 3)
// f32; table (n_table,) int32 the flat index table of a data-indirect tape,
// else null; features (M, D) of the source's pool type, with scale and zero
// (D,) f32 for an int8 pool, else null; tmats (M, 4, 4) f32 or null; extra
// (basis_dim, ld_extra) f32 for SG/ASG, else null; out (B, n_color + 1)
// f32; waccum (n_cells,) f32 or null. format: 0 RGBA, 1 SH, 2 SG, 3 ASG.
// width: the vector width, 1 or 4; 4 takes only the three-colour RGBA, SH1
// and SH9 rows (D = 4, 4, 28), with the pool aligned to 4 values (an int8
// pool's scale and zero to 16 bytes). All pointers are device pointers.
// Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_replay_fwd)(
    const int32_t* offsets, const int32_t* idx, const float* dt, const int32_t* cell,
    const float* dscale, const float* vdirs, int B, const int32_t* table, int n_table,
    const void* features, const float* scale, const float* zero, int M, int D,
    const float* tmats, int format, const float* extra, int ld_extra, int basis_dim,
    int min_comp, int max_comp, int n_color, float bg, float sigma_thresh, float stop_thresh,
    float* out, float* waccum, int width, int device, cudaStream_t stream) {
  return replay_fwd_entry(offsets, idx, dt, cell, dscale, vdirs, B, table, n_table, features,
                          scale, zero, M, D, tmats, format, extra, ld_extra, basis_dim, min_comp,
                          max_comp, n_color, bg, sigma_thresh, stop_thresh, out, waccum, 1, width,
                          device, stream);
}

// K13c's frame axis: the tape as svox_tape_replay_fwd (no cells or
// weights); features (N, M, D) of the source's pool type, a stack of N
// pools, with scale and zero (N, D) f32 for an int8 stack (tmats and extra
// shared by the frames); out (N, B, n_color + 1) f32, frame n equal to
// svox_tape_replay_fwd on pool n bit for bit. N <= 65535 (the grid's y
// extent); width as svox_tape_replay_fwd's. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_replay_fwd_frames)(
    const int32_t* offsets, const int32_t* idx, const float* dt, const float* dscale,
    const float* vdirs, int B, const int32_t* table, int n_table, const void* features,
    const float* scale, const float* zero, int M, int D, const float* tmats, int format,
    const float* extra, int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color,
    float bg, float sigma_thresh, float stop_thresh, float* out, int n_frames, int width,
    int device, cudaStream_t stream) {
  return replay_fwd_entry(offsets, idx, dt, nullptr, dscale, vdirs, B, table, n_table, features,
                          scale, zero, M, D, tmats, format, extra, ld_extra, basis_dim, min_comp,
                          max_comp, n_color, bg, sigma_thresh, stop_thresh, out, nullptr, n_frames,
                          width, device, stream);
}

#else

// K13e. The tape as svox_tape_replay_fwd (no cells); features (N, M, D) of
// the source's pool type, a stack of N pools (tmats and extra shared by
// the frames); grad_out and out_res (N, B, n_color + 1) f32, each frame's
// output gradient and forward output (exact options); grad (N, M, D) f32
// whatever the pool's type, zeroed by the caller. N <= 65535 (the grid's
// y extent). width: the vector width, 1 or 4; 4 takes only the three-colour
// RGBA, SH1 and SH9 rows (D = 4, 4, 28), with grad and features aligned to
// 4 elements. All pointers are device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_replay_bwd_frames)(
    const int32_t* offsets, const int32_t* idx, const float* dt, const float* dscale,
    const float* vdirs, int B, const int32_t* table, int n_table, const void* features,
    const float* scale, const float* zero, int M, int D, const float* tmats, int format,
    const float* extra, int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color,
    const float* grad_out, const float* out_res, float* grad, int n_frames, int width, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width != 1 && width != 4) return cudaErrorInvalidValue;
  if (width == 4 && (reinterpret_cast<uintptr_t>(grad) % 16 != 0 ||
                     !vector_aligned(features, scale, zero))) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0 || M <= 0 || n_frames <= 0) return cudaSuccess;
  if (n_color < 0 || n_color > kMaxColor || n_frames > 65535) return cudaErrorInvalidValue;
  Params p = make_params(offsets, idx, dt, dscale, vdirs, B, table, n_table, features, scale,
                         zero, M, D, tmats, extra, ld_extra, basis_dim, min_comp, max_comp,
                         n_color);
  p.grad_out = grad_out;
  p.out_res = out_res;
  p.grad = grad;
  p.n_frames = n_frames;
  p.width = width;
  return launch_format(p, format, stream);
}

// K13d: K13e's launch with one frame. grad_out and out_res (B, n_color +
// 1) f32; grad (M, D) f32, zeroed by the caller; width as K13e's.
extern "C" int SVOX_NAME(svox_tape_replay_bwd)(
    const int32_t* offsets, const int32_t* idx, const float* dt, const float* dscale,
    const float* vdirs, int B, const int32_t* table, int n_table, const void* features,
    const float* scale, const float* zero, int M, int D, const float* tmats, int format,
    const float* extra, int ld_extra, int basis_dim, int min_comp, int max_comp, int n_color,
    const float* grad_out, const float* out_res, float* grad, int width, int device,
    cudaStream_t stream) {
  return SVOX_NAME(svox_tape_replay_bwd_frames)(
      offsets, idx, dt, dscale, vdirs, B, table, n_table, features, scale, zero, M, D, tmats,
      format, extra, ld_extra, basis_dim, min_comp, max_comp, n_color, grad_out, out_res, grad, 1,
      width, device, stream);
}

#endif
