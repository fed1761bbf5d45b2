// K14: minibatch tape training. K14a gathers chosen rays' runs of a
// recorded tape into a standalone tape (svox_subset_gather); K14b forms the
// masked L2 loss's cotangent and the step's loss (svox_l2_cotangent); K14c
// applies the SGD update to the pool in place (svox_sgd_update).
//
// Replaces: svox_t_tpu/ops/tape_subset.py `_gather_subset` (with
// `subset_tape`), the loss inside `_train_impl` / `_train_steps_impl`
// (`jax.value_and_grad` of sum(err * err) / (B * W)), and `_sgd`. On the TPU
// the gather was one row gather of a packed int32 matrix (a ray's samples,
// view direction, delta_scale and count, count-sorted into chunks), and
// the loss and update were fused into the scanned step by XLA. Here a tape
// is ray-major already (tape_record.cuh: ray i's samples are entries
// offsets[i] to offsets[i + 1] of flat streams), so a subset is a copy of
// runs with new offsets, made on the host from the source's host counts.
//
// Bound on an H100: bytes, all three. K14a reads and writes each chosen
// run once (4 bytes a sample per stream: row, step, [t], [cell]) and 32 to
// 56 bytes a ray; it is bound by its chain of dependent loads (ids, then
// the source offsets, then the run). A warp takes 32 rays, a lane a ray: it
// loads its id, its run's start and length and its new offset (the ids and
// new offsets coalesced), writes its ray's constants, and then the warp
// copies the warp's contiguous span of the new streams, a lane an entry,
// each entry finding its ray by a 5-step search over the lanes' new
// offsets through shuffles (no memory access): stores are coalesced, loads
// contiguous within a run, and the minibatch step's 65,536 ids are one wave
// of warps that pays the chain once. The optional streams ([t], [cell], the
// rays) are template parameters: as per-sample tests they cost up to
// 1.43x (a tie at 262,144 ids), and a thread a ray lost 1.27-2.29x
// (tools/subset_gather_designs.cuh, PERF.md §6). K14b reads a replay row and a target row per
// ray and writes the cotangent row: a thread per ray, and the loss from
// per-block partial sums in a fixed order, summed by a second one-block
// pass, so the loss is deterministic and stays on the card. K14c reads the
// pool and its float32 gradient once and writes the pool once (12 bytes an
// element: 29.6 MB, 0.0088 ms at 3.35 TB/s, for bench.py's 88,008 x 28
// pool): each thread moves 16 bytes an access, kUnroll vectors of pool and
// gradient in flight, as PyTorch's own elementwise kernels do; the grid
// is sized from the element count (at most two waves of the SMs), the
// gradient streams past L2 (evict-first), and a slice of a pool that does
// not start on 16 bytes takes a scalar head, as a count that is not a
// multiple of 4 takes a scalar tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// K14a's pointers: the source tape's offsets, the chosen ids and the new
// offsets (B + 1), then each stream's source and destination; a stream
// that is not copied has null pointers (and its template flag off).
struct GatherArgs {
  const int32_t* src_offsets;
  const int32_t* ids;
  const int32_t* dst_offsets;
  int B;
  const int32_t* idx_src;
  int32_t* idx_dst;
  const float* dt_src;
  float* dt_dst;
  const float* t_src;
  float* t_dst;
  const int32_t* cell_src;
  int32_t* cell_dst;
  const float* vdirs_src;
  float* vdirs_dst;
  const float* ds_src;
  float* ds_dst;
  int32_t* counts_dst;
  const float* o_src;
  float* o_dst;
  const float* d_src;
  float* d_dst;
};

// 128-thread blocks: at B = 65,536 the grid's 2,048 warps are 512 blocks,
// one wave spread over every SM.
constexpr int kGatherThreads = 128;
constexpr int kGatherWarps = kGatherThreads / 32;

// K14a: warp w takes rays 32 w .. 32 w + 31 (lane l ray r = 32 w + l, id
// ids[r]); their runs fill entries dst_offsets[32 w] .. dst_offsets[32 w +
// n_own] of the new streams, which the warp copies a lane an entry. kT,
// kCell: copy the t and cell streams; kRays: the origins and dirs.
template <bool kT, bool kCell, bool kRays>
__global__ void __launch_bounds__(kGatherThreads) gather_kernel(const GatherArgs a) {
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kGatherWarps + threadIdx.x / 32) * 32;
  if (r0 >= a.B) return;  // the whole warp
  const int n_own = min(32, a.B - r0);
  const int r = r0 + lane;
  // Lanes past B hold d0 = INT_MAX, so no entry's search stops on them.
  int32_t i = 0, s0 = 0, n = 0, d0 = 0x7fffffff;
  if (lane < n_own) {
    i = __ldg(a.ids + r);
    d0 = __ldg(a.dst_offsets + r);
    s0 = __ldg(a.src_offsets + i);
    n = __ldg(a.src_offsets + i + 1) - s0;
  }
  const int32_t first = __shfl_sync(kFull, d0, 0);
  const int32_t len = __ldg(a.dst_offsets + r0 + n_own) - first;
  // The ray's constants, from the lane that owns it.
  if (lane < n_own) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.vdirs_dst[3 * r + c] = __ldg(a.vdirs_src + 3 * i + c);
      if constexpr (kRays) {
        a.o_dst[3 * r + c] = __ldg(a.o_src + 3 * i + c);
        a.d_dst[3 * r + c] = __ldg(a.d_src + 3 * i + c);
      }
    }
    a.ds_dst[r] = __ldg(a.ds_src + i);
    a.counts_dst[r] = n;
  }
  for (int32_t q = 0; q < len; q += 32) {
    const int32_t p = first + q + lane;
    // Entry p's ray: the last lane k with d0[k] <= p (a zero-count ray
    // shares its d0 with the next, which the search prefers).
    int k = 0;
    int32_t dk = first;
#pragma unroll
    for (int step = 16; step > 0; step /= 2) {
      const int32_t dc = __shfl_sync(kFull, d0, k + step);
      if (dc <= p) {
        k += step;
        dk = dc;
      }
    }
    const int32_t src = __shfl_sync(kFull, s0, k) + (p - dk);
    if (q + lane < len) {
      a.idx_dst[p] = __ldg(a.idx_src + src);
      a.dt_dst[p] = __ldg(a.dt_src + src);
      if constexpr (kT) a.t_dst[p] = __ldg(a.t_src + src);
      if constexpr (kCell) a.cell_dst[p] = __ldg(a.cell_src + src);
    }
  }
}

template <bool kT, bool kCell, bool kRays>
cudaError_t launch_gather(const GatherArgs& a, cudaStream_t stream) {
  const int warps = (a.B + 31) / 32;
  const int grid = (warps + kGatherWarps - 1) / kGatherWarps;
  gather_kernel<kT, kCell, kRays><<<grid, kGatherThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool kT, bool kCell>
cudaError_t launch_gather(const GatherArgs& a, bool rays, cudaStream_t stream) {
  return rays ? launch_gather<kT, kCell, true>(a, stream) : launch_gather<kT, kCell, false>(a, stream);
}

// The instance of the streams a call copies.
cudaError_t launch_gather(const GatherArgs& a, cudaStream_t stream) {
  const bool t = a.t_dst != nullptr, cell = a.cell_dst != nullptr, rays = a.o_dst != nullptr;
  if (t) {
    return cell ? launch_gather<true, true>(a, rays, stream) : launch_gather<true, false>(a, rays, stream);
  }
  return cell ? launch_gather<false, true>(a, rays, stream) : launch_gather<false, false>(a, rays, stream);
}

// Sum of v over the block, on thread 0 (a fixed order: warp shuffles, then
// the warps' sums by warp 0).
template <class T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) / 32;
    v = lane < n_warps ? warp_sums[lane] : T(0);
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// K14b, pass 1: thread i takes ray i's replay row out[i] (C columns) and
// its target row targets[r] (r = ids[i], or i without ids). Columns c < W:
// err = out - target, cotangent (err * inv_bw) * 2 (the JAX autodiff of
// sum(err * err) * inv_bw); columns >= W: 0. partials[block] = the block's
// sum of err * err.
__global__ void __launch_bounds__(kThreads) cotangent_kernel(
    const float* __restrict__ out, int B, int C, const float* __restrict__ targets, int ld_tgt,
    const int32_t* __restrict__ ids, int W, float inv_bw, float* __restrict__ grad_out,
    float* __restrict__ partials) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float sq = 0.f;
  if (i < B) {
    const int64_t r = ids != nullptr ? __ldg(ids + i) : i;
    for (int c = 0; c < C; ++c) {
      float g = 0.f;
      if (c < W) {
        const float err = __ldg(out + static_cast<int64_t>(i) * C + c) -
                          __ldg(targets + r * ld_tgt + c);
        sq += err * err;
        g = (err * inv_bw) * 2.f;
      }
      grad_out[static_cast<int64_t>(i) * C + c] = g;
    }
  }
  sq = block_sum(sq);
  if (threadIdx.x == 0) partials[blockIdx.x] = sq;
}

// K14b, pass 2 (one block): loss = float(sum of the partials, in double, in
// a fixed order) * inv_bw.
__global__ void __launch_bounds__(1024) loss_kernel(const float* __restrict__ partials, int n,
                                                    float inv_bw, float* __restrict__ loss) {
  double s = 0.0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) s += static_cast<double>(partials[k]);
  s = block_sum(s);
  if (threadIdx.x == 0) *loss = static_cast<float>(s) * inv_bw;
}

// K14c on a float32 pool: f = f - lr * g, the product and the difference
// each rounded (the library is built with -fmad=false). 16 bytes a thread
// and access: the n_vec float4 vectors from f + head, kUnroll of them in
// flight per thread (a block's kSgdThreads * kUnroll vectors are neighbours,
// so each load is coalesced), the pool loaded and stored as usual (the next
// step's replay reads it from L2), the gradient, read once, with
// evict-first loads (__ldcs). kGVec: the gradient is 16-byte aligned at
// g + head as well, else its four columns load one by one. The first head
// (< 4) elements, up to f's 16-byte boundary, and the last tail (< 4) take
// a scalar step each on the first threads of the grid. 128-thread blocks,
// 4 vectors a thread: on an H100 it ties with pool.add_, L2 cold and warm
// (chip_smoke.py times the two in turns).
constexpr int kSgdThreads = 128;
constexpr int kUnroll = 4;

__device__ __forceinline__ float sgd_step(float f, float g, float lr) { return f - lr * g; }

template <bool kGVec>
__device__ __forceinline__ float4 load_grad(const float* g, int64_t v) {
  if constexpr (kGVec) {
    return __ldcs(reinterpret_cast<const float4*>(g) + v);
  } else {
    return make_float4(__ldcs(g + 4 * v), __ldcs(g + 4 * v + 1), __ldcs(g + 4 * v + 2),
                       __ldcs(g + 4 * v + 3));
  }
}

template <bool kGVec>
__global__ void __launch_bounds__(kSgdThreads) sgd_f32_kernel(float* __restrict__ f,
                                                           const float* __restrict__ g,
                                                           int head, int64_t n_vec, int tail,
                                                           float lr) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kSgdThreads) + threadIdx.x;
  if (t < head) f[t] = sgd_step(f[t], __ldcs(g + t), lr);
  const int64_t last = head + 4 * n_vec;
  if (t < tail) f[last + t] = sgd_step(f[last + t], __ldcs(g + last + t), lr);
  float4* fv = reinterpret_cast<float4*>(f + head);
  const float* gv = g + head;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kSgdThreads * kUnroll;
  for (int64_t base = blockIdx.x * static_cast<int64_t>(kSgdThreads) * kUnroll + threadIdx.x;
       base < n_vec; base += step) {
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = base + j * kSgdThreads;
      if (v < n_vec) {
        a[j] = fv[v];
        b[j] = load_grad<kGVec>(gv, v);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t v = base + j * kSgdThreads;
      if (v < n_vec) {
        fv[v] = make_float4(sgd_step(a[j].x, b[j].x, lr), sgd_step(a[j].y, b[j].y, lr),
                            sgd_step(a[j].z, b[j].z, lr), sgd_step(a[j].w, b[j].w, lr));
      }
    }
  }
}

}  // namespace

// K14a. src_offsets (n_src + 1,) i32 the source tape's offsets; ids (B,) i32
// the chosen rays (duplicates allowed, each < n_src); dst_offsets (B + 1,)
// i32 the new tape's offsets (exclusive sums of the chosen counts). Streams
// of the source and of the new tape, the latter dst_offsets[B] long: idx
// i32, dt f32, t f32 and cell i32 (null to skip both). Per ray: vdirs (., 3)
// f32, dscale f32, counts_dst i32 (written), origins and dirs (., 3) f32
// (null to skip both). All pointers are device pointers. Returns a
// cudaError_t.
extern "C" int svox_subset_gather(const int32_t* src_offsets, const int32_t* ids,
                                  const int32_t* dst_offsets, int B,
                                  const int32_t* idx_src, int32_t* idx_dst,
                                  const float* dt_src, float* dt_dst,
                                  const float* t_src, float* t_dst,
                                  const int32_t* cell_src, int32_t* cell_dst,
                                  const float* vdirs_src, float* vdirs_dst,
                                  const float* ds_src, float* ds_dst, int32_t* counts_dst,
                                  const float* o_src, float* o_dst,
                                  const float* d_src, float* d_dst,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if ((t_dst != nullptr && t_src == nullptr) || (cell_dst != nullptr && cell_src == nullptr) ||
      (o_dst != nullptr && (o_src == nullptr || d_src == nullptr || d_dst == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const GatherArgs a{src_offsets, ids,    dst_offsets, B,        idx_src,   idx_dst,   dt_src,
                     dt_dst,      t_src,  t_dst,       cell_src, cell_dst,  vdirs_src, vdirs_dst,
                     ds_src,      ds_dst, counts_dst,  o_src,    o_dst,     d_src,     d_dst};
  return launch_gather(a, stream);
}

// K14b. out (B, C) f32 replay rows; targets (n_targets, ld_tgt) f32 with
// ld_tgt >= W; ids (B,) i32 target row per ray, or null for row i; W <= C
// loss columns; inv_bw = float32(1 / (B * W)); grad_out (B, C) f32
// (written); partials ((B + 255) / 256,) f32 scratch; loss one f32
// (written). All pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_l2_cotangent(const float* out, int B, int C, const float* targets, int ld_tgt,
                                 const int32_t* ids, int W, float inv_bw, float* grad_out,
                                 float* partials, float* loss, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (W < 0 || W > C || ld_tgt < W) return cudaErrorInvalidValue;
  const int n_blocks = (B + kThreads - 1) / kThreads;
  if (B > 0) {
    cotangent_kernel<<<n_blocks, kThreads, 0, stream>>>(out, B, C, targets, ld_tgt, ids, W, inv_bw,
                                                        grad_out, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  loss_kernel<<<1, 1024, 0, stream>>>(partials, n_blocks, inv_bw, loss);
  return cudaGetLastError();
}

// K14c. features (n,) f32, updated in place; grad (n,) f32. All pointers
// are device pointers. The grid covers the vectors once, up to two waves
// of the card's SMs (kSgdThreads-thread blocks, 16 resident a SM), and
// strides beyond. Returns a cudaError_t.
extern "C" int svox_sgd_update(float* features, const float* grad, long long n, float lr,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const uintptr_t fa = reinterpret_cast<uintptr_t>(features);
  const long long to_aligned = static_cast<long long>((16 - fa % 16) % 16) / 4;
  const long long head = to_aligned < n ? to_aligned : n;
  const long long n_vec = (n - head) / 4;
  const int tail = static_cast<int>(n - head - 4 * n_vec);
  const long long want = (n_vec + kSgdThreads * kUnroll - 1) / (kSgdThreads * kUnroll);
  const long long cap = 2LL * 16 * n_sm;
  const int grid = static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
  const bool g_vec = (reinterpret_cast<uintptr_t>(grad + head)) % 16 == 0;
  if (g_vec) {
    sgd_f32_kernel<true><<<grid, kSgdThreads, 0, stream>>>(features, grad, static_cast<int>(head), n_vec,
                                                        tail, lr);
  } else {
    sgd_f32_kernel<false><<<grid, kSgdThreads, 0, stream>>>(features, grad, static_cast<int>(head),
                                                         n_vec, tail, lr);
  }
  return cudaGetLastError();
}
