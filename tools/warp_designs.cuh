// Designs of K10's backward (csrc/warp.cu `warp_bwd_kernel`) that lost to
// the shipped one on an H100 (PERF.md §6, tools/warp_bwd_ab.py).
// tools/warp_bwd_ab.py includes this file in warp.cu's anonymous namespace,
// before the backward kernel, and launches a design in place of the shipped
// dispatch, or calls a flush of its own at the run's end; it is not part
// of the library.
//
//  * tile: dT = S^T G as a split-K product over tiles of kThreads points.
//    A block walks tiles (a grid of at most two blocks an SM); for each it
//    stages the tile's clipped weights S (points, J), dense, and the outer
//    gradients G (points, 12) in shared memory, and thread t sums the
//    (joint, column) products t, t + kThreads, ... over its share of the
//    tile's points in registers (split K: kThreads / (12 J) threads a
//    product where 12 J < kThreads). No atomics until the block's end,
//    where the sums go to the shared table and from there to dT. dx and dw
//    are the shipped kernel's. Its work grows with J: at most
//    kTileJoints joints, and S sums two bones of one joint before the
//    product.
//  * slot_flush, lane_flush: the shipped runs with the run's end flushed
//    slot by slot (a warp sum where all lanes hold one joint in a slot) or
//    lane by lane.

#pragma once

constexpr int kTileJoints = 32;
// The (joint, column) products a thread owns at most: 12 kTileJoints over kThreads.
constexpr int kTilePairs = (12 * kTileJoints + kThreads - 1) / kThreads;

template <int kNB>
__global__ void __launch_bounds__(kThreads) warp_bwd_tile_kernel(const WarpParams p, const WarpGrads g) {
  __shared__ float sS[kTileJoints][kThreads];  // S transposed: a joint's weights a row
  __shared__ float sG[kThreads][13];
  extern __shared__ float table[];
  for (int e = threadIdx.x; e < p.J * kRowStride; e += blockDim.x) table[e] = 0.f;
  const int pairs = 12 * p.J;
  const int groups = max(1, kThreads / pairs);
  const int group = threadIdx.x / pairs;
  const int first = threadIdx.x - group * pairs;
  float acc[kTilePairs];
#pragma unroll
  for (int k = 0; k < kTilePairs; ++k) acc[k] = 0.f;
  WarpGrads own = g;
  own.dT = nullptr;
  RunCache unused{};
  int now = 0;
  const int n_tiles = (p.Q + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q = tile * kThreads + threadIdx.x;
    for (int j = 0; j < p.J; ++j) sS[j][threadIdx.x] = 0.f;
#pragma unroll
    for (int e = 0; e < 12; ++e) sG[threadIdx.x][e] = 0.f;
    if (q < p.Q) {
      point_bwd<kNB>(p, own, q, true, unused, table, now);
      const size_t q3 = 3 * static_cast<size_t>(q);
      const float xh[4] = {__ldg(p.x + q3), __ldg(p.x + q3 + 1), __ldg(p.x + q3 + 2), 1.f};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float gx = g.g_x ? __ldg(g.g_x + q3 + i) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float outer = gx * xh[k];
          float v = outer;
          if (g.g_M) {
            const float gm = __ldg(g.g_M + 16 * static_cast<size_t>(q) + 4 * i + k);
            v = g.g_x ? gm + outer : gm;
          }
          sG[threadIdx.x][4 * i + k] = v;
        }
      }
      const size_t base = static_cast<size_t>(q) * p.nb;
      for (int b = 0; b < p.nb; ++b) {
        const float wb = __ldg(p.w + base + b);
        const int32_t jb = __ldg(p.ji + base + b);
        const int32_t jw = jb < 0 ? jb + p.J : jb;
        if (wb > 0.f && jw >= 0 && jw < p.J) sS[jw][threadIdx.x] += wb;
      }
    }
    __syncthreads();
    if (group < groups) {
#pragma unroll
      for (int k = 0; k < kTilePairs; ++k) {
        const int pr = first + k * kThreads;
        if (pr < pairs && (groups == 1 || k == 0)) {
          const int j = pr / 12, e = pr - 12 * (pr / 12);
          float s = acc[k];
          for (int i = group; i < kThreads; i += groups) s = s + sS[j][i] * sG[i][e];
          acc[k] = s;
        }
      }
    }
    __syncthreads();
  }
  if (group < groups) {
#pragma unroll
    for (int k = 0; k < kTilePairs; ++k) {
      const int pr = first + k * kThreads;
      if (pr < pairs && (groups == 1 || k == 0)) {
        const int j = pr / 12, e = pr - 12 * (pr / 12);
        atomicAdd(table + j * kRowStride + e, acc[k]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.J * 12; e += blockDim.x) {
    const int j = e / 12, k = e - 12 * (e / 12);
    const float v = table[j * kRowStride + k];
    if (v != 0.f) atomicAdd(g.dT + 16 * j + k, v);
  }
}

template <int kNB>
cudaError_t launch_tile_instance(const WarpParams& p, const WarpGrads& g, size_t smem,
                                 cudaStream_t stream) {
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.Q + kThreads - 1) / kThreads;
  warp_bwd_tile_kernel<kNB><<<min(n_tiles, 2 * n_sm), kThreads, smem, stream>>>(p, g);
  return cudaGetLastError();
}

// The tile design: dT wanted and J <= kTileJoints (the shapes it is timed at).
cudaError_t launch_tile(const WarpParams& p, const WarpGrads& g, size_t smem, bool vec_bones,
                        cudaStream_t stream) {
  if (g.dT == nullptr || p.J > kTileJoints) return cudaErrorInvalidValue;
  if (p.nb == 4 && vec_bones) return launch_tile_instance<4>(p, g, smem, stream);
  if (p.nb == 2 && vec_bones) return launch_tile_instance<2>(p, g, smem, stream);
  return launch_tile_instance<0>(p, g, smem, stream);
}

// slot_flush: the run's end slot by slot; where all 32 lanes hold one joint
// in a slot, a butterfly sum of each column (60 shuffles) and one lane adds
// the 12 columns; else each lane adds its own.
__device__ __forceinline__ void cache_flush_slots(RunCache& c, float* table) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = c.id[k];
    const int j0 = __shfl_sync(kFull, j, 0);
    if (__all_sync(kFull, j == j0)) {
      if (j0 >= 0) {
#pragma unroll
        for (int e = 0; e < 12; ++e) {
          float v = c.s[k][e];
#pragma unroll
          for (int off = 16; off > 0; off /= 2) v = v + __shfl_xor_sync(kFull, v, off);
          c.s[k][e] = v;
        }
        if (lane == 0) flush_slot(table, j0, c.s[k]);
      }
    } else if (j >= 0) {
      flush_slot(table, j, c.s[k]);
    }
  }
}

// lane_flush: the run's end lane by lane, 12 shared adds a slot.
__device__ __forceinline__ void cache_flush_lanes(RunCache& c, float* table) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (c.id[k] >= 0) flush_slot(table, c.id[k], c.s[k]);
  }
}
