// K8b (tree editing): assign, unique_leaf_nodes and calc_corners.
//
// Replaces: svox_t_tpu/ops/query.py `assign` (a batched descent, then
// `features.at[row].set(values, mode="drop")`), `unique_leaf_nodes`
// (`jnp.unique(ids, size=size, fill_value=-1)`, unpacked to
// [node, x, y, z]) and `calc_corners` (a fixed-trip-count walk up
// `parent_depth` that folds `out = (out + xyz) / N` per level).
//
// assign, two launches: one thread per point descends (svox::descend,
// common.cuh) and, when its leaf's row is < M, takes the row with
// atomicMax(winner + row, point id), so the largest point id wins where
// several points hit one row (the JAX scatter leaves that winner
// unspecified; construct_tree.cu picks the same way). Then one thread per
// pool element writes the new pool: the winner's value where a point won
// the row, else the old feature. Empty leaves and rows >= M are dropped.
// Bound on an H100: the copy, which reads and writes the whole (M, D)
// pool (157 MB at depth 9 SH9); the descent is latency bound as in
// query.cu, one small thread per point.
//
// unique_leaf_nodes, a mark-scan-compact over the packed-id range
// [0, n_cells) (n_cells = capacity * N^3, a few MB of flags): a mark
// kernel sets flag[id] = 1 (plain idempotent stores); a count kernel sums
// each tile of kTile flags; one block scans the tile sums into tile
// offsets and writes the count; a compact kernel re-scans each tile and
// writes each flagged id, unpacked, at its offset, one 16-byte store per
// row. The result is in ascending packed-id order, as jnp.unique sorts,
// deterministic, with no sort and no atomics. The output is preset to -1
// (a byte memset), so the rows from count to size are the padding. Bound
// on an H100: the bytes (the ids in, the rows out) take ~0.015 ms at the
// depth-9 shell's 2.5M ids; the launches and the mark kernel's scattered
// stores cost more. A first compact kernel that wrote each row as four
// 4-byte stores took 0.106 ms of the call's 0.180 ms of device time
// (NVIDIA H100 80GB HBM3, 700 W).
//
// calc_corners: one thread per (node, x, y, z) row walks the packed parent
// links to the root, at most n_levels + 1 steps, folding the float32 sum
// in the JAX order: add, then a true division by N (no reciprocal, no
// contraction: the library is built with -fmad=false). The unpacking uses
// floor division and modulo, as jnp's integer // and % do, so even the
// cells of freed nodes (parent link -1) walk as in the JAX package. Bound
// on an H100: latency of the dependent parent loads (depth + 1 of them);
// the design is one thread per row with a tiny footprint.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kScanThreads * kItems;

__global__ void assign_winner_kernel(const float* __restrict__ points, int Q, int world,
                                     const int32_t* __restrict__ child,
                                     const int32_t* __restrict__ data, int N, int n_levels,
                                     const float* __restrict__ offset,
                                     const float* __restrict__ scaling, int M,
                                     int32_t* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  float x = points[3 * i + 0], y = points[3 * i + 1], z = points[3 * i + 2];
  if (world) {  // world2tree: offset + scaling * pos
    x = offset[0] + scaling[0] * x;
    y = offset[1] + scaling[1] * y;
    z = offset[2] + scaling[2] * z;
  }
  const svox::Leaf leaf = svox::descend(child, N, n_levels, x, y, z);
  const int32_t row = __ldg(data + leaf.flat);
  if (static_cast<uint32_t>(row) < static_cast<uint32_t>(M)) atomicMax(winner + row, i);
}

__global__ void assign_copy_kernel(const float* __restrict__ features,
                                   const float* __restrict__ values,
                                   const int32_t* __restrict__ winner, int64_t n, int D,
                                   float* __restrict__ out) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / D;
    const int32_t w = __ldg(winner + r);
    out[e] = w >= 0 ? __ldg(values + static_cast<int64_t>(w) * D + (e - r * D)) : __ldg(features + e);
  }
}

// Exclusive prefix sum of one value per thread over the block (blockDim.x
// a multiple of 32, at most 1024); `total` receives the block's sum. Every
// thread of the block must call it.
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += up;
    }
    warp_sums[lane] = s;  // inclusive prefix of the warp totals
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  total = warp_sums[n_warps - 1];
  __syncthreads();  // the next call may overwrite warp_sums
  return before + incl - v;
}

// The kItems flags of this thread in its tile, zeros past n_cells.
__device__ __forceinline__ void load_flags(const int32_t* __restrict__ flags, int64_t base,
                                           int n_cells, int f[kItems]) {
  if (base + kItems <= n_cells) {  // base is a multiple of 4: a 16-byte load
    const int4 v = __ldg(reinterpret_cast<const int4*>(flags + base));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) f[k] = base + k < n_cells ? flags[base + k] : 0;
  }
}

__global__ void mark_kernel(const int32_t* __restrict__ ids, int Q, int n_cells,
                            int32_t* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int32_t id = ids[i];
  if (static_cast<uint32_t>(id) < static_cast<uint32_t>(n_cells)) flags[id] = 1;
}

__global__ void tile_count_kernel(const int32_t* __restrict__ flags, int n_cells,
                                  int32_t* __restrict__ tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int f[kItems];
  load_flags(flags, base, n_cells, f);
  int total;
  block_exclusive_scan(f[0] + f[1] + f[2] + f[3], total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: the exclusive scan of the tile sums, in chunks of blockDim.x
// with a running carry; count = min(sum of all, size).
__global__ void tile_offsets_kernel(const int32_t* __restrict__ tile_sums, int n_tiles,
                                    int size, int32_t* __restrict__ tile_offsets,
                                    int32_t* __restrict__ count) {
  int carry = 0;
  for (int start = 0; start < n_tiles; start += blockDim.x) {
    const int i = start + threadIdx.x;
    int total;
    const int excl = block_exclusive_scan(i < n_tiles ? tile_sums[i] : 0, total);
    if (i < n_tiles) tile_offsets[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *count = min(carry, size);
}

// Floor division and modulo by n > 0, as jnp's integer // and % round.
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int floor_div(int a, int n) {
  const int q = a / n;
  return (a % n != 0 && a < 0) ? q - 1 : q;
}

__global__ void compact_kernel(const int32_t* __restrict__ flags, int n_cells,
                               const int32_t* __restrict__ tile_offsets, int N, int size,
                               int32_t* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int f[kItems];
  load_flags(flags, base, n_cells, f);
  int total;
  int pos = tile_offsets[blockIdx.x] + block_exclusive_scan(f[0] + f[1] + f[2] + f[3], total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!f[k]) continue;
    if (pos < size) {  // one 16-byte store per row [node, x, y, z]
      int id = static_cast<int>(base + k);
      const int z = id % N;
      id /= N;
      const int y = id % N;
      id /= N;
      const int x = id % N;
      reinterpret_cast<int4*>(out)[pos] = make_int4(id / N, x, y, z);
    }
    ++pos;
  }
}

__global__ void calc_corners_kernel(const int32_t* __restrict__ indexer, int Q,
                                    const int32_t* __restrict__ parent_depth, int capacity,
                                    int N, int steps, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  int node = indexer[4 * i + 0], x = indexer[4 * i + 1], y = indexer[4 * i + 2],
      z = indexer[4 * i + 3];
  const float Nf = static_cast<float>(N);
  float ox = 0.f, oy = 0.f, oz = 0.f;
  for (int s = 0; s < steps; ++s) {
    ox = (ox + static_cast<float>(x)) / Nf;
    oy = (oy + static_cast<float>(y)) / Nf;
    oz = (oz + static_cast<float>(z)) / Nf;
    if (node == 0) break;
    int p = __ldg(parent_depth + 2 * static_cast<int64_t>(min(max(node, 0), capacity - 1)));
    z = floor_mod(p, N);
    p = floor_div(p, N);
    y = floor_mod(p, N);
    p = floor_div(p, N);
    x = floor_mod(p, N);
    node = floor_div(p, N);
  }
  out[3 * i + 0] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

}  // namespace

// K8b assign. points (Q, 3) f32 (world space when world != 0, else tree
// space); child/data (capacity * N^3,) i32; offset/scaling (3,) f32;
// features (M, D) f32; values (Q, D) f32; winner (M,) i32 scratch; out
// (M, D) f32, the new pool. All pointers are device pointers. Returns a
// cudaError_t.
extern "C" int svox_assign(const float* points, int Q, int world, const int32_t* child,
                           const int32_t* data, int N, int n_levels, const float* offset,
                           const float* scaling, const float* features, int M, int D,
                           const float* values, int32_t* winner, float* out, int device,
                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || D <= 0) return cudaSuccess;
  err = cudaMemsetAsync(winner, 0xFF, sizeof(int32_t) * static_cast<size_t>(M), stream);
  if (err != cudaSuccess) return err;
  if (Q > 0) {
    assign_winner_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        points, Q, world, child, data, N, n_levels, offset, scaling, M, winner);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t n = static_cast<int64_t>(M) * D;
  const int64_t blocks = std::min<int64_t>((n + kThreads - 1) / kThreads, 132 * 32);
  assign_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      features, values, winner, n, D, out);
  return cudaGetLastError();
}

// K8b unique_leaf_nodes. ids (Q,) i32 packed leaf ids (ids outside
// [0, n_cells) are ignored); flags (n_cells,) i32, tile_sums and
// tile_offsets (ceil(n_cells / 4096),) i32 scratch, flags 16-byte aligned;
// out (size, 4) i32 rows [node, x, y, z], 16-byte aligned, in ascending
// packed-id order, -1 past the count; count
// () i32 = min(number of distinct ids, size). All pointers are device
// pointers. Returns a cudaError_t.
extern "C" int svox_unique_leaf(const int32_t* ids, int Q, int n_cells, int N, int size,
                                int32_t* flags, int32_t* tile_sums, int32_t* tile_offsets,
                                int32_t* out, int32_t* count, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_cells + kTile - 1) / kTile;
  if (n_cells > 0) {
    err = cudaMemsetAsync(flags, 0, sizeof(int32_t) * static_cast<size_t>(n_cells), stream);
    if (err != cudaSuccess) return err;
  }
  if (size > 0) {
    err = cudaMemsetAsync(out, 0xFF, sizeof(int32_t) * 4 * static_cast<size_t>(size), stream);
    if (err != cudaSuccess) return err;
  }
  if (Q > 0 && n_cells > 0) {
    mark_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(ids, Q, n_cells, flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_tiles > 0) {
    tile_count_kernel<<<n_tiles, kScanThreads, 0, stream>>>(flags, n_cells, tile_sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  tile_offsets_kernel<<<1, kScanThreads, 0, stream>>>(tile_sums, n_tiles, size, tile_offsets,
                                                      count);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return err;
  compact_kernel<<<n_tiles, kScanThreads, 0, stream>>>(flags, n_cells, tile_offsets, N, size,
                                                       out);
  return cudaGetLastError();
}

// K8b calc_corners. indexer (Q, 4) i32 [node, x, y, z]; parent_depth
// (capacity, 2) i32; out (Q, 3) f32 tree-space lower corners. steps =
// n_levels + 1. All pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_calc_corners(const int32_t* indexer, int Q, const int32_t* parent_depth,
                                 int capacity, int N, int steps, float* out, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  calc_corners_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      indexer, Q, parent_depth, capacity, N, steps, out);
  return cudaGetLastError();
}
