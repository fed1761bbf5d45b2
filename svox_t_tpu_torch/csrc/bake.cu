// K6 and K7: the baked point lookup, the refresh of a bake from a
// re-pointed index table, and the regrowth of its skip boxes.
//
// Replaces: svox_t_tpu/ops/bake.py `lookup` (K6; the march kernels carry
// the same lookup inline, common.cuh Baked::lookup), `refresh` (K7a) and
// `grow_boxes_device` (K7b). The bake itself is host NumPy in both
// packages.
//
//  * Lookup: one thread per point runs Baked::lookup and writes the row,
//    cube size, in-leaf fraction and baked cell, so the device function the
//    marches use can be held bit for bit against the plain version. Bound
//    on an H100: latency, two or three dependent loads per point.
//  * Refresh: one thread per baked cell packs depth_parts[c] |
//    clamp(data[src_map[c]]) (a row < 0 or > EMPTY_ROW is EMPTY_ROW) into
//    the top, mid or brick table that owns c; a top or mid entry that
//    points at a brick (< 0) stays. Bound on an H100: bytes, about 20 per
//    cell (src_map, depth_parts, one gathered data entry, the old top/mid
//    entry, the new entry); the gather from the index table is the one
//    uncoalesced read.
//  * Regrowth: the JAX package runs _SKIP_EXT_MAX rounds of a 3x3x3
//    dilation of the top grid's occupancy and counts the rounds each cell
//    stays empty. That count is a function of the cell's Chebyshev
//    distance to the nearest occupied cell, which three separable passes
//    give (one launch per axis, one thread per cell, 31 reads each, uint8
//    distances capped at 16); a fourth launch packs the symmetric extent
//    of every empty in-top leaf. A first version with one launch per
//    round (17 in all) spent 0.11-0.14 ms on a 64^3 grid, mostly launches
//    (NVIDIA H100 80GB HBM3, 700 W). The top grid is at most 2^21 cells.
//
// Integer work only, beside the lookup's float arithmetic, which follows
// the plain version (ops/bake.py) operation for operation.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmptyRow = svox::kRowMask;
constexpr int32_t kSkipBase = 1 << 26;
constexpr int kSkipExtMax = 15;

__global__ void lookup_kernel(const svox::Baked b, const float* __restrict__ pos, int Q,
                              int32_t* __restrict__ row, float* __restrict__ cube,
                              float* __restrict__ frac, int32_t* __restrict__ cell) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const svox::Leaf l = b.lookup(pos[3 * i + 0], pos[3 * i + 1], pos[3 * i + 2]);
  row[i] = l.row;
  cube[i] = l.cube_sz;
  frac[3 * i + 0] = l.fx;
  frac[3 * i + 1] = l.fy;
  frac[3 * i + 2] = l.fz;
  cell[i] = l.flat;
}

__global__ void refresh_kernel(const int32_t* __restrict__ data,
                               const int32_t* __restrict__ src_map,
                               const int32_t* __restrict__ depth_parts,
                               const int32_t* __restrict__ top_in,
                               const int32_t* __restrict__ mid_in, int n_top, int n_mid,
                               int n_cells, int32_t* __restrict__ top_out,
                               int32_t* __restrict__ mid_out, int32_t* __restrict__ brick_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  int32_t row = __ldg(data + __ldg(src_map + c));
  if (row < 0 || row > kEmptyRow) row = kEmptyRow;
  const int32_t packed = __ldg(depth_parts + c) | row;
  if (c < n_top) {
    const int32_t e = __ldg(top_in + c);
    top_out[c] = e < 0 ? e : packed;
  } else if (c < n_top + n_mid) {
    const int32_t e = __ldg(mid_in + (c - n_top));
    mid_out[c - n_top] = e < 0 ? e : packed;
  } else {
    brick_out[c - n_top - n_mid] = packed;
  }
}

__device__ __forceinline__ bool occupied(int32_t e) {
  return e < 0 || (e & svox::kRowMask) < kSkipBase;
}

// The Chebyshev distance from each top cell to the nearest occupied one,
// capped at kSkipExtMax + 1, in three separable passes (an L-infinity
// distance is the max of its axes' distances): along z from the
// occupancy, then along y and x, each pass the least max(|step|, the
// previous pass's distance) over steps of at most kSkipExtMax cells.
// Cells outside the grid are empty. A cell at distance d stays empty
// through min(max(d - 1, 0), kSkipExtMax) of the 3x3x3 dilation rounds
// of the JAX package's `grow_boxes_device`.
constexpr int kFar = kSkipExtMax + 1;

template <int AXIS>
__global__ void distance_pass(const int32_t* __restrict__ top, const uint8_t* __restrict__ in,
                              int R, uint8_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R * R * R) return;
  const int coord = AXIS == 0 ? c / (R * R) : AXIS == 1 ? (c / R) % R : c % R;
  const int stride = AXIS == 0 ? R * R : AXIS == 1 ? R : 1;
  int best = kFar;
  for (int k = -kSkipExtMax; k <= kSkipExtMax; ++k) {
    const int q = coord + k;
    if (q < 0 || q >= R) continue;
    const int n = c + k * stride;
    const int d = AXIS == 2 ? (occupied(__ldg(top + n)) ? 0 : kFar) : in[n];
    best = min(best, max(abs(k), d));
  }
  out[c] = static_cast<uint8_t>(best);
}

// An empty cell of a leaf s top cells a side packs the extent
// clip(floor((e - s + 1) / s), 0, 15) in all six nibbles, e the rounds it
// stays empty.
__global__ void pack_boxes_kernel(const int32_t* __restrict__ top, int R, int N,
                                  const uint8_t* __restrict__ dist, int32_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R * R * R) return;
  const int32_t e = __ldg(top + c);
  if (occupied(e)) {
    out[c] = e;
    return;
  }
  const int e_map = min(max(static_cast<int>(dist[c]) - 1, 0), kSkipExtMax);
  const int depth = static_cast<int>(static_cast<uint32_t>(e) >> svox::kRowBits);
  const int cube = svox::ipow(N, depth + 1);
  const int s = max(R / max(cube, 1), 1);
  const int num = e_map - (s - 1);
  const int ext = num < 0 ? 0 : min(num / s, kSkipExtMax);
  out[c] = ext > 0 ? (e & ~svox::kRowMask) | (kSkipBase + ext * 0x111111) : e;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// K6. s the bake (svox::StructDesc, host memory); pos (Q, 3) f32 tree
// space; row (Q,) i32, cube (Q,) f32, frac (Q, 3) f32, cell (Q,) i32 baked
// cell. All pointers but s are device pointers. Returns a cudaError_t.
extern "C" int svox_bake_lookup(const svox::StructDesc* s, const float* pos, int Q,
                                int32_t* row, float* cube, float* frac, int32_t* cell,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  lookup_kernel<<<blocks(Q), kThreads, 0, stream>>>(svox::Baked::from(*s), pos, Q, row, cube,
                                                     frac, cell);
  return cudaGetLastError();
}

// K7a. data (n_tree_cells,) i32 the re-pointed index table; src_map and
// depth_parts (n_top + n_mid + n_brick,) i32; top_in (n_top,) and mid_in
// (n_mid,) i32 (null when n_mid is 0) the current tables; top, mid and
// brick out, of the same sizes. Device pointers; returns a cudaError_t.
extern "C" int svox_bake_refresh(const int32_t* data, const int32_t* src_map,
                                 const int32_t* depth_parts, const int32_t* top_in,
                                 const int32_t* mid_in, int n_top, int n_mid, int n_brick,
                                 int32_t* top_out, int32_t* mid_out, int32_t* brick_out,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n = n_top + n_mid + n_brick;
  if (n <= 0) return cudaSuccess;
  refresh_kernel<<<blocks(n), kThreads, 0, stream>>>(data, src_map, depth_parts, top_in, mid_in,
                                                      n_top, n_mid, n, top_out, mid_out,
                                                      brick_out);
  return cudaGetLastError();
}

// K7b. top (R^3,) i32 the refreshed top grid of a bake with skip coding;
// dist_a, dist_b (R^3,) u8 scratch; out (R^3,) i32 the top grid with the
// regrown boxes. Device pointers; returns a cudaError_t.
extern "C" int svox_grow_boxes(const int32_t* top, int R, int N, uint8_t* dist_a,
                               uint8_t* dist_b, int32_t* out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n = R * R * R;
  if (n <= 0) return cudaSuccess;
  distance_pass<2><<<blocks(n), kThreads, 0, stream>>>(top, nullptr, R, dist_a);
  distance_pass<1><<<blocks(n), kThreads, 0, stream>>>(top, dist_a, R, dist_b);
  distance_pass<0><<<blocks(n), kThreads, 0, stream>>>(top, dist_b, R, dist_a);
  pack_boxes_kernel<<<blocks(n), kThreads, 0, stream>>>(top, R, N, dist_a, out);
  return cudaGetLastError();
}
