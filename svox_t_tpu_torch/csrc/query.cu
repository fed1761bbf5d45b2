// K8b (query part): the differentiable point query, forward and backward.
//
// Replaces: svox_t_tpu/ops/query.py `query` / `_query_impl` (a batched
// descent, then a row gather with zeros for empty space) and `_query_bwd`
// (a re-descent, then `zeros((M, D)).at[row].add(g)`).
//
// Forward (csrc/query_fwd.cuh, shared with the bf16 pool's instance): each
// lane descends its point and writes the leaf's packed cell id and its
// data-table entry, then the warp copies its rows into its contiguous span
// of the output in 16-, 8- or 4-byte units, zeros where the entry is not <
// M. Backward (csrc/query_bwd.cuh, shared likewise): a warp walks its 32
// points' gradient rows and adds them into rows data_idx < M of the zeroed
// gradient with vector atomicAdd; duplicate points in one leaf sum.
//
// Bound on an H100: the forward by the dependent child-table loads of the
// descent (depth levels per point) and the copy of the rows (see
// query_fwd.cuh); the backward by its atomics into the (M, D) buffer (157
// MB at depth 9 SH9; see query_bwd.cuh).
//
// K8b (points_leaf_aabb): the tree-space box of the leaves that hold a
// point cloud. Replaces: svox_t_tpu/ops/query.py `points_leaf_aabb` (a
// batched descent with the integer cell, then min/max over the batch).
// One thread per point descends (descend_cell) and forms its leaf's
// corners from the descent's own integer cell, cell / cube_sz - 1e-6 and
// (cell + 1) / cube_sz + 1e-6, over a grid-stride loop of a few blocks per
// SM; a block reduces them with shuffles and shared memory, and one thread
// per coordinate folds the block's value into the (6,) box with a float
// atomic through the ordered-int trick (a non-negative float orders as a
// signed int, a negative one in reverse as an unsigned int). min and max
// are exact, so the box equals the plain version's bit for bit. Bound on
// an H100: the descent's latency, as the forward query. A first version
// with one atomic per warp and coordinate spent 0.34 ms on 1.4M points
// serialized on the six addresses (NVIDIA H100 80GB HBM3, 700 W).

#include "query_bwd.cuh"
#include "query_fwd.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void points_aabb_kernel(const float* __restrict__ points, int Q, int world,
                                   const int32_t* __restrict__ child, int N, int n_levels,
                                   const float* __restrict__ offset,
                                   const float* __restrict__ scaling,
                                   float* __restrict__ lohi) {
  __shared__ float part[kThreads / 32][6];
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Q; i += gridDim.x * blockDim.x) {
    float x = points[3 * i + 0], y = points[3 * i + 1], z = points[3 * i + 2];
    if (world) {
      x = offset[0] + scaling[0] * x;
      y = offset[1] + scaling[1] * y;
      z = offset[2] + scaling[2] * z;
    }
    int c[3];
    const svox::Leaf leaf = svox::descend_cell(child, N, n_levels, x, y, z, c[0], c[1], c[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], static_cast<float>(c[a]) / leaf.cube_sz - 1e-6f);
      hi[a] = fmaxf(hi[a], static_cast<float>(c[a] + 1) / leaf.cube_sz + 1e-6f);
    }
  }
  // Warp, then block, then one set of atomics per block.
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      part[warp][a] = lo[a];
      part[warp][3 + a] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = part[0][a];
    for (int w = 1; w < kThreads / 32; ++w) {
      v = a < 3 ? fminf(v, part[w][a]) : fmaxf(v, part[w][a]);
    }
    if (a < 3) {
      if (v < inf) svox::atomic_min_float(lohi + a, v);
    } else if (v > -inf) {
      svox::atomic_max_float(lohi + a, v);
    }
  }
}

}  // namespace

// points (Q, 3) f32 (world space when world != 0, else tree space);
// child/data (capacity * N^3,) i32; offset/scaling (3,) f32; features
// (M, D) f32; values (Q, D) f32, node_flat and data_idx (Q,) i32 out; unit
// the bytes the warp's copy moves at a time (16, 8 or 4), which must divide
// the row (D * 4 bytes) and the alignment of features and values. All
// pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_query_fwd(const float* points, int Q, int world,
                              const int32_t* child, const int32_t* data,
                              int N, int n_levels, const float* offset,
                              const float* scaling, const float* features,
                              int M, int D, float* values, int32_t* node_flat,
                              int32_t* data_idx, int unit, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  const QueryArgs<float> a{points, Q, world, child, data, N, n_levels, offset, scaling,
                           features, M, D, values, node_flat, data_idx};
  return launch_query(a, unit, stream);
}

// data_idx (Q,) i32 from the forward; grad_values (Q, D) f32; grad (M, D)
// f32, zeroed by the caller; unit the bytes of grad_values a lane moves
// at a time (16, 8 or 4), which must divide the row and the addresses of
// grad_values and grad. Returns a cudaError_t.
extern "C" int svox_query_bwd(const int32_t* data_idx, const float* grad_values, int Q, int M,
                              int D, float* grad, int unit, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const QueryBwdArgs<float> a{data_idx, grad_values, Q, M, D, grad};
  return launch_query_bwd(a, unit, stream);
}

// K8b points_leaf_aabb. points (Q, 3) f32 (world space when world, else
// tree space); child (n_cells,) i32; offset/scaling (3,) f32; lohi (6,)
// f32, set by the caller to (+inf x 3, -inf x 3), receives (lo, hi). All
// pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_points_aabb(const float* points, int Q, int world, const int32_t* child,
                                int N, int n_levels, const float* offset,
                                const float* scaling, float* lohi, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  // A grid-stride loop over a few blocks per SM: each block adds its
  // box once, so the six addresses take a few thousand atomics in all.
  const int blocks = min((Q + kThreads - 1) / kThreads, 132 * 8);
  points_aabb_kernel<<<blocks, kThreads, 0, stream>>>(points, Q, world, child, N, n_levels,
                                                       offset, scaling, lohi);
  return cudaGetLastError();
}
