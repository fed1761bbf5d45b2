// K8a: real-time octree re-pointing (construct_tree).
//
// Replaces: svox_t_tpu/ops/query.py `construct_tree` (a batched descent
// followed by `data_flat.at[leaf].set(point_id)`).
//
// Each point descends from the root (the steps of svox::descend,
// common.cuh) and writes its id into its leaf's slot of the index table.
// When several points share a leaf, JAX's scatter leaves the winner
// unspecified; this kernel picks one deterministically: atomicMax, so the
// largest point id wins. It runs as two launches on the caller's stream:
//   1. scatter: winner[leaf] = max(point ids landing in that leaf);
//   2. merge: out[cell] = winner[cell] if a point landed there, else the
//      old data[cell].
//
// Bound on an H100: latency of the dependent child-table loads (depth
// levels per point), then one atomic per point; the merge is a streaming
// pass over the index table (9.5 MB at depth 9), bandwidth bound. The
// Hopper design (tools/construct_tree_ab.py times each lever against an
// earlier commit's kernel, PERF.md §6):
//  * kPoints: a scatter thread descends that many points (a block's
//    points kThreads apart, so loads stay coalesced), their levels
//    interleaved: each level issues every live point's child load before
//    it reads any, so a thread keeps several independent chains in flight;
//  * the merge moves 4 cells a thread in 16-byte loads and stores (where
//    the three tables lie on 16 bytes, else 4 scalars);
//  * the winner scratch is owned by the caller and kept all -1 between calls
//    (ops/query.py keeps one per device and stream): the merge resets the
//    cells it took, so no pass clears the scratch first (the earlier kernel's
//    cudaMemsetAsync of it cost 0.0038 ms and a launch a call).
//
// svox_construct_tree_aabb is the same two launches with K8b's
// points_leaf_aabb folded in (replaces svox_t_tpu/ops/query.py
// `points_leaf_aabb` after `construct_tree` on the same points, as every
// re-point that keeps the bake's box calls them): the scatter's box
// instance (scatter_box_kernel) also carries each point's integer cell and
// cube, forms its leaf's box bit for bit as csrc/query.cu's
// points_aabb_kernel does, and folds the block's box into a (6,) scratch
// kept at (+inf, -inf) between calls, like the winner (one a device and
// stream); the merge's box instance joins it with the caller's union (read
// on the card), writes the (6,) result and resets the scratch. So a re-point
// descends its points once, and no launch sets the box up. The box costs the
// scatter a block reduction and, in a block whose box improves on the
// scratch's value when it reads it, one float atomic a coordinate: of the
// 2,744 blocks' 16,464 at 1.4M points, 182 in a random order and 1,774 in
// leaf order (one atomic a warp on the six addresses cost
// points_aabb_kernel 0.34 ms). The box-free instances compile to the same
// PTX as before (scatter_points and merge_cells are inlined into both).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 2;

// The block's box (lo, up: each thread's own) folded into box (6,): the
// warp's by shuffles, the block's by its warp 0 through shared memory, and
// then one thread a coordinate that improves on box's value (read first:
// the value only falls for lo and rises for hi, so one that does not
// improve on any value read can be skipped) folds it with a float atomic.
// Most blocks' boxes lie inside the box so far, so few of the blocks take
// an atomic (one a warp on six addresses cost 0.34 ms, PERF.md).
__device__ __forceinline__ void fold_box(float (&lo)[3], float (&up)[3], float* __restrict__ box) {
  __shared__ float part[kThreads / 32][6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      up[a] = fmaxf(up[a], __shfl_xor_sync(0xffffffffu, up[a], off));
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      part[warp][a] = lo[a];
      part[warp][3 + a] = up[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = part[0][a];
    for (int w = 1; w < kThreads / 32; ++w) {
      v = a < 3 ? fminf(v, part[w][a]) : fmaxf(v, part[w][a]);
    }
    const float now = __ldcg(box + a);
    if (a < 3) {
      if (v < now) svox::atomic_min_float(box + a, v);
    } else if (v > now) {
      svox::atomic_max_float(box + a, v);
    }
  }
}

// The scatter of kP points a thread (see the header): each point's descent,
// then an atomicMax of its id into its leaf's winner. kBox also carries each
// point's integer cell and cube, as svox::descend_cell (c = c * N + u a
// level; the cube starts at N and grows by N on a level that is not a leaf,
// so a leaf at level l has N^(l + 1) and a point that finds none within
// n_levels the full cell and N^(n_levels + 1)), forms its leaf's box as
// points_leaf_aabb does (c / cube - 1e-6, (c + 1) / cube + 1e-6), and folds
// the block's box into ``box`` (fold_box).
template <int P, bool kBox>
__device__ __forceinline__ void scatter_points(const float* __restrict__ points, int Q,
                                               const int32_t* __restrict__ child, int N,
                                               int n_levels, const float* __restrict__ offset,
                                               const float* __restrict__ scaling,
                                               int32_t* __restrict__ winner, float* __restrict__ box) {
  const int base = blockIdx.x * (kThreads * P) + threadIdx.x;
  const float Nf = static_cast<float>(N);
  const float hi = static_cast<float>(N - 1);
  float x[P], y[P], z[P];
  int32_t node[P], leaf[P];
  bool live[P];
  int32_t cx[P], cy[P], cz[P];
  float cube[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k * kThreads;
    live[k] = i < Q;
    node[k] = 0;
    leaf[k] = 0;
    x[k] = y[k] = z[k] = 0.f;
    if constexpr (kBox) {
      cx[k] = cy[k] = cz[k] = 0;
      cube[k] = Nf;
    }
    if (live[k]) {
      // world2tree: offset + scaling * pos, then clamped as descend clamps.
      x[k] = svox::clamp_coord(offset[0] + scaling[0] * points[3 * i + 0]);
      y[k] = svox::clamp_coord(offset[1] + scaling[1] * points[3 * i + 1]);
      z[k] = svox::clamp_coord(offset[2] + scaling[2] * points[3 * i + 2]);
    }
  }
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    int32_t flat[P], skip[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (live[k]) {
        const int u = svox::level_step(x[k], Nf, hi);
        const int v = svox::level_step(y[k], Nf, hi);
        const int w = svox::level_step(z[k], Nf, hi);
        if constexpr (kBox) {
          cx[k] = cx[k] * N + u;
          cy[k] = cy[k] * N + v;
          cz[k] = cz[k] * N + w;
        }
        flat[k] = ((node[k] * N + u) * N + v) * N + w;
        skip[k] = __ldg(child + flat[k]);
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (live[k]) {
        if (skip[k] == 0) {
          leaf[k] = flat[k];
          live[k] = false;
        } else {
          node[k] += skip[k];
          if constexpr (kBox) cube[k] *= Nf;
        }
      }
      any = any || live[k];
    }
    if (!any) break;
  }
  // A point that finds no leaf within n_levels keeps flat 0, as descend.
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k * kThreads;
    if (i < Q) atomicMax(winner + leaf[k], i);
  }
  if constexpr (kBox) {
    const float inf = __int_as_float(0x7f800000);
    float lo[3] = {inf, inf, inf}, up[3] = {-inf, -inf, -inf};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (base + k * kThreads < Q) {
        const int32_t c[3] = {cx[k], cy[k], cz[k]};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], static_cast<float>(c[a]) / cube[k] - 1e-6f);
          up[a] = fmaxf(up[a], static_cast<float>(c[a] + 1) / cube[k] + 1e-6f);
        }
      }
    }
    fold_box(lo, up, box);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const float* __restrict__ points, int Q, const int32_t* __restrict__ child, int N,
    int n_levels, const float* __restrict__ offset, const float* __restrict__ scaling,
    int32_t* __restrict__ winner) {
  scatter_points<P, false>(points, Q, child, N, n_levels, offset, scaling, winner, nullptr);
}

template <int P>
__global__ void __launch_bounds__(kThreads) scatter_box_kernel(
    const float* __restrict__ points, int Q, const int32_t* __restrict__ child, int N,
    int n_levels, const float* __restrict__ offset, const float* __restrict__ scaling,
    int32_t* __restrict__ winner, float* __restrict__ box) {
  scatter_points<P, true>(points, Q, child, N, n_levels, offset, scaling, winner, box);
}

// Cells 4 j .. 4 j + 3: a point's id where one landed, else the old entry;
// the taken cells of the winner reset to -1. `vec`: the tables lie on 16
// bytes.
__device__ __forceinline__ void merge_cells(const int32_t* __restrict__ data,
                                            int32_t* __restrict__ winner,
                                            int32_t* __restrict__ out, int n_cells, bool vec) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = 4 * j;
  if (c >= n_cells) return;
  if (vec && c + 3 < n_cells) {
    const int4 w = reinterpret_cast<const int4*>(winner)[j];
    const int4 d = __ldg(reinterpret_cast<const int4*>(data) + j);
    reinterpret_cast<int4*>(out)[j] = make_int4(w.x >= 0 ? w.x : d.x, w.y >= 0 ? w.y : d.y,
                                                w.z >= 0 ? w.z : d.z, w.w >= 0 ? w.w : d.w);
    // Every entry is -1 or an id: their AND is -1 only where none was taken.
    if ((w.x & w.y & w.z & w.w) != -1) {
      reinterpret_cast<int4*>(winner)[j] = make_int4(-1, -1, -1, -1);
    }
    return;
  }
  const int end = min(c + 4, n_cells);
  for (int e = c; e < end; ++e) {
    const int32_t w = winner[e];
    out[e] = w >= 0 ? w : __ldg(data + e);
    if (w >= 0) winner[e] = -1;
  }
}

__global__ void __launch_bounds__(kThreads) merge_kernel(const int32_t* __restrict__ data,
                                                         int32_t* __restrict__ winner,
                                                         int32_t* __restrict__ out, int n_cells,
                                                         bool vec) {
  merge_cells(data, winner, out, n_cells, vec);
}

// merge_kernel, and on block 0's first six threads the box: lohi[a] = the
// scatter's box[a] joined with the union's (min for lo, max for hi; none
// without a union), box[a] reset to +inf (lo) or -inf (hi).
__global__ void __launch_bounds__(kThreads) merge_box_kernel(
    const int32_t* __restrict__ data, int32_t* __restrict__ winner, int32_t* __restrict__ out,
    int n_cells, bool vec, float* __restrict__ box, const float* __restrict__ union_lo,
    const float* __restrict__ union_hi, float* __restrict__ lohi) {
  if (blockIdx.x == 0 && threadIdx.x < 6) {
    const int a = threadIdx.x;
    const float inf = __int_as_float(0x7f800000);
    float v = box[a];
    if (a < 3) {
      if (union_lo != nullptr) v = fminf(v, union_lo[a]);
      box[a] = inf;
    } else {
      if (union_hi != nullptr) v = fmaxf(v, union_hi[a - 3]);
      box[a] = -inf;
    }
    lohi[a] = v;
  }
  merge_cells(data, winner, out, n_cells, vec);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* svox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// points (Q, 3) f32 world space; child/data (n_cells,) i32; offset and
// scaling (3,) f32; winner (>= n_cells,) i32 scratch, all -1 on entry and
// left so; out (n_cells,) i32. All pointers are device pointers. Returns a
// cudaError_t.
extern "C" int svox_construct_tree(const float* points, int Q,
                                   const int32_t* child, const int32_t* data,
                                   int n_cells, int N, int n_levels,
                                   const float* offset, const float* scaling,
                                   int32_t* winner, int32_t* out, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q > 0) {
    constexpr int per_block = kThreads * kPoints;
    scatter_kernel<kPoints><<<(Q + per_block - 1) / per_block, kThreads, 0, stream>>>(
        points, Q, child, N, n_levels, offset, scaling, winner);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_cells > 0) {
    const int groups = (n_cells + 3) / 4;
    const bool vec = aligned16(data) && aligned16(winner) && aligned16(out);
    merge_kernel<<<(groups + kThreads - 1) / kThreads, kThreads, 0, stream>>>(data, winner, out,
                                                                             n_cells, vec);
    err = cudaGetLastError();
  }
  return err;
}

// svox_construct_tree and points_leaf_aabb in one descent (K8a with K8b's
// box): the table as svox_construct_tree writes it, and lohi (6,) f32 (lo,
// hi) = the points' leaf box joined with the union (union_lo, union_hi (3,)
// f32 each, or both null for none). box (6,) f32 scratch, (+inf x 3, -inf x
// 3) on entry and left so (the merge takes it and resets it), like winner.
// All pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_construct_tree_aabb(const float* points, int Q, const int32_t* child,
                                        const int32_t* data, int n_cells, int N, int n_levels,
                                        const float* offset, const float* scaling,
                                        int32_t* winner, int32_t* out, float* box,
                                        const float* union_lo, const float* union_hi,
                                        float* lohi, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((union_lo == nullptr) != (union_hi == nullptr)) return cudaErrorInvalidValue;
  if (Q > 0) {
    constexpr int per_block = kThreads * kPoints;
    scatter_box_kernel<kPoints><<<(Q + per_block - 1) / per_block, kThreads, 0, stream>>>(
        points, Q, child, N, n_levels, offset, scaling, winner, box);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // At least one block: block 0 takes the box.
  const int groups = (n_cells + 3) / 4;
  const int blocks = groups > 0 ? (groups + kThreads - 1) / kThreads : 1;
  const bool vec = aligned16(data) && aligned16(winner) && aligned16(out);
  merge_box_kernel<<<blocks, kThreads, 0, stream>>>(data, winner, out, n_cells, vec, box, union_lo,
                                                    union_hi, lohi);
  return cudaGetLastError();
}
