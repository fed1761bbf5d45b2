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

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 2;

template <int P>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const float* __restrict__ points, int Q, const int32_t* __restrict__ child, int N,
    int n_levels, const float* __restrict__ offset, const float* __restrict__ scaling,
    int32_t* __restrict__ winner) {
  const int base = blockIdx.x * (kThreads * P) + threadIdx.x;
  const float Nf = static_cast<float>(N);
  const float hi = static_cast<float>(N - 1);
  float x[P], y[P], z[P];
  int32_t node[P], leaf[P];
  bool live[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k * kThreads;
    live[k] = i < Q;
    node[k] = 0;
    leaf[k] = 0;
    x[k] = y[k] = z[k] = 0.f;
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
}

// Cells 4 j .. 4 j + 3: a point's id where one landed, else the old entry;
// the taken cells of the winner reset to -1. `vec`: the tables lie on 16
// bytes.
__global__ void __launch_bounds__(kThreads) merge_kernel(const int32_t* __restrict__ data,
                                                         int32_t* __restrict__ winner,
                                                         int32_t* __restrict__ out, int n_cells,
                                                         bool vec) {
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
