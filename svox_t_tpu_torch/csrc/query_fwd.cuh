// K8b's query forward, shared by csrc/query.cu (a float32 pool) and
// csrc/query_bf16.cu (a bf16 pool, K5): each lane descends its point and
// writes its ids, then the warp copies its rows.
//
// Replaces: svox_t_tpu/ops/query.py `query` / `_query_impl` (a batched
// descent, then a row gather with zeros for empty space).
//
// Bound on an H100: the descent's dependent child-table loads, then the
// copy of the rows. The earlier kernel copied a row a thread, value by
// value with D a run-time size: neighbouring lanes stored D values apart,
// so each of a thread's D store instructions touched 32 sectors for 128
// useful bytes, and its loads were scalar too. Here the warp's rows are
// one contiguous span of `values` (32 rows), which the warp fills in
// units of U bytes: lane l takes units l, l + 32, ..., so each store
// instruction writes 32 neighbouring units, and each unit is one load from
// its row (the row id from its lane by a shuffle). U is the widest of 16,
// 8, 4 (and 2 for bf16) bytes that divides the row and the pool's and the
// output's alignment; the wrapper picks it (ops/query.py `query_unit`) and
// counts the launches by unit. Empty space (a row id >= M) is written as
// zeros in the same units. kD is a template constant for the SH9 and RGBA
// rows (D = 28, 4), else 0: the generic instance with D at run time.
// tools/query_ab.py times the designs against an earlier checkout's kernel;
// the two that lost (two points a lane, Hopper's bulk copies) are in
// tools/query_designs.cuh.

#pragma once

#include "common.cuh"

namespace {

constexpr int kQueryThreads = 256;

template <class T>
struct QueryArgs {
  const float* points;
  int Q;
  int world;
  const int32_t* child;
  const int32_t* data;
  int N;
  int n_levels;
  const float* offset;
  const float* scaling;
  const T* features;
  int M;
  int D;
  T* values;
  int32_t* node_flat;
  int32_t* data_idx;
};

// The warp's 32 rows, from row `base` of `values` on (nr of them lie
// below Q), in units of U: each lane loads its units, then stores them.
// idx is the row id of the lane's point (row base + lane).
template <class T, class U, int kD>
__device__ __forceinline__ void copy_rows(const QueryArgs<T>& a, int32_t idx, int base, int nr) {
  const int lane = threadIdx.x & 31;
  U* out = reinterpret_cast<U*>(a.values + static_cast<size_t>(base) * a.D);
  if constexpr (kD > 0) {
    constexpr int kUpr = kD * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
    static_assert(kUpr * sizeof(U) == kD * sizeof(T), "the unit divides the row");
    U buf[kUpr];
#pragma unroll
    for (int j = 0; j < kUpr; ++j) {
      const int u = lane + 32 * j;
      const int r = u / kUpr;
      const int32_t row = __shfl_sync(0xffffffffu, idx, r);
      buf[j] = U{};
      if (r < nr && static_cast<uint32_t>(row) < static_cast<uint32_t>(a.M)) {
        buf[j] = __ldg(reinterpret_cast<const U*>(a.features + static_cast<size_t>(row) * kD) + (u - r * kUpr));
      }
    }
#pragma unroll
    for (int j = 0; j < kUpr; ++j) {
      const int u = lane + 32 * j;
      if (u / kUpr < nr) out[u] = buf[j];
    }
  } else {
    const int upr = a.D * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
    for (int j = 0; j < upr; ++j) {
      const int u = lane + 32 * j;
      const int r = u / upr;
      const int32_t row = __shfl_sync(0xffffffffu, idx, r);
      if (r >= nr) continue;
      U v{};
      if (static_cast<uint32_t>(row) < static_cast<uint32_t>(a.M)) {
        v = __ldg(reinterpret_cast<const U*>(a.features + static_cast<size_t>(row) * a.D) + (u - r * upr));
      }
      out[u] = v;
    }
  }
}

// A warp's points base + lane: descents (svox::descend), ids, then rows.
// Every lane of the warp reaches the shuffles: a lane past Q has no point.
template <class T, class U, int kD>
__device__ __forceinline__ void query_fwd_body(const QueryArgs<T>& a) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kQueryThreads + threadIdx.x) & ~31;
  if (base >= a.Q) return;  // the whole warp
  const int i = base + lane;
  int32_t idx = -1;
  if (i < a.Q) {
    float x = a.points[3 * i + 0], y = a.points[3 * i + 1], z = a.points[3 * i + 2];
    if (a.world) {  // world2tree: offset + scaling * pos
      x = a.offset[0] + a.scaling[0] * x;
      y = a.offset[1] + a.scaling[1] * y;
      z = a.offset[2] + a.scaling[2] * z;
    }
    const svox::Leaf leaf = svox::descend(a.child, a.N, a.n_levels, x, y, z);
    idx = __ldg(a.data + leaf.flat);
    a.node_flat[i] = leaf.flat;
    a.data_idx[i] = idx;
  }
  copy_rows<T, U, kD>(a, idx, base, min(32, a.Q - base));
}

template <class T, class U, int kD>
__global__ void __launch_bounds__(kQueryThreads) query_fwd_kernel(const QueryArgs<T> a) {
  query_fwd_body<T, U, kD>(a);
}

template <class T, class U, int kD>
cudaError_t launch_query_fwd(const QueryArgs<T>& a, cudaStream_t stream) {
  const int64_t blocks = (static_cast<int64_t>(a.Q) + kQueryThreads - 1) / kQueryThreads;
  query_fwd_kernel<T, U, kD><<<static_cast<unsigned>(blocks), kQueryThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The instance of a unit U: the row constants where the row takes the
// unit, else the generic instance.
template <class T, class U>
cudaError_t launch_query_unit(const QueryArgs<T>& a, cudaStream_t stream) {
  if constexpr ((28 * sizeof(T)) % sizeof(U) == 0) {
    if (a.D == 28) return launch_query_fwd<T, U, 28>(a, stream);
  }
  if constexpr ((4 * sizeof(T)) % sizeof(U) == 0) {
    if (a.D == 4) return launch_query_fwd<T, U, 4>(a, stream);
  }
  return launch_query_fwd<T, U, 0>(a, stream);
}

// The launch of a unit of `unit` bytes, which must divide the row and the
// alignment of the pool and of the output (the wrapper's rule; else
// cudaErrorInvalidValue); 2-byte units only for 2-byte values.
template <class T>
cudaError_t launch_query(const QueryArgs<T>& a, int unit, cudaStream_t stream) {
  const size_t row = static_cast<size_t>(a.D) * sizeof(T);
  if (unit < static_cast<int>(sizeof(T)) || row % unit != 0 ||
      reinterpret_cast<uintptr_t>(a.features) % unit != 0 ||
      reinterpret_cast<uintptr_t>(a.values) % unit != 0) {
    return cudaErrorInvalidValue;
  }
  switch (unit) {
    case 16: return launch_query_unit<T, uint4>(a, stream);
    case 8: return launch_query_unit<T, uint2>(a, stream);
    case 4: return launch_query_unit<T, unsigned int>(a, stream);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_query_unit<T, unsigned short>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
