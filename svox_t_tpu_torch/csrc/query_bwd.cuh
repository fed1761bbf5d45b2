// K8b's query backward, shared by csrc/query.cu (float32 value gradients)
// and csrc/query_bf16.cu (bf16 ones, K5): the value gradients of the
// points added into their rows of the float32 (M, D) gradient.
//
// Replaces: svox_t_tpu/ops/query.py `_query_bwd` (a scatter-add of the
// value gradients into the pool's rows; empty space adds nothing).
//
// Bound on an H100: the gradient's bytes. The earlier kernel took one
// (point, column) element a thread with a scalar atomicAdd into a zeroed
// buffer, 28 atomics an SH9 row. Here a warp takes 32 points: a lane loads
// its point's row id, then the warp walks its 32 points' gradient rows, one
// contiguous span, in units of kW values (lane l takes units l, l + 32,
// ...), each unit one vector load (a bf16 unit widened to float32 exactly)
// and one vector atomicAdd (float4, float2 on sm_90) into the row that the
// unit's point reads (its id from its lane by a shuffle); a point outside
// the pool adds nothing. The wrapper zeroes the gradient first. The L2's
// atomic units take about as long for a float4 as for a scalar, so the walk
// gains 7% on phase 6's 1.4M points (one a row) and ties the earlier kernel
// at the density prior's 65,536, where the zero fill of the (M, D) gradient
// is most of the call (tools/query_bwd_ab.py, NVIDIA H100 80GB HBM3, 700 W).
// A row-owner design that writes every row once in place of the fill won
// 1.54x where the points are as many as the rows and lost 13% at the prior;
// no main path launches the backward at the first density, so it is kept
// with the designs that lost in tools/query_bwd_designs.cuh.
//
// kW is the widest of 4, 2, 1 whose unit divides the row and the value
// gradients' address, and whose kW floats divide the float32 gradient's;
// the wrapper picks it (ops/query.py `query_bwd_unit`) and counts the
// launches by unit. kD is a template constant for the SH9 and RGBA rows
// (D = 28, 4), else 0: D at run time. A row's sum is float atomics in
// another order than the plain version's index_add_: within the
// atomic-sum tolerance of it.

#pragma once

#include "common.cuh"

namespace {

constexpr int kQueryBwdThreads = 256;

template <class T>
struct QueryBwdArgs {
  const int32_t* data_idx;  // (Q,) row of each point
  const T* grad_values;     // (Q, D) value gradients
  int Q;
  int M;
  int D;
  float* grad;  // (M, D) out, zeroed by the caller
};

template <class T, int kW>
struct BwdUnit;

template <>
struct BwdUnit<float, 4> {
  using V = float4;
  __device__ static float4 get(const float* p, int u) {
    return __ldg(reinterpret_cast<const float4*>(p) + u);
  }
};
template <>
struct BwdUnit<float, 2> {
  using V = float2;
  __device__ static float2 get(const float* p, int u) {
    return __ldg(reinterpret_cast<const float2*>(p) + u);
  }
};
template <>
struct BwdUnit<float, 1> {
  using V = float;
  __device__ static float get(const float* p, int u) { return __ldg(p + u); }
};
template <>
struct BwdUnit<uint16_t, 4> {
  using V = float4;
  __device__ static float4 get(const uint16_t* p, int u) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + u);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};
template <>
struct BwdUnit<uint16_t, 2> {
  using V = float2;
  __device__ static float2 get(const uint16_t* p, int u) {
    const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(p) + u);
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
};
template <>
struct BwdUnit<uint16_t, 1> {
  using V = float;
  __device__ static float get(const uint16_t* p, int u) { return svox::ld(p + u); }
};

__device__ __forceinline__ void add_unit(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}
__device__ __forceinline__ void add_unit(float* dst, float2 v) {
  atomicAdd(reinterpret_cast<float2*>(dst), v);
}
__device__ __forceinline__ void add_unit(float* dst, float v) { atomicAdd(dst, v); }

// A warp's points base + lane; every lane of the warp reaches the shuffles.
template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_kernel(const QueryBwdArgs<T> a) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kQueryBwdThreads + threadIdx.x) & ~31;
  if (base >= a.Q) return;  // the whole warp
  const int nr = min(32, a.Q - base);
  int32_t idx = lane < nr ? __ldg(a.data_idx + base + lane) : -1;
  if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(a.M)) idx = -1;
  const int d = kD > 0 ? kD : a.D;
  const int upr = d / kW;
  const int n = nr * upr;
  const T* src = a.grad_values + static_cast<size_t>(base) * d;
  const int steps = kD > 0 ? kD / kW : (n + 31) / 32;
#pragma unroll
  for (int j = 0; j < steps; ++j) {
    const int u = lane + 32 * j;
    const int r = u / upr;
    const int32_t row = __shfl_sync(0xffffffffu, idx, r & 31);
    if (u < n && row >= 0) {
      add_unit(a.grad + static_cast<size_t>(row) * d + (u - r * upr) * kW,
               BwdUnit<T, kW>::get(src, u));
    }
  }
}

template <class T, int kW, int kD>
cudaError_t launch_query_bwd_walk(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  if (a.Q > 0) {
    const auto blocks = static_cast<unsigned>((static_cast<int64_t>(a.Q) + kQueryBwdThreads - 1) /
                                              kQueryBwdThreads);
    query_bwd_kernel<T, kW, kD><<<blocks, kQueryBwdThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// The instance of kW values a unit: the row constants where the row takes
// the unit, else the generic instance.
template <class T, int kW>
cudaError_t launch_query_bwd_unit(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  if constexpr (28 % kW == 0) {
    if (a.D == 28) return launch_query_bwd_walk<T, kW, 28>(a, stream);
  }
  if constexpr (4 % kW == 0) {
    if (a.D == 4) return launch_query_bwd_walk<T, kW, 4>(a, stream);
  }
  return launch_query_bwd_walk<T, kW, 0>(a, stream);
}

// The launch of a unit of `unit` bytes of grad_values (kW = unit /
// sizeof(T) values, 4, 2 or 1), which must divide the row and the
// gradients' address, its kW floats the float32 gradient's (the wrapper's
// rule; else cudaErrorInvalidValue), adding into the zeroed grad.
template <class T>
cudaError_t launch_query_bwd(const QueryBwdArgs<T>& a, int unit, cudaStream_t stream) {
  const int w = unit / static_cast<int>(sizeof(T));
  if (unit <= 0 || unit % static_cast<int>(sizeof(T)) != 0 || a.D <= 0 || a.D % w != 0 ||
      reinterpret_cast<uintptr_t>(a.grad_values) % unit != 0 ||
      reinterpret_cast<uintptr_t>(a.grad) % (4 * w) != 0) {
    return cudaErrorInvalidValue;
  }
  if (a.M <= 0) return cudaSuccess;
  switch (w) {
    case 4: return launch_query_bwd_unit<T, 4>(a, stream);
    case 2: return launch_query_bwd_unit<T, 2>(a, stream);
    case 1: return launch_query_bwd_unit<T, 1>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
