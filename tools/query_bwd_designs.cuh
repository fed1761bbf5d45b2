// Designs of K8b's query backward (`svox_t_tpu_torch/csrc/query_bwd.cuh`)
// that did not ship; `tools/query_bwd_ab.py` includes this file before the
// shipped launcher and launches a design in place of the shipped kernel,
// with the shipped units (`BwdUnit`, `add_unit`).
//
//  * launch_dense: the row-owner design. Each point claims its row in a
//    row-owner table (`design_owner`: (M,) int32 kept all -1 between
//    calls), every row of the gradient is written once, in order, by the
//    warp that holds it (its owner's value gradients, or zeros: no zero
//    fill), and the points that do not own their rows add theirs with
//    vector atomics (each owner resets its entry to -1). It beats the
//    shipped walk and its fill where the points are as many as the rows
//    and loses where they are few (the density prior), and no main path
//    launches the backward at the first density;
//  * launch_lane: a lane adds its own point's whole row into a gradient
//    the caller zeroes (a warp's atomics then fall on 32 rows at once, its
//    loads a row apart);
//  * launch_points: the dense design's claims and adds, with the owners
//    storing their own rows into a gradient the caller zeroes, in place of
//    the rows kernel's pass over every row;
//  * launch_rows4: the dense design with kRowGroups = 4 groups of 32 rows a
//    warp in the rows kernel, the groups' owners loaded before any store;
//  * launch_flat: the dense design with the rows kernel a grid-stride loop
//    over the gradient's units in order, as a fill writes.

// The row-owner table of the dense designs: (>= M,) int32, all -1 between
// calls (the claims set it, the adds reset it), grown to the largest pool
// seen; one a process (the tool runs one stream).
inline int32_t* design_owner(int M) {
  static int32_t* owner = nullptr;
  static int size = 0;
  if (M > size) {
    if (owner != nullptr) cudaFree(owner);
    owner = nullptr;
    size = 0;
    if (cudaMalloc(&owner, static_cast<size_t>(M) * sizeof(int32_t)) != cudaSuccess) return nullptr;
    if (cudaMemset(owner, 0xff, static_cast<size_t>(M) * sizeof(int32_t)) != cudaSuccess) return nullptr;
    size = M;
  }
  return owner;
}

inline unsigned design_blocks(int64_t n) {
  return static_cast<unsigned>((n + kQueryBwdThreads - 1) / kQueryBwdThreads);
}

__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_claim_kernel(
    const int32_t* __restrict__ data_idx, int Q, int M, int32_t* __restrict__ owner) {
  const int i = blockIdx.x * kQueryBwdThreads + threadIdx.x;
  if (i >= Q) return;
  const int32_t row = __ldg(data_idx + i);
  if (static_cast<uint32_t>(row) < static_cast<uint32_t>(M)) atomicMax(owner + row, i);
}

// A warp's rows base + lane of the gradient; every lane reaches the shuffles.
template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_rows_kernel(const QueryBwdArgs<T> a,
                                                                          const int32_t* owner) {
  using V = typename BwdUnit<T, kW>::V;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kQueryBwdThreads + threadIdx.x) & ~31;
  if (base >= a.M) return;  // the whole warp
  const int nr = min(32, a.M - base);
  const int32_t own = lane < nr ? owner[base + lane] : -1;
  const int d = kD > 0 ? kD : a.D;
  const int upr = d / kW;
  const int n = nr * upr;
  V* out = reinterpret_cast<V*>(a.grad + static_cast<size_t>(base) * d);
  const int steps = kD > 0 ? kD / kW : (n + 31) / 32;
#pragma unroll
  for (int j = 0; j < steps; ++j) {
    const int u = lane + 32 * j;
    const int r = u / upr;
    const int32_t src = __shfl_sync(0xffffffffu, own, r & 31);
    if (u < n) {
      V v{};
      if (src >= 0) {
        v = BwdUnit<T, kW>::get(a.grad_values + static_cast<size_t>(src) * d, u - r * upr);
      }
      out[u] = v;
    }
  }
}

// The shipped walk, adding only the points that do not own their rows (an
// owner's row is already written; the owner resets its entry to -1).
template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_owned_kernel(const QueryBwdArgs<T> a,
                                                                           int32_t* owner) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kQueryBwdThreads + threadIdx.x) & ~31;
  if (base >= a.Q) return;  // the whole warp
  const int nr = min(32, a.Q - base);
  int32_t idx = lane < nr ? __ldg(a.data_idx + base + lane) : -1;
  if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(a.M)) {
    idx = -1;
  } else if (owner[idx] == base + lane) {
    owner[idx] = -1;
    idx = -1;
  }
  if (__ballot_sync(0xffffffffu, idx >= 0) == 0) return;
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
      add_unit(a.grad + static_cast<size_t>(row) * d + (u - r * upr) * kW, BwdUnit<T, kW>::get(src, u));
    }
  }
}

template <class T, int kW, int kD>
cudaError_t launch_dense(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  int32_t* owner = design_owner(a.M);
  if (owner == nullptr) return cudaErrorMemoryAllocation;
  if (a.Q > 0) {
    query_bwd_claim_kernel<<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a.data_idx, a.Q, a.M, owner);
  }
  query_bwd_rows_kernel<T, kW, kD><<<design_blocks(a.M), kQueryBwdThreads, 0, stream>>>(a, owner);
  if (a.Q > 0) {
    query_bwd_owned_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a, owner);
  }
  return cudaGetLastError();
}

template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_lane_kernel(const QueryBwdArgs<T> a) {
  const int i = blockIdx.x * kQueryBwdThreads + threadIdx.x;
  if (i >= a.Q) return;
  const int32_t row = __ldg(a.data_idx + i);
  if (static_cast<uint32_t>(row) >= static_cast<uint32_t>(a.M)) return;
  const int d = kD > 0 ? kD : a.D;
  const T* src = a.grad_values + static_cast<size_t>(i) * d;
  float* dst = a.grad + static_cast<size_t>(row) * d;
#pragma unroll
  for (int u = 0; u < (kD > 0 ? kD / kW : d / kW); ++u) add_unit(dst + u * kW, BwdUnit<T, kW>::get(src, u));
}

template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_store_kernel(const QueryBwdArgs<T> a,
                                                                           const int32_t* owner) {
  using V = typename BwdUnit<T, kW>::V;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kQueryBwdThreads + threadIdx.x) & ~31;
  if (base >= a.Q) return;  // the whole warp
  const int nr = min(32, a.Q - base);
  int32_t idx = lane < nr ? __ldg(a.data_idx + base + lane) : -1;
  if (static_cast<uint32_t>(idx) >= static_cast<uint32_t>(a.M) || owner[idx] != base + lane) idx = -1;
  if (__ballot_sync(0xffffffffu, idx >= 0) == 0) return;
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
      *reinterpret_cast<V*>(a.grad + static_cast<size_t>(row) * d + (u - r * upr) * kW) = BwdUnit<T, kW>::get(src, u);
    }
  }
}

constexpr int kRowGroups = 4;

template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_rows4_kernel(const QueryBwdArgs<T> a,
                                                                           const int32_t* owner) {
  using V = typename BwdUnit<T, kW>::V;
  const int lane = threadIdx.x & 31;
  const int64_t first =
      static_cast<int64_t>((blockIdx.x * kQueryBwdThreads + threadIdx.x) >> 5) * 32 * kRowGroups;
  if (first >= a.M) return;  // the whole warp
  int32_t own[kRowGroups];
#pragma unroll
  for (int g = 0; g < kRowGroups; ++g) {
    const int64_t r = first + 32 * g + lane;
    own[g] = r < a.M ? owner[r] : -1;
  }
  const int d = kD > 0 ? kD : a.D;
  const int upr = d / kW;
#pragma unroll
  for (int g = 0; g < kRowGroups; ++g) {
    const int64_t base = first + 32 * g;
    if (base >= a.M) break;  // the whole warp
    const int n = static_cast<int>(min(static_cast<int64_t>(32), a.M - base)) * upr;
    V* out = reinterpret_cast<V*>(a.grad + base * d);
    const int steps = kD > 0 ? kD / kW : (n + 31) / 32;
#pragma unroll
    for (int j = 0; j < steps; ++j) {
      const int u = lane + 32 * j;
      const int r = u / upr;
      const int32_t src = __shfl_sync(0xffffffffu, own[g], r & 31);
      if (u < n) {
        V v{};
        if (src >= 0) v = BwdUnit<T, kW>::get(a.grad_values + static_cast<size_t>(src) * d, u - r * upr);
        out[u] = v;
      }
    }
  }
}

template <class T, int kW, int kD>
cudaError_t launch_lane(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  if (a.Q > 0) query_bwd_lane_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <class T, int kW, int kD>
cudaError_t launch_points(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  int32_t* owner = design_owner(a.M);
  if (owner == nullptr) return cudaErrorMemoryAllocation;
  if (a.Q > 0) {
    query_bwd_claim_kernel<<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a.data_idx, a.Q, a.M, owner);
    query_bwd_store_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a, owner);
    query_bwd_owned_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a, owner);
  }
  return cudaGetLastError();
}

template <class T, int kW, int kD>
cudaError_t launch_rows4(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  int32_t* owner = design_owner(a.M);
  if (owner == nullptr) return cudaErrorMemoryAllocation;
  if (a.Q > 0) {
    query_bwd_claim_kernel<<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a.data_idx, a.Q, a.M, owner);
  }
  query_bwd_rows4_kernel<T, kW, kD><<<design_blocks((static_cast<int64_t>(a.M) + kRowGroups - 1) / kRowGroups),
                                     kQueryBwdThreads, 0, stream>>>(a, owner);
  if (a.Q > 0) {
    query_bwd_owned_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a, owner);
  }
  return cudaGetLastError();
}

// flat: the dense design with the rows kernel a grid-stride loop over the
// gradient's units in order (lane l of a warp on unit base + l, as a fill
// writes), each unit's owner loaded through the read-only cache.
template <class T, int kW, int kD>
__global__ void __launch_bounds__(kQueryBwdThreads) query_bwd_flat_kernel(const QueryBwdArgs<T> a,
                                                                          const int32_t* owner) {
  using V = typename BwdUnit<T, kW>::V;
  const int d = kD > 0 ? kD : a.D;
  const int upr = d / kW;
  const int64_t n = static_cast<int64_t>(a.M) * upr;
  V* out = reinterpret_cast<V*>(a.grad);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kQueryBwdThreads;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kQueryBwdThreads + threadIdx.x; u < n; u += stride) {
    const int64_t r = u / upr;
    const int32_t src = __ldg(owner + r);
    V v{};
    if (src >= 0) v = BwdUnit<T, kW>::get(a.grad_values + static_cast<size_t>(src) * d, static_cast<int>(u - r * upr));
    out[u] = v;
  }
}

template <class T, int kW, int kD>
cudaError_t launch_flat(const QueryBwdArgs<T>& a, cudaStream_t stream) {
  int32_t* owner = design_owner(a.M);
  if (owner == nullptr) return cudaErrorMemoryAllocation;
  if (a.Q > 0) {
    query_bwd_claim_kernel<<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a.data_idx, a.Q, a.M, owner);
  }
  const int64_t units = static_cast<int64_t>(a.M) * ((kD > 0 ? kD : a.D) / kW);
  const unsigned blocks = static_cast<unsigned>(min(static_cast<int64_t>(132 * 16), (units + kQueryBwdThreads - 1) / kQueryBwdThreads));
  query_bwd_flat_kernel<T, kW, kD><<<blocks, kQueryBwdThreads, 0, stream>>>(a, owner);
  if (a.Q > 0) {
    query_bwd_owned_kernel<T, kW, kD><<<design_blocks(a.Q), kQueryBwdThreads, 0, stream>>>(a, owner);
  }
  return cudaGetLastError();
}
