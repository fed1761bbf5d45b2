// Designs of K14a, the minibatch subset gather (csrc/tape_subset.cu
// `gather_kernel`), that lost to the shipped one on an H100 (PERF.md §6,
// tools/subset_gather_ab.py). tools/subset_gather_ab.py includes this file
// after tape_subset.cu's anonymous namespace and launches a design in place
// of the shipped `launch_gather`; it is not part of the library.
//
//  * thread: a thread a ray, which loads its id, run and new offset and
//    copies its run entry by entry (the streams as template parameters).
//    Its stores are a ray's run apart, so a warp's store instruction
//    touches up to 32 lines; it needs no shuffle.
//  * runtime: the shipped warp design (32 rays a warp, a lane an entry of
//    the warp's span) with the optional streams as run-time null tests a
//    sample, one instance for every call.

#pragma once

namespace {

template <bool kT, bool kCell, bool kRays>
__global__ void __launch_bounds__(kGatherThreads) gather_thread_kernel(const GatherArgs a) {
  const int r = blockIdx.x * kGatherThreads + threadIdx.x;
  if (r >= a.B) return;
  const int32_t i = __ldg(a.ids + r);
  const int32_t d0 = __ldg(a.dst_offsets + r);
  const int32_t s0 = __ldg(a.src_offsets + i);
  const int32_t n = __ldg(a.src_offsets + i + 1) - s0;
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
  for (int32_t k = 0; k < n; ++k) {
    a.idx_dst[d0 + k] = __ldg(a.idx_src + s0 + k);
    a.dt_dst[d0 + k] = __ldg(a.dt_src + s0 + k);
    if constexpr (kT) a.t_dst[d0 + k] = __ldg(a.t_src + s0 + k);
    if constexpr (kCell) a.cell_dst[d0 + k] = __ldg(a.cell_src + s0 + k);
  }
}

__global__ void __launch_bounds__(kGatherThreads) gather_runtime_kernel(const GatherArgs a) {
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kGatherWarps + threadIdx.x / 32) * 32;
  if (r0 >= a.B) return;
  const int n_own = min(32, a.B - r0);
  const int r = r0 + lane;
  int32_t i = 0, s0 = 0, n = 0, d0 = 0x7fffffff;
  if (lane < n_own) {
    i = __ldg(a.ids + r);
    d0 = __ldg(a.dst_offsets + r);
    s0 = __ldg(a.src_offsets + i);
    n = __ldg(a.src_offsets + i + 1) - s0;
  }
  const int32_t first = __shfl_sync(kFull, d0, 0);
  const int32_t len = __ldg(a.dst_offsets + r0 + n_own) - first;
  if (lane < n_own) {
    for (int c = 0; c < 3; ++c) {
      a.vdirs_dst[3 * r + c] = __ldg(a.vdirs_src + 3 * i + c);
      if (a.o_dst != nullptr) {
        a.o_dst[3 * r + c] = __ldg(a.o_src + 3 * i + c);
        a.d_dst[3 * r + c] = __ldg(a.d_src + 3 * i + c);
      }
    }
    a.ds_dst[r] = __ldg(a.ds_src + i);
    a.counts_dst[r] = n;
  }
  for (int32_t q = 0; q < len; q += 32) {
    const int32_t p = first + q + lane;
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
      if (a.t_dst != nullptr) a.t_dst[p] = __ldg(a.t_src + src);
      if (a.cell_dst != nullptr) a.cell_dst[p] = __ldg(a.cell_src + src);
    }
  }
}

template <bool kT, bool kCell, bool kRays>
cudaError_t launch_thread_instance(const GatherArgs& a, cudaStream_t stream) {
  gather_thread_kernel<kT, kCell, kRays><<<(a.B + kGatherThreads - 1) / kGatherThreads, kGatherThreads,
                                           0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_thread(const GatherArgs& a, cudaStream_t stream) {
  const bool t = a.t_dst != nullptr, cell = a.cell_dst != nullptr, rays = a.o_dst != nullptr;
  if (t && cell) {
    return rays ? launch_thread_instance<true, true, true>(a, stream)
                : launch_thread_instance<true, true, false>(a, stream);
  }
  if (t) {
    return rays ? launch_thread_instance<true, false, true>(a, stream)
                : launch_thread_instance<true, false, false>(a, stream);
  }
  if (cell) {
    return rays ? launch_thread_instance<false, true, true>(a, stream)
                : launch_thread_instance<false, true, false>(a, stream);
  }
  return rays ? launch_thread_instance<false, false, true>(a, stream)
              : launch_thread_instance<false, false, false>(a, stream);
}

cudaError_t launch_runtime(const GatherArgs& a, cudaStream_t stream) {
  const int warps = (a.B + 31) / 32;
  gather_runtime_kernel<<<(warps + kGatherWarps - 1) / kGatherWarps, kGatherThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
