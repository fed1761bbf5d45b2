// Designs of K8b's query forward that lost to the shipped one, kept for
// tools/query_ab.py: it includes this file into its copy of
// svox_t_tpu_torch/csrc/query_fwd.cuh, before `launch_query_fwd`, whose
// body it replaces by a call of the design's launcher (`launch_p2` for the
// design ``p2``, `launch_bulk` for ``bulk``). The shipped kernel is a lane a
// point: svox::descend, the ids, then the warp's copy (`copy_rows`).

#pragma once

// ---------------------------------------------------------------------
// p2: two points a lane, their descents from the root interleaved level by
// level (each level issues both points' child loads before it reads
// either), as K8a's scatter does; then the warp copies its 64 rows. The
// leaf of each is svox::descend's (flat 0 where none is found within
// n_levels).

template <class T>
__device__ __forceinline__ void descend_two(const QueryArgs<T>& a, const int* i, const bool* live, int32_t* leaf) {
  const float Nf = static_cast<float>(a.N);
  const float hi = static_cast<float>(a.N - 1);
  float x[2], y[2], z[2];
  int32_t node[2];
  bool on[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    node[k] = 0;
    leaf[k] = 0;
    on[k] = live[k];
    x[k] = y[k] = z[k] = 0.f;
    if (live[k]) {
      x[k] = a.points[3 * i[k] + 0];
      y[k] = a.points[3 * i[k] + 1];
      z[k] = a.points[3 * i[k] + 2];
      if (a.world) {  // world2tree: offset + scaling * pos
        x[k] = a.offset[0] + a.scaling[0] * x[k];
        y[k] = a.offset[1] + a.scaling[1] * y[k];
        z[k] = a.offset[2] + a.scaling[2] * z[k];
      }
      x[k] = svox::clamp_coord(x[k]);
      y[k] = svox::clamp_coord(y[k]);
      z[k] = svox::clamp_coord(z[k]);
    }
  }
  for (int lvl = 0; lvl < a.n_levels; ++lvl) {
    int32_t flat[2], skip[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (on[k]) {
        const int u = svox::level_step(x[k], Nf, hi);
        const int v = svox::level_step(y[k], Nf, hi);
        const int w = svox::level_step(z[k], Nf, hi);
        flat[k] = ((node[k] * a.N + u) * a.N + v) * a.N + w;
        skip[k] = __ldg(a.child + flat[k]);
      }
    }
    bool any = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (on[k]) {
        if (skip[k] == 0) {
          leaf[k] = flat[k];
          on[k] = false;
        } else {
          node[k] += skip[k];
        }
      }
      any = any || on[k];
    }
    if (!any) break;
  }
}

// The warp's 64 rows from row `base` on (nr of them below Q); idx[k] is the
// row id of the lane's point k (row base + 32 k + lane).
template <class T, class U, int kD>
__device__ __forceinline__ void copy_rows_two(const QueryArgs<T>& a, const int32_t* idx, int base, int nr) {
  const int lane = threadIdx.x & 31;
  U* out = reinterpret_cast<U*>(a.values + static_cast<size_t>(base) * a.D);
  if constexpr (kD > 0) {
    constexpr int kUpr = kD * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
    U buf[2 * kUpr];
#pragma unroll
    for (int j = 0; j < 2 * kUpr; ++j) {
      const int u = lane + 32 * j;
      const int r = u / kUpr;
      const int32_t r0 = __shfl_sync(0xffffffffu, idx[0], r & 31);
      const int32_t r1 = __shfl_sync(0xffffffffu, idx[1], r & 31);
      const int32_t row = (r >> 5) ? r1 : r0;
      buf[j] = U{};
      if (r < nr && static_cast<uint32_t>(row) < static_cast<uint32_t>(a.M)) {
        buf[j] = __ldg(reinterpret_cast<const U*>(a.features + static_cast<size_t>(row) * kD) + (u - r * kUpr));
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kUpr; ++j) {
      const int u = lane + 32 * j;
      if (u / kUpr < nr) out[u] = buf[j];
    }
  } else {
    const int upr = a.D * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
    for (int j = 0; j < 2 * upr; ++j) {
      const int u = lane + 32 * j;
      const int r = u / upr;
      const int32_t r0 = __shfl_sync(0xffffffffu, idx[0], r & 31);
      const int32_t r1 = __shfl_sync(0xffffffffu, idx[1], r & 31);
      const int32_t row = (r >> 5) ? r1 : r0;
      if (r >= nr) continue;
      U v{};
      if (static_cast<uint32_t>(row) < static_cast<uint32_t>(a.M)) {
        v = __ldg(reinterpret_cast<const U*>(a.features + static_cast<size_t>(row) * a.D) + (u - r * upr));
      }
      out[u] = v;
    }
  }
}

template <class T, class U, int kD>
__global__ void __launch_bounds__(kQueryThreads) query_fwd_p2_kernel(const QueryArgs<T> a) {
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * kQueryThreads + threadIdx.x) >> 5) * 64;
  if (base >= a.Q) return;  // the whole warp
  int i[2];
  bool live[2];
  int32_t leaf[2], idx[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    i[k] = base + 32 * k + lane;
    live[k] = i[k] < a.Q;
  }
  descend_two(a, i, live, leaf);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    idx[k] = -1;
    if (live[k]) {
      idx[k] = __ldg(a.data + leaf[k]);
      a.node_flat[i[k]] = leaf[k];
      a.data_idx[i[k]] = idx[k];
    }
  }
  copy_rows_two<T, U, kD>(a, idx, base, min(64, a.Q - base));
}

template <class T, class U, int kD>
cudaError_t launch_p2(const QueryArgs<T>& a, cudaStream_t stream) {
  const int64_t warps = (static_cast<int64_t>(a.Q) + 63) / 64;
  const int64_t blocks = (warps * 32 + kQueryThreads - 1) / kQueryThreads;
  query_fwd_p2_kernel<T, U, kD><<<static_cast<unsigned>(blocks), kQueryThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bulk: Hopper's bulk asynchronous copies (1-D TMA). A block's threads
// descend their points and write their ids as the shipped kernel does;
// then each thread whose point has a row asks the copy engine for it (one
// `cp.async.bulk` of the whole row from global to shared memory, its bytes
// counted on one `mbarrier`), the threads of empty points write zeros into
// their rows in shared memory, the block waits on the barrier, and one
// thread stores the block's contiguous span of `values` with one bulk store.
// A bulk copy moves 16-byte multiples from 16-byte aligned addresses: the
// float32 SH9 and RGBA rows (112 and 16 bytes) at a 16-byte unit; any other
// row (a bf16 SH9 row is 56 bytes) takes the shipped warp copy.

template <class T, class U, int kD>
__global__ void __launch_bounds__(kQueryThreads) query_fwd_bulk_kernel(const QueryArgs<T> a) {
  constexpr int kRow = kD * static_cast<int>(sizeof(T));
  if constexpr (kD == 0 || kRow % 16 != 0 || sizeof(U) != 16) {
    query_fwd_body<T, U, kD>(a);
  } else {
    __shared__ __align__(128) unsigned char stage[kQueryThreads * kRow];
    __shared__ __align__(8) unsigned long long bar;
    const int tid = threadIdx.x;
    const int base = blockIdx.x * kQueryThreads;
    if (base >= a.Q) return;  // the whole block
    const int i = base + tid;
    const bool live = i < a.Q;
    int32_t idx = -1;
    if (live) {
      float x = a.points[3 * i + 0], y = a.points[3 * i + 1], z = a.points[3 * i + 2];
      if (a.world) {
        x = a.offset[0] + a.scaling[0] * x;
        y = a.offset[1] + a.scaling[1] * y;
        z = a.offset[2] + a.scaling[2] * z;
      }
      const svox::Leaf leaf = svox::descend(a.child, a.N, a.n_levels, x, y, z);
      idx = __ldg(a.data + leaf.flat);
      a.node_flat[i] = leaf.flat;
      a.data_idx[i] = idx;
    }
    const bool has_row = live && static_cast<uint32_t>(idx) < static_cast<uint32_t>(a.M);
    const uint32_t bar_s = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
    const uint32_t row_s = static_cast<uint32_t>(__cvta_generic_to_shared(stage + tid * kRow));
    if (tid == 0) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s) : "memory");
    const int rows = __syncthreads_count(has_row);  // also orders the barrier's init before its use
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_s),
                   "r"(rows * kRow) : "memory");
    }
    if (has_row) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(row_s),
          "l"(reinterpret_cast<uint64_t>(a.features + static_cast<size_t>(idx) * kD)), "r"(kRow), "r"(bar_s)
          : "memory");
    } else if (live) {
      uint4* z = reinterpret_cast<uint4*>(stage + tid * kRow);
#pragma unroll
      for (int e = 0; e < kRow / 16; ++e) z[e] = make_uint4(0, 0, 0, 0);
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar_s)
          : "memory");
    }
    // The zeros written by the threads, seen by the copy engine's store.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      const int n = min(kQueryThreads, a.Q - base);
      const uint32_t stage_s = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
      const uint64_t out = reinterpret_cast<uint64_t>(a.values + static_cast<size_t>(base) * kD);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(out), "r"(stage_s),
                   "r"(n * kRow)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

template <class T, class U, int kD>
cudaError_t launch_bulk(const QueryArgs<T>& a, cudaStream_t stream) {
  const int64_t blocks = (static_cast<int64_t>(a.Q) + kQueryThreads - 1) / kQueryThreads;
  query_fwd_bulk_kernel<T, U, kD><<<static_cast<unsigned>(blocks), kQueryThreads, 0, stream>>>(a);
  return cudaGetLastError();
}
