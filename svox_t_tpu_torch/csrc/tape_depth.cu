// K13f: first-hit depth by tape replay (svox_tape_depth).
//
// Replaces: svox_t_tpu/ops/tape.py `_replay_depth_impl` (with
// `_resolve_cells` on a data-indirect tape). The TPU version scanned the
// count-sorted chunks K samples at a time under a while loop per chunk,
// with a cumulative sum picking each lane's first hit; here one thread
// walks one ray's run of the flat tape (tape_record.cuh), samples
// offsets[i] to offsets[i + 1], and stops at its first hit.
//
// Per ray i: the first sample k whose row (the recorded row, or on a
// data-indirect tape table[cell], -1 for a cell outside the table) lies in
// [0, M) and whose sigma (the row's last column, read in the pool's type
// through svox::ld and widened to float32, as the JAX package's .astype)
// exceeds sigma_thresh gives depth tval[k] * dscale[i]; a ray with no such
// sample gives 0. That is `render_depth` (K9b) on the recorded rays: the
// recorded t-chain is the march's, and a compacted tape drops only samples
// whose row lies outside [0, M), which are never selected.
//
// Bound on an H100: bytes, and the latency of the dependent loads. A ray
// reads its two offsets and dscale, the idx stream up to its hit (not
// coalesced: a neighbouring thread's run lies elsewhere), on an indirect
// tape one table entry per sample, one sigma value per resident sample
// (a 4- or 2-byte load from a row of the pool) and one tval at the hit,
// and writes 4 bytes. There is no descent and no radiometry. The design
// answer is a thread per ray with a few registers, so that many warps are
// resident to hide the chain of loads; the pool's type and the indirect
// resolve are template parameters, so no sample pays a test for either.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <class P, bool kIndirect>
__global__ void __launch_bounds__(kThreads) depth_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ idx,
    const float* __restrict__ tval, const float* __restrict__ dscale, int B,
    const int32_t* __restrict__ table, int n_table, P features, int M, int D,
    float sigma_thresh, float* __restrict__ depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float out = 0.f;
  const int32_t end = offsets[i + 1];
  for (int32_t k = offsets[i]; k < end; ++k) {
    int32_t row = __ldg(idx + k);
    if constexpr (kIndirect) {
      row = static_cast<uint32_t>(row) < static_cast<uint32_t>(n_table) ? __ldg(table + row) : -1;
    }
    if (static_cast<uint32_t>(row) < static_cast<uint32_t>(M) &&
        svox::ld(features + (static_cast<size_t>(row) * D + (D - 1))) > sigma_thresh) {
      out = __ldg(tval + k) * dscale[i];
      break;
    }
  }
  depth[i] = out;
}

template <class P>
cudaError_t launch(const int32_t* offsets, const int32_t* idx, const float* tval,
                   const float* dscale, int B, const int32_t* table, int n_table,
                   const void* features, int M, int D, float sigma_thresh, float* depth,
                   cudaStream_t stream) {
  const P pool = svox::make_pool<P>(features, nullptr, nullptr);
  const int grid = (B + kThreads - 1) / kThreads;
  if (table != nullptr) {
    depth_kernel<P, true><<<grid, kThreads, 0, stream>>>(offsets, idx, tval, dscale, B, table,
                                                         n_table, pool, M, D, sigma_thresh, depth);
  } else {
    depth_kernel<P, false><<<grid, kThreads, 0, stream>>>(offsets, idx, tval, dscale, B, table,
                                                          n_table, pool, M, D, sigma_thresh, depth);
  }
  return cudaGetLastError();
}

}  // namespace

// K13f. The tape: offsets (B + 1,) int32, idx (offsets[B],) int32 rows (or
// tree cells with a table), tval (offsets[B],) f32 each sample's march
// parameter t, dscale (B,) f32; table (n_table,) int32 the flat index table
// of a data-indirect tape, else null; features (M, D) float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), of which only the last column is read; depth (B,)
// f32. All pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_tape_depth(const int32_t* offsets, const int32_t* idx, const float* tval,
                               const float* dscale, int B, const int32_t* table, int n_table,
                               const void* features, int bf16, int M, int D, float sigma_thresh,
                               float* depth, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (M > 0 && D <= 0) return cudaErrorInvalidValue;
  if (bf16) {
    return launch<svox::PoolBF16>(offsets, idx, tval, dscale, B, table, n_table, features, M, D,
                                  sigma_thresh, depth, stream);
  }
  return launch<svox::PoolF32>(offsets, idx, tval, dscale, B, table, n_table, features, M, D,
                               sigma_thresh, depth, stream);
}
