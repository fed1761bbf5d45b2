// K8b (query part) for a bf16 feature pool (K5): the point query's forward
// and backward, as csrc/query.cu computes them for a float32 pool.
//
// Replaces: svox_t_tpu/ops/query.py `query` / `_query_impl` and
// `_query_bwd` on a bf16 pool. The JAX forward gathers bf16 rows, so its
// values are bf16; its backward adds bf16 value gradients into a bf16
// (M, D) buffer. Here the forward copies the row's 2-byte values as they
// are (exact), and the backward adds each value gradient, widened to
// float32 exactly, into a float32 (M, D) buffer with atomicAdd; the
// wrapper casts that sum to bf16 once (ops/query.py). A row that k points
// read thus rounds once where JAX rounds k times.
//
// Bound on an H100: as csrc/query.cu — the descent's latency and the row
// copy forward, the atomics backward — with half the pool and value bytes
// forward and half the gradient bytes read backward. The forward is
// csrc/query_fwd.cuh's warp copy in 2-byte values: an SH9 row is 56 bytes,
// so its widest unit is 8 bytes (16 divides no such row). The backward is
// csrc/query_bwd.cuh's warp walk, 8-byte units of an SH9 row (4 values)
// widened to float32 and added with float4 atomics.

#include "query_bwd.cuh"
#include "query_fwd.cuh"

// As svox_query_fwd, with features (M, D) bf16 and values (Q, D) bf16 out;
// unit 16, 8, 4 or 2 bytes, dividing the row (D * 2 bytes) and the
// alignment of features and values. Returns a cudaError_t.
extern "C" int svox_query_fwd_bf16(const float* points, int Q, int world,
                                   const int32_t* child, const int32_t* data, int N,
                                   int n_levels, const float* offset, const float* scaling,
                                   const void* features, int M, int D, void* values,
                                   int32_t* node_flat, int32_t* data_idx, int unit, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Q <= 0) return cudaSuccess;
  const QueryArgs<uint16_t> a{points, Q, world, child, data, N, n_levels, offset, scaling,
                              static_cast<const uint16_t*>(features), M, D,
                              static_cast<uint16_t*>(values), node_flat, data_idx};
  return launch_query(a, unit, stream);
}

// As svox_query_bwd, with grad_values (Q, D) bf16; unit 8, 4 or 2 bytes
// of grad_values (4, 2 or 1 values). Returns a cudaError_t.
extern "C" int svox_query_bwd_bf16(const int32_t* data_idx, const void* grad_values, int Q,
                                   int M, int D, float* grad, int unit, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const QueryBwdArgs<uint16_t> a{data_idx, static_cast<const uint16_t*>(grad_values), Q, M, D,
                                 grad};
  return launch_query_bwd(a, unit, stream);
}
