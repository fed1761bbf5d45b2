// K10: the linear-blend-skinning (LBS) warp, forward and backward.
//
// Replaces: svox_t_tpu/ops/warp.py `blend_transformation_matrix` and
// `warp_vertices` (a gather of the joints' transforms T[j], an einsum over
// the bones and a second einsum for the transform) and their XLA autodiff,
// which the JAX package uses as the backward.
//
// Forward: one thread per point blends the top three rows of its nb bones'
// transforms, A = sum_b w_b T[j_b][0:3, :] over the bones with w_b > 0 in
// bone order, writes the (4, 4) blend with row 3 = [0, 0, 0, 1] and the
// warped point A[:, :3] x + A[:, 3].
//
// Backward: one thread per point forms G = g_M[0:3, :] + g_x (x, 1)^T
// (either gradient may be absent) and writes
//   dx   = A[:, :3]^T g_x,
//   dw_b = <T[j_b][0:3, :], G> where w_b > 0, else 0,
// and adds w_b G into dT[j_b][0:3, :]; row 3 of dT stays 0.
//
// Joint ids are read as a JAX gather reads them: a negative id wraps once
// (j + J), then it is clamped to [0, J). The dT adds are the transpose of
// that gather as XLA forms it, a scatter that drops updates whose wrapped
// id lies outside [0, J).
//
// Bound on an H100: bytes. A point moves 120 bytes in the forward (x, w
// and j in, the warped point and the blend out) and 148 in the backward;
// T is J x 64 bytes and stays in L1 (__ldg). The backward's other problem
// is contention: every point adds into the same 12 J floats (24 at J = 2).
// Each block therefore sums into a copy of the (J, 12) table in shared
// memory, rows padded to the odd stride 13 so that lanes adding one entry
// into different joints hit different banks, and adds its non-zero entries
// to the global table once, at its end (as K9d does in render_aux.cu).
//
// Arithmetic follows the plain PyTorch versions (ops/warp.py) operation for
// operation, and the library is built with -fmad=false, so the forward and
// dx, dw agree bit for bit; only the order of the dT atomics differs.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Stride of a joint's row in the backward's shared table: 12 entries
// padded to an odd count.
constexpr int kRowStride = 13;
// Largest joint table the backward holds in shared memory (48 KB).
constexpr int kMaxJoints = 48 * 1024 / (kRowStride * 4);

struct WarpParams {
  const float* T;        // (J, 4, 4)
  int J;
  const float* x;        // (Q, 3)
  const float* w;        // (Q, nb)
  const int32_t* ji;     // (Q, nb)
  int Q;
  int nb;
};

// The row of T that joint id j reads: wrapped once, then clamped.
__device__ __forceinline__ int joint_row(int32_t j, int J) {
  if (j < 0) j += J;
  return min(max(j, 0), J - 1);
}

// A = sum_b w_b T[j_b][0:3, :] over bones with w_b > 0, in bone order.
__device__ __forceinline__ void blend(const WarpParams& p, int q, float A[12]) {
#pragma unroll
  for (int e = 0; e < 12; ++e) A[e] = 0.f;
  const size_t base = static_cast<size_t>(q) * p.nb;
  for (int b = 0; b < p.nb; ++b) {
    const float wb = __ldg(p.w + base + b);
    if (wb > 0.f) {
      const float* row = p.T + static_cast<size_t>(joint_row(__ldg(p.ji + base + b), p.J)) * 16;
#pragma unroll
      for (int e = 0; e < 12; ++e) A[e] = A[e] + wb * __ldg(row + e);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const WarpParams p, float* __restrict__ warped, float* __restrict__ mats) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Q) return;
  float A[12];
  blend(p, q, A);
  const float x = __ldg(p.x + 3 * static_cast<size_t>(q));
  const float y = __ldg(p.x + 3 * static_cast<size_t>(q) + 1);
  const float z = __ldg(p.x + 3 * static_cast<size_t>(q) + 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    warped[3 * static_cast<size_t>(q) + i] =
        ((A[4 * i] * x + A[4 * i + 1] * y) + A[4 * i + 2] * z) + A[4 * i + 3];
  }
  float4* m = reinterpret_cast<float4*>(mats + 16 * static_cast<size_t>(q));
  m[0] = make_float4(A[0], A[1], A[2], A[3]);
  m[1] = make_float4(A[4], A[5], A[6], A[7]);
  m[2] = make_float4(A[8], A[9], A[10], A[11]);
  m[3] = make_float4(0.f, 0.f, 0.f, 1.f);
}

struct WarpGrads {
  const float* g_x;  // (Q, 3) or null
  const float* g_M;  // (Q, 4, 4) or null
  float* dT;         // (J, 4, 4), zeroed, or null
  float* dx;         // (Q, 3) or null
  float* dw;         // (Q, nb) or null
};

__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const WarpParams p, const WarpGrads g) {
  extern __shared__ float table[];  // this block's (J, 12) dT rows, kRowStride apart
  if (g.dT) {
    for (int e = threadIdx.x; e < p.J * kRowStride; e += blockDim.x) table[e] = 0.f;
    __syncthreads();
  }
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < p.Q) {
    const size_t q3 = 3 * static_cast<size_t>(q);
    float gx[3] = {0.f, 0.f, 0.f};
    if (g.g_x) {
#pragma unroll
      for (int i = 0; i < 3; ++i) gx[i] = __ldg(g.g_x + q3 + i);
    }
    const float xh[4] = {__ldg(p.x + q3), __ldg(p.x + q3 + 1), __ldg(p.x + q3 + 2), 1.f};
    float G[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float outer = gx[i] * xh[k];
        if (g.g_M) {
          const float gm = __ldg(g.g_M + 16 * static_cast<size_t>(q) + 4 * i + k);
          G[4 * i + k] = g.g_x ? gm + outer : gm;
        } else {
          G[4 * i + k] = outer;
        }
      }
    }
    if (g.dx) {
      float A[12];
      blend(p, q, A);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g.dx[q3 + k] = (A[k] * gx[0] + A[4 + k] * gx[1]) + A[8 + k] * gx[2];
      }
    }
    const size_t base = static_cast<size_t>(q) * p.nb;
    for (int b = 0; b < p.nb; ++b) {
      const float wb = __ldg(p.w + base + b);
      const int32_t jb = __ldg(p.ji + base + b);
      if (g.dw) {
        float s = 0.f;
        if (wb > 0.f) {
          const float* row = p.T + static_cast<size_t>(joint_row(jb, p.J)) * 16;
          s = __ldg(row) * G[0];
#pragma unroll
          for (int e = 1; e < 12; ++e) s = s + __ldg(row + e) * G[e];
        }
        g.dw[base + b] = s;
      }
      const int32_t jw = jb < 0 ? jb + p.J : jb;
      if (g.dT && wb > 0.f && jw >= 0 && jw < p.J) {
        float* dst = table + jw * kRowStride;
#pragma unroll
        for (int e = 0; e < 12; ++e) atomicAdd(dst + e, wb * G[e]);
      }
    }
  }
  if (g.dT) {
    __syncthreads();
    for (int e = threadIdx.x; e < p.J * 12; e += blockDim.x) {
      const int j = e / 12, k = e - 12 * (e / 12);
      const float v = table[j * kRowStride + k];
      if (v != 0.f) atomicAdd(g.dT + 16 * j + k, v);
    }
  }
}

cudaError_t check_sizes(const WarpParams& p) {
  if (p.J < 1 || p.nb < 0 || p.Q < 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// T (J, 4, 4) f32; x (Q, 3) f32; w (Q, nb) f32; ji (Q, nb) i32; warped
// (Q, 3) and mats (Q, 4, 4) f32 out, mats 16-byte aligned. All pointers are
// device pointers. Returns a cudaError_t.
extern "C" int svox_warp_fwd(const float* T, int J, const float* x, const float* w,
                             const int32_t* ji, int Q, int nb, float* warped,
                             float* mats, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const WarpParams p{T, J, x, w, ji, Q, nb};
  if ((err = check_sizes(p)) != cudaSuccess) return err;
  if (Q == 0) return cudaSuccess;
  warp_fwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p, warped, mats);
  return cudaGetLastError();
}

// As svox_warp_fwd's inputs, plus the output gradients g_x (Q, 3) and g_M
// (Q, 4, 4) (either may be null) and the input gradients dT (J, 4, 4,
// zeroed by the caller), dx (Q, 3) and dw (Q, nb), each null when not
// wanted. J <= svox_warp_max_joints() when dT is wanted (the shared
// table). Returns a cudaError_t.
extern "C" int svox_warp_bwd(const float* T, int J, const float* x, const float* w,
                             const int32_t* ji, int Q, int nb, const float* g_x,
                             const float* g_M, float* dT, float* dx, float* dw,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const WarpParams p{T, J, x, w, ji, Q, nb};
  if ((err = check_sizes(p)) != cudaSuccess) return err;
  if (dT && J > kMaxJoints) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  const WarpGrads g{g_x, g_M, dT, dx, dw};
  const size_t smem = dT ? static_cast<size_t>(J) * kRowStride * sizeof(float) : 0;
  warp_bwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, smem, stream>>>(p, g);
  return cudaGetLastError();
}

// The largest joint count svox_warp_bwd takes when dT is wanted.
extern "C" int svox_warp_max_joints() { return kMaxJoints; }
