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
// Backward: each point forms G = g_M[0:3, :] + g_x (x, 1)^T
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
// is its adds: every point adds w_b G into 12 floats of each of its nb
// joints' rows of dT (48 a point at nb 4), and a shared float add is a
// compare-and-swap loop on sm_90 that serializes the lanes of a warp adding
// into one row, which neighbouring points in the cloud's row order do.
// So a warp takes kRun steps of 32 consecutive points (its loads stay
// coalesced; a lane's points are 32 rows apart and mostly share their
// joints), and each thread sums its points' addends in registers: a cache
// of kSlots (joint, 12 sums) entries, matched by joint with unrolled
// compares. A miss flushes the least recently used entry into the block's
// copy of the (J, 12) table in shared memory (rows padded to the odd stride
// 13 so that lanes adding one entry into different joints hit different
// banks), and the run's end flushes every entry, both joint by joint: the
// warp sums a joint's entries by shuffles, and 12 lanes add a column each
// (the lanes of a warp mostly evict one joint at one step). The block adds
// its table's non-zero entries to the global table once, at its end. The
// bones go one at a time (not unrolled), so that the flushes are inlined
// once; the kernel still takes about 200 registers, one block an SM. w and j
// are read as one float4 and one int4 a point at nb 4 (float2 / int2 at nb
// 2), the rows of T and g_M as float4s where they are aligned.
//
// Arithmetic follows the plain PyTorch versions (ops/warp.py) operation for
// operation, and the library is built with -fmad=false, so the forward and
// dx, dw agree bit for bit; each dT term is w_b * G[e] as there, and only
// the order in which the terms are summed differs.

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
  bool vec_T;        // T's rows 16-byte aligned: read as float4s
  bool vec_gM;       // g_M's rows 16-byte aligned: read as float4s
};

constexpr unsigned kFull = 0xffffffffu;
// Points a backward thread takes, 32 rows apart, and sums in registers.
constexpr int kRun = 8;
// Joints the backward's register cache holds.
constexpr int kSlots = 4;

// A thread's register cache of dT sums: slot c sums the terms of joint
// id[c] (-1: empty) and was last used at step used[c].
struct RunCache {
  int id[kSlots];
  int used[kSlots];
  float s[kSlots][12];
};

__device__ __forceinline__ void flush_slot(float* table, int j, const float* s) {
  float* dst = table + j * kRowStride;
#pragma unroll
  for (int e = 0; e < 12; ++e) atomicAdd(dst + e, s[e]);
}

// The warp's sum of 16 values a lane, transposed: in 16 shuffles (8, 4,
// 2, 1 and 1 over the lane bits 16, 8, 4, 2 and 1) each lane ends with the
// warp's sum of the value whose index is returned (lanes 2i and 2i + 1
// hold index bitrev4(i)).
__device__ __forceinline__ int warp_sum16(float v[16], int lane) {
  int index = 0;
#pragma unroll
  for (int o = 16, n = 16; o > 1; o /= 2, n /= 2) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    if (upper) index += n / 2;
  }
  v[0] = v[0] + __shfl_xor_sync(kFull, v[0], 1);
  return index;
}

// The warp's sum of joint j's entries (a lane's entry k where take[k]),
// added to the table by 12 lanes, a column each.
template <int kN>
__device__ __forceinline__ void warp_add(const bool (&take)[kN], const float (&s)[kN][12], int j,
                                         float* table, int lane) {
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = 0.f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (take[k]) {
#pragma unroll
      for (int e = 0; e < 12; ++e) v[e] = s[k][e];
    }
  }
  const int e = warp_sum16(v, lane);
  if ((lane & 1) == 0 && e < 12) atomicAdd(table + j * kRowStride + e, v[0]);
}

// Rounds of a warp flush before the entries left go lane by lane.
constexpr int kFlushRounds = 2 * kSlots;

// Adds every lane's entries (joint id[k] >= 0, sums s[k]), k < kN, to the
// table, joint by joint: first each k whose joint is one in all 32 lanes;
// then rounds in which the first lane with an entry left names its joint
// and the warp sums that joint's entries (a joint that no other lane's
// first entry names goes lane by lane); after kFlushRounds rounds (a warp
// whose lanes hold many joints) each lane adds the entries it has left.
// The 32 lanes call it together.
template <int kN>
__device__ __forceinline__ void warp_flush(const int (&id)[kN], const float (&s)[kN][12],
                                           float* table) {
  const int lane = threadIdx.x & 31;
  bool left[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int j0 = __shfl_sync(kFull, id[k], 0);
    left[k] = id[k] >= 0;
    if (__all_sync(kFull, id[k] == j0)) {
      if (j0 >= 0) {
        bool take[kN];
#pragma unroll
        for (int i = 0; i < kN; ++i) take[i] = i == k;
        warp_add<kN>(take, s, j0, table, lane);
      }
      left[k] = false;
    }
  }
  for (int round = 0; round < kFlushRounds; ++round) {
    int mine = -1;
#pragma unroll
    for (int k = kN - 1; k >= 0; --k) {
      if (left[k]) mine = id[k];
    }
    const unsigned any = __ballot_sync(kFull, mine >= 0);
    if (any == 0u) return;
    const int j = __shfl_sync(kFull, mine, __ffs(any) - 1);
    bool take[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      take[k] = left[k] && id[k] == j;
      left[k] = left[k] && !take[k];
    }
    if (__popc(__ballot_sync(kFull, mine == j)) >= 2) {
      warp_add<kN>(take, s, j, table, lane);
    } else {
      // A joint that no other lane's first entry names: added lane by lane.
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        if (take[k]) flush_slot(table, j, s[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (left[k]) flush_slot(table, id[k], s[k]);
  }
}

// Adds the terms t of joint j at step now where ok: into its slot on a hit,
// else into the least recently used slot, whose sums the warp first adds to
// the table (`warp_flush`: the lanes that evict one joint at one step, as
// neighbouring points crossing into another joint's region do, add it
// once). The 32 lanes call it together.
__device__ __forceinline__ void cache_add(RunCache& c, float* table, bool ok, int j, int now,
                                          const float t[12]) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (ok && c.id[k] == j) {
      hit = true;
      c.used[k] = now;
#pragma unroll
      for (int e = 0; e < 12; ++e) c.s[k][e] = c.s[k][e] + t[e];
    }
  }
  const bool miss = ok && !hit;
  int victim = 0;
#pragma unroll
  for (int k = 1; k < kSlots; ++k) {
    if (c.used[k] < c.used[victim]) victim = k;
  }
  int out[1] = {-1};
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (miss && k == victim) out[0] = c.id[k];
  }
  if (__any_sync(kFull, out[0] >= 0)) {
    float vs[1][12];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k == victim) {
#pragma unroll
        for (int e = 0; e < 12; ++e) vs[0][e] = c.s[k][e];
      }
    }
    warp_flush<1>(out, vs, table);
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (miss && k == victim) {
      c.id[k] = j;
      c.used[k] = now;
#pragma unroll
      for (int e = 0; e < 12; ++e) c.s[k][e] = t[e];
    }
  }
}

// Row r of T (or of g_M): 12 floats, as three float4s where aligned.
__device__ __forceinline__ void load12(const float* row, bool vec, float* out) {
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 v = __ldg(r4 + i);
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 12; ++e) out[e] = __ldg(row + e);
  }
}

// Point q's bones: weights and joint ids, one float4 and one int4 at
// kNB 4, a float2 and an int2 at kNB 2, else p.nb scalars (kNB 0).
template <int kNB>
__device__ __forceinline__ void load_bones(const WarpParams& p, int q, float* w, int32_t* j) {
  if constexpr (kNB == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.w) + q);
    const int4 i = __ldg(reinterpret_cast<const int4*>(p.ji) + q);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    j[0] = i.x; j[1] = i.y; j[2] = i.z; j[3] = i.w;
  } else if constexpr (kNB == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p.w) + q);
    const int2 i = __ldg(reinterpret_cast<const int2*>(p.ji) + q);
    w[0] = v.x; w[1] = v.y;
    j[0] = i.x; j[1] = i.y;
  }
}

// One point's backward: G, dx, dw, and its dT terms into the cache. A
// lane past the last point (live false) forms nothing and writes nothing,
// but takes part in the cache's warp flushes.
template <int kNB>
__device__ __forceinline__ void point_bwd(const WarpParams& p, const WarpGrads& g, int q, bool live,
                                          RunCache& c, float* table, int& now) {
  const size_t q3 = 3 * static_cast<size_t>(q);
  float gx[3] = {0.f, 0.f, 0.f};
  float xh[4] = {0.f, 0.f, 0.f, 1.f};
  float G[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) G[e] = 0.f;
  if (live) {
    if (g.g_x) {
#pragma unroll
      for (int i = 0; i < 3; ++i) gx[i] = __ldg(g.g_x + q3 + i);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) xh[i] = __ldg(p.x + q3 + i);
    if (g.g_M) load12(g.g_M + 16 * static_cast<size_t>(q), g.vec_gM, G);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float outer = gx[i] * xh[k];
      if (g.g_M) {
        if (g.g_x) G[4 * i + k] = G[4 * i + k] + outer;
      } else {
        G[4 * i + k] = outer;
      }
    }
  }
  float A[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) A[e] = 0.f;
  const size_t base = static_cast<size_t>(q) * p.nb;
  auto bone = [&](int b, float wb, int32_t jb) {
    float row[12];
    if (live && wb > 0.f && (g.dx || g.dw)) {
      load12(p.T + static_cast<size_t>(joint_row(jb, p.J)) * 16, g.vec_T, row);
    }
    if (g.dx && wb > 0.f) {
#pragma unroll
      for (int e = 0; e < 12; ++e) A[e] = A[e] + wb * row[e];
    }
    if (live && g.dw) {
      float s = 0.f;
      if (wb > 0.f) {
        s = row[0] * G[0];
#pragma unroll
        for (int e = 1; e < 12; ++e) s = s + row[e] * G[e];
      }
      g.dw[base + b] = s;
    }
    if (g.dT) {
      const int32_t jw = jb < 0 ? jb + p.J : jb;
      float t[12];
#pragma unroll
      for (int e = 0; e < 12; ++e) t[e] = wb * G[e];
      cache_add(c, table, live && wb > 0.f && jw >= 0 && jw < p.J, jw, ++now, t);
    }
  };
  // The bones one at a time, not unrolled: the cache's flushes are inlined
  // once, not once a bone.
  if constexpr (kNB > 0) {
    float wv[kNB];
    int32_t jv[kNB];
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      wv[b] = 0.f;
      jv[b] = 0;
    }
    if (live) load_bones<kNB>(p, q, wv, jv);
#pragma unroll 1
    for (int b = 0; b < kNB; ++b) {
      float wb = wv[0];
      int32_t jb = jv[0];
#pragma unroll
      for (int i = 1; i < kNB; ++i) {
        if (b == i) {
          wb = wv[i];
          jb = jv[i];
        }
      }
      bone(b, wb, jb);
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < p.nb; ++b) {
      bone(b, live ? __ldg(p.w + base + b) : 0.f, live ? __ldg(p.ji + base + b) : 0);
    }
  }
  if (live && g.dx) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.dx[q3 + k] = (A[k] * gx[0] + A[4 + k] * gx[1]) + A[8 + k] * gx[2];
    }
  }
}

template <int kNB>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const WarpParams p, const WarpGrads g) {
  extern __shared__ float table[];  // this block's (J, 12) dT rows, kRowStride apart
  if (g.dT) {
    for (int e = threadIdx.x; e < p.J * kRowStride; e += blockDim.x) table[e] = 0.f;
    __syncthreads();
  }
  RunCache c;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    c.id[k] = -1;
    c.used[k] = -1;
  }
  int now = 0;
  // A warp's run: 32 consecutive points a step, kRun steps.
  const int q0 = blockIdx.x * (kThreads * kRun) + (threadIdx.x & ~31) * kRun + (threadIdx.x & 31);
  for (int r = 0; r < kRun; ++r) {
    const int q = q0 + r * 32;
    point_bwd<kNB>(p, g, q, q < p.Q, c, table, now);
  }
  if (g.dT) {
    warp_flush<kSlots>(c.id, c.s, table);
    __syncthreads();
    for (int e = threadIdx.x; e < p.J * 12; e += blockDim.x) {
      const int j = e / 12, k = e - 12 * (e / 12);
      const float v = table[j * kRowStride + k];
      if (v != 0.f) atomicAdd(g.dT + 16 * j + k, v);
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

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
  const WarpGrads g{g_x, g_M, dT, dx, dw, aligned16(T), g_M != nullptr && aligned16(g_M)};
  const size_t smem = dT ? static_cast<size_t>(J) * kRowStride * sizeof(float) : 0;
  const int per_block = kThreads * kRun;
  const int blocks = static_cast<int>((static_cast<int64_t>(Q) + per_block - 1) / per_block);
  // The bones' vector loads need their rows 16 (nb 4) or 8 (nb 2) bytes apart and aligned.
  const bool vec_bones = aligned16(w) && aligned16(ji);
  if (nb == 4 && vec_bones) {
    warp_bwd_kernel<4><<<blocks, kThreads, smem, stream>>>(p, g);
  } else if (nb == 2 && vec_bones) {
    warp_bwd_kernel<2><<<blocks, kThreads, smem, stream>>>(p, g);
  } else {
    warp_bwd_kernel<0><<<blocks, kThreads, smem, stream>>>(p, g);
  }
  return cudaGetLastError();
}

// The largest joint count svox_warp_bwd takes when dT is wanted.
extern "C" int svox_warp_max_joints() { return kMaxJoints; }
