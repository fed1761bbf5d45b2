// K11: point-to-voxel (p2v) Gaussian density splatting, forward and
// backward.
//
// Replaces: svox_t_tpu/ops/p2v.py `voxelize` (per point a static (W, W, W)
// window of voxels and one scatter-add over the flat grid) and its XLA
// autodiff, which the JAX package uses as the backward.
//
// Each point q with density dens_q (the last feature column) walks exactly
// the JAX package's window: per axis
//   lo = clip(floor(((p - cr) - corner) / vs), 0, n - 1),
//   hi = clip(ceil(((p + cr) - corner) / vs), 0, n - 1),
// the indices lo + o for o < W kept where lo + o <= hi. A voxel's centre is
// idx * vs + corner; with d = p - centre and r2 = (dx^2 + dy^2) + dz^2 it
// counts where r2 <= cr^2, with weight w = exp(-r2 / (2 k^2)).
//   Forward: vol[(ix * n + iy) * n + iz] += w * dens_q (float atomicAdd).
//   Backward: with g = dvol at the voxel,
//     ddens_q += g * w and dp_q += -2 * (u * d), u = ((g * dens_q) * w) / (2 k^2),
//   summed in window order by the point's own thread: no atomics, so it is
//   deterministic. The feature gradient lands in the last column (the JAX
//   package's fix; the CUDA reference wrote column 0).
// The host passes W, vs, cr, cr^2 and 2 k^2 as the JAX package forms them:
// the last three in double, rounded once to float32.
//
// Bound on an H100: the forward writes the n^3 grid (67.9 MB at n = 257)
// and does ~12 operations per window voxel and an exp and an atomic per
// voxel within the radius; the backward reads the gradient at those
// voxels. The atomics of neighbouring points fall on neighbouring voxels,
// so they mostly hit L2. The design answer is one thread per point with
// the window in registers and no staging: the points of a warp are
// neighbours in the cloud's row order, so their windows overlap in L2.
//
// Arithmetic follows the plain PyTorch versions (ops/p2v.py) operation for
// operation, and the library is built with -fmad=false; only the order of
// the forward's atomics differs.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct P2VParams {
  const float* points;    // (Q, 3)
  const float* features;  // (Q, F); column F - 1 is the density
  int Q;
  int F;
  float corner[3];
  float vs[3];
  int n;
  int W;
  float cr;
  float cr2;
  float c2k;  // 2 k^2
};

struct Window {
  int lo[3], hi[3];
  float p[3];
};

__device__ __forceinline__ Window window(const P2VParams& a, int q) {
  Window w;
  const float top = static_cast<float>(a.n - 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p = __ldg(a.points + 3 * static_cast<size_t>(q) + i);
    w.p[i] = p;
    const float rlo = ((p - a.cr) - a.corner[i]) / a.vs[i];
    const float rhi = ((p + a.cr) - a.corner[i]) / a.vs[i];
    w.lo[i] = static_cast<int>(fminf(fmaxf(floorf(rlo), 0.f), top));
    w.hi[i] = static_cast<int>(fminf(fmaxf(ceilf(rhi), 0.f), top));
  }
  return w;
}

// Calls f(flat voxel index, d, r2) for every voxel of q's window within
// the radius, in (x, y, z) window order.
template <typename Fn>
__device__ __forceinline__ void walk(const P2VParams& a, const Window& w, Fn&& f) {
  for (int ox = 0; ox < a.W; ++ox) {
    const int ix = w.lo[0] + ox;
    if (ix > w.hi[0]) break;
    const float dx = w.p[0] - (static_cast<float>(ix) * a.vs[0] + a.corner[0]);
    for (int oy = 0; oy < a.W; ++oy) {
      const int iy = w.lo[1] + oy;
      if (iy > w.hi[1]) break;
      const float dy = w.p[1] - (static_cast<float>(iy) * a.vs[1] + a.corner[1]);
      for (int oz = 0; oz < a.W; ++oz) {
        const int iz = w.lo[2] + oz;
        if (iz > w.hi[2]) break;
        const float dz = w.p[2] - (static_cast<float>(iz) * a.vs[2] + a.corner[2]);
        const float r2 = (dx * dx + dy * dy) + dz * dz;
        if (r2 <= a.cr2) {
          f((static_cast<size_t>(ix) * a.n + iy) * a.n + iz, dx, dy, dz, r2);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
voxelize_fwd_kernel(const P2VParams a, float* __restrict__ vol) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.Q) return;
  const float dens = __ldg(a.features + static_cast<size_t>(q) * a.F + (a.F - 1));
  const Window w = window(a, q);
  walk(a, w, [&](size_t cell, float, float, float, float r2) {
    atomicAdd(vol + cell, expf((-r2) / a.c2k) * dens);
  });
}

__global__ void __launch_bounds__(kThreads)
voxelize_bwd_kernel(const P2VParams a, const float* __restrict__ grad_vol,
                    float* __restrict__ d_points, float* __restrict__ d_features) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.Q) return;
  const float dens = __ldg(a.features + static_cast<size_t>(q) * a.F + (a.F - 1));
  const Window w = window(a, q);
  float gd = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  walk(a, w, [&](size_t cell, float dx, float dy, float dz, float r2) {
    const float wt = expf((-r2) / a.c2k);
    const float g = __ldg(grad_vol + cell);
    gd = gd + g * wt;
    const float u = ((g * dens) * wt) / a.c2k;
    gx = gx + -2.f * (u * dx);
    gy = gy + -2.f * (u * dy);
    gz = gz + -2.f * (u * dz);
  });
  if (d_points) {
    d_points[3 * static_cast<size_t>(q)] = gx;
    d_points[3 * static_cast<size_t>(q) + 1] = gy;
    d_points[3 * static_cast<size_t>(q) + 2] = gz;
  }
  if (d_features) d_features[static_cast<size_t>(q) * a.F + (a.F - 1)] = gd;
}

P2VParams params(const float* points, const float* features, int Q, int F,
                 const float* corner, const float* vs, int n, int W, float cr,
                 float cr2, float c2k) {
  return P2VParams{points, features, Q, F,
                   {corner[0], corner[1], corner[2]}, {vs[0], vs[1], vs[2]},
                   n, W, cr, cr2, c2k};
}

bool bad_sizes(int Q, int F, int n, int W) {
  return Q < 0 || F < 1 || n < 2 || W < 1 ||
         static_cast<int64_t>(n) * n * n >= (int64_t{1} << 31);
}

}  // namespace

// points (Q, 3) f32; features (Q, F) f32 (only column F - 1 is read);
// corner and vs: 3 host floats each; n voxels per axis; W window width;
// cr, cr2 = cr^2 and c2k = 2 k^2 as float32; vol (n^3,) f32, zeroed by the
// caller. Device pointers but for corner and vs. Returns a cudaError_t.
extern "C" int svox_voxelize_fwd(const float* points, const float* features, int Q, int F,
                                 const float* corner, const float* vs, int n, int W,
                                 float cr, float cr2, float c2k, float* vol, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_sizes(Q, F, n, W)) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  const P2VParams a = params(points, features, Q, F, corner, vs, n, W, cr, cr2, c2k);
  voxelize_fwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol);
  return cudaGetLastError();
}

// As svox_voxelize_fwd's inputs, plus grad_vol (n^3,) f32 and the outputs
// d_points (Q, 3) and d_features (Q, F), each null when not wanted;
// d_features is zeroed by the caller and only its column F - 1 is
// written. Returns a cudaError_t.
extern "C" int svox_voxelize_bwd(const float* points, const float* features, int Q, int F,
                                 const float* corner, const float* vs, int n, int W,
                                 float cr, float cr2, float c2k, const float* grad_vol,
                                 float* d_points, float* d_features, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_sizes(Q, F, n, W)) return cudaErrorInvalidValue;
  if (Q == 0 || !(d_points || d_features)) return cudaSuccess;
  const P2VParams a = params(points, features, Q, F, corner, vs, n, W, cr, cr2, c2k);
  voxelize_bwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a, grad_vol, d_points, d_features);
  return cudaGetLastError();
}
