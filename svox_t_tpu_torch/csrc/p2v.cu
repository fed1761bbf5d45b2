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
// and does ~12 operations per window voxel and an exp and an add per voxel
// within the radius; the backward reads the gradient at those voxels. The
// forward's cost is its adds: about 27 a point at the deep configuration,
// each a float atomic in L2 onto lines that the neighbouring lanes' windows
// share, and its walk: 188 window voxels a point, 27 within the radius. So
// a point walks its window cut per axis to the indices within the radius
// of it (`window_span`) and skips the rows that hold no voxel within, and a
// block of kThreads consecutive points reduces their spans to one voxel box. If
// the box holds at most kTileFloats voxels, the block zeroes a tile of it
// in shared memory, splats its points there with shared adds, and adds each
// non-zero tile voxel into the grid once. A block whose box is larger (a
// cloud in a random order, points far apart) splats each voxel into the
// grid directly, in the same launch. The backward is one thread per point
// with the window in registers: it sums in window order and reads the
// gradient through L1, and the points of a warp are neighbours in the
// cloud's row order, so their windows overlap in L2.
//
// Arithmetic follows the plain PyTorch versions (ops/p2v.py) operation for
// operation, and the library is built with -fmad=false; each forward term
// is expf(-r2 / 2k^2) * dens as there, and only the order of the sums
// differs.

#include <climits>

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

constexpr unsigned kFull = 0xffffffffu;
// Voxels a forward block's shared tile holds (16 KB).
constexpr int kTileFloats = 4096;

// The forward's walk of q's window: the indices lo + o, o < W, kept where
// lo + o <= hi, i.e. [lo, min(hi, lo + W - 1)] an axis, cut per axis to the
// indices whose offset d has d * d <= cr^2 (the others hold no voxel within
// the radius, since r2 >= d * d). Returns false if an axis keeps none.
__device__ __forceinline__ bool window_span(const P2VParams& a, const Window& w, int first[3],
                                            int last[3]) {
  bool any = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int top = min(w.hi[i], w.lo[i] + a.W - 1);
    first[i] = top + 1;
    last[i] = top;
    for (int k = w.lo[i]; k <= top; ++k) {
      const float d = w.p[i] - (static_cast<float>(k) * a.vs[i] + a.corner[i]);
      if (d * d <= a.cr2) {
        first[i] = min(first[i], k);
        last[i] = k;
      }
    }
    any = any && first[i] <= last[i];
  }
  return any;
}

// Calls f(ix, iy, iz, r2) for every voxel of the span within the radius, in
// (x, y, z) order, with d and r2 = (dx^2 + dy^2) + dz^2 formed as the
// plain version forms them; an (x, y) row whose dx^2 + dy^2 already exceeds
// cr^2 is skipped.
template <typename Fn>
__device__ __forceinline__ void walk_span(const P2VParams& a, const Window& w, const int first[3],
                                          const int last[3], Fn&& f) {
  for (int ix = first[0]; ix <= last[0]; ++ix) {
    const float dx = w.p[0] - (static_cast<float>(ix) * a.vs[0] + a.corner[0]);
    const float dx2 = dx * dx;
    for (int iy = first[1]; iy <= last[1]; ++iy) {
      const float dy = w.p[1] - (static_cast<float>(iy) * a.vs[1] + a.corner[1]);
      const float s = dx2 + dy * dy;
      if (s > a.cr2) continue;
      for (int iz = first[2]; iz <= last[2]; ++iz) {
        const float dz = w.p[2] - (static_cast<float>(iz) * a.vs[2] + a.corner[2]);
        const float r2 = s + dz * dz;
        if (r2 <= a.cr2) f(ix, iy, iz, r2);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
voxelize_fwd_kernel(const P2VParams a, float* __restrict__ vol, int* __restrict__ tiled) {
  __shared__ float tile[kTileFloats];
  __shared__ int part[kThreads / 32][6];
  // Thread t takes the block's point (t % 32) * 8 + t / 32: a warp's lanes
  // hold points 8 rows apart, so that neighbours in the cloud's order (whose
  // windows start at one voxel) add into the tile from different warps, not
  // from one warp's lanes into one address at once.
  const int q =
      blockIdx.x * kThreads + (threadIdx.x & 31) * (kThreads / 32) + (threadIdx.x >> 5);
  Window w;
  float dens = 0.f;
  int first[3], last[3];
  // The span's corners as six minima (first, -last); INT_MAX if none.
  int ext[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  bool live = q < a.Q;
  if (live) {
    dens = __ldg(a.features + static_cast<size_t>(q) * a.F + (a.F - 1));
    w = window(a, q);
    live = window_span(a, w, first, last);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ext[i] = first[i];
      ext[3 + i] = -last[i];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) ext[k] = __reduce_min_sync(kFull, ext[k]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) part[threadIdx.x / 32][k] = ext[k];
  }
  __syncthreads();
  int box[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    box[k] = part[0][k];
#pragma unroll
    for (int v = 1; v < kThreads / 32; ++v) box[k] = min(box[k], part[v][k]);
  }
  // A block none of whose points keeps a voxel has an empty box.
  const bool none = box[0] == INT_MAX;
  const int bx = none ? 0 : -box[3] - box[0] + 1, by = none ? 0 : -box[4] - box[1] + 1;
  const int bz = none ? 0 : -box[5] - box[2] + 1;
  if (static_cast<int64_t>(bx) * by * bz > kTileFloats) {
    if (live) {
      walk_span(a, w, first, last, [&](int ix, int iy, int iz, float r2) {
        atomicAdd(vol + (static_cast<size_t>(ix) * a.n + iy) * a.n + iz, expf((-r2) / a.c2k) * dens);
      });
    }
    return;
  }
  const int n_box = bx * by * bz;
  for (int e = threadIdx.x; e < n_box; e += kThreads) tile[e] = 0.f;
  __syncthreads();
  if (live) {
    walk_span(a, w, first, last, [&](int ix, int iy, int iz, float r2) {
      atomicAdd(tile + ((ix - box[0]) * by + (iy - box[1])) * bz + (iz - box[2]),
                expf((-r2) / a.c2k) * dens);
    });
  }
  __syncthreads();
  const int plane = by * bz;
  for (int e = threadIdx.x; e < n_box; e += kThreads) {
    const float v = tile[e];
    if (v != 0.f) {
      const int ix = box[0] + e / plane, r = e - (e / plane) * plane;
      const int iy = box[1] + r / bz, iz = box[2] + (r - (r / bz) * bz);
      atomicAdd(vol + (static_cast<size_t>(ix) * a.n + iy) * a.n + iz, v);
    }
  }
  if (tiled != nullptr && threadIdx.x == 0) atomicAdd(tiled, 1);
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

cudaError_t voxelize_fwd(const float* points, const float* features, int Q, int F,
                         const float* corner, const float* vs, int n, int W, float cr, float cr2,
                         float c2k, float* vol, int* tiled, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bad_sizes(Q, F, n, W)) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  const P2VParams a = params(points, features, Q, F, corner, vs, n, W, cr, cr2, c2k);
  voxelize_fwd_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol, tiled);
  return cudaGetLastError();
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
  return voxelize_fwd(points, features, Q, F, corner, vs, n, W, cr, cr2, c2k, vol, nullptr, device,
                      stream);
}

// As svox_voxelize_fwd, and adds to *tiled (a device int) the number of
// blocks whose box fit the shared tile (the rest splat into the grid).
extern "C" int svox_voxelize_fwd_tiles(const float* points, const float* features, int Q, int F,
                                       const float* corner, const float* vs, int n, int W,
                                       float cr, float cr2, float c2k, float* vol, int* tiled,
                                       int device, cudaStream_t stream) {
  return voxelize_fwd(points, features, Q, F, corner, vs, n, W, cr, cr2, c2k, vol, tiled, device,
                      stream);
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
