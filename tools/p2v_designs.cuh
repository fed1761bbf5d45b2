// Designs of K11's forward (csrc/p2v.cu `voxelize_fwd_kernel`) that lost to
// the shipped one on an H100 (PERF.md §6, tools/voxelize_ab.py), and its
// census. tools/voxelize_ab.py includes this file after p2v.cu's anonymous
// namespace and launches a design in place of the shipped kernel; it is not
// part of the library.
//
//  * gather: the shipped block box, but where it fits kTileFloats voxels a
//    thread a tile voxel sums, in the block's point order, the terms of the
//    block's points whose walked windows cover it (each point's position,
//    density and window staged in shared memory): no shared atomics, and
//    each tile voxel's sum is the same from run to run; it then adds a
//    non-zero sum into the grid. A larger box splats as the shipped kernel.
//  * pairs: the shipped kernel, but in a tiled block two threads walk the
//    union of two neighbouring rows' spans, each the x planes of one
//    parity, and add both points' terms of a voxel in one shared add.
//  * no_atomics (a census, not a design): one thread a point walks its
//    span and forms every term, as the shipped kernel does, and adds none
//    (a sum that no run can match keeps the terms alive).

#pragma once

namespace {

__global__ void __launch_bounds__(kThreads)
voxelize_fwd_gather_kernel(const P2VParams a, float* __restrict__ vol, int* __restrict__ tiled) {
  __shared__ float sp[kThreads][4];  // position and density
  __shared__ int sw[kThreads][6];    // the span: first and last
  __shared__ int part[kThreads / 32][6];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  Window w;
  float dens = 0.f;
  int first[3], last[3];
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
  // A point with no span covers nothing: first > last.
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sp[threadIdx.x][i] = live ? w.p[i] : 0.f;
    sw[threadIdx.x][i] = live ? first[i] : 1;
    sw[threadIdx.x][3 + i] = live ? last[i] : 0;
  }
  sp[threadIdx.x][3] = dens;
  __syncthreads();
  int box[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    box[k] = part[0][k];
#pragma unroll
    for (int v = 1; v < kThreads / 32; ++v) box[k] = min(box[k], part[v][k]);
  }
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
  const int n_box = bx * by * bz, plane = by * bz;
  for (int e = threadIdx.x; e < n_box; e += kThreads) {
    const int ix = box[0] + e / plane, r = e - (e / plane) * plane;
    const int iy = box[1] + r / bz, iz = box[2] + (r - (r / bz) * bz);
    const float cx = static_cast<float>(ix) * a.vs[0] + a.corner[0];
    const float cy = static_cast<float>(iy) * a.vs[1] + a.corner[1];
    const float cz = static_cast<float>(iz) * a.vs[2] + a.corner[2];
    float sum = 0.f;
    bool any = false;
    for (int i = 0; i < kThreads; ++i) {
      if (ix < sw[i][0] || ix > sw[i][3] || iy < sw[i][1] || iy > sw[i][4] || iz < sw[i][2] ||
          iz > sw[i][5]) {
        continue;
      }
      const float dx = sp[i][0] - cx, dy = sp[i][1] - cy, dz = sp[i][2] - cz;
      const float r2 = (dx * dx + dy * dy) + dz * dz;
      if (r2 <= a.cr2) {
        sum = any ? sum + expf((-r2) / a.c2k) * sp[i][3] : expf((-r2) / a.c2k) * sp[i][3];
        any = true;
      }
    }
    if (any && sum != 0.f) atomicAdd(vol + (static_cast<size_t>(ix) * a.n + iy) * a.n + iz, sum);
  }
  if (tiled != nullptr && threadIdx.x == 0) atomicAdd(tiled, 1);
}

// pairs: the shipped kernel, but in a tiled block thread t walks the union
// of its point's span and thread t ^ 32's (the next or previous row), the
// x planes of its warp's parity, and adds both points' terms of a voxel in
// one shared add.
__global__ void __launch_bounds__(kThreads)
voxelize_fwd_pairs_kernel(const P2VParams a, float* __restrict__ vol, int* __restrict__ tiled) {
  __shared__ float tile[kTileFloats];
  __shared__ int part[kThreads / 32][6];
  __shared__ float sp[kThreads][4];
  __shared__ int ss[kThreads][6];
  const int q = blockIdx.x * kThreads + (threadIdx.x & 31) * (kThreads / 32) + (threadIdx.x >> 5);
  Window w;
  float dens = 0.f;
  int first[3], last[3];
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sp[threadIdx.x][i] = live ? w.p[i] : 0.f;
    ss[threadIdx.x][i] = live ? first[i] : 1;
    ss[threadIdx.x][3 + i] = live ? last[i] : 0;
  }
  sp[threadIdx.x][3] = dens;
  __syncthreads();
  int box[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    box[k] = part[0][k];
#pragma unroll
    for (int v = 1; v < kThreads / 32; ++v) box[k] = min(box[k], part[v][k]);
  }
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
  {
    const int o = threadIdx.x ^ 32;
    float pa[3], pb[3];
    int fa[3], la[3], fb[3], lb[3], uf[3], ul[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pa[i] = sp[threadIdx.x][i];
      pb[i] = sp[o][i];
      fa[i] = ss[threadIdx.x][i];
      la[i] = ss[threadIdx.x][3 + i];
      fb[i] = ss[o][i];
      lb[i] = ss[o][3 + i];
      uf[i] = min(fa[i] <= la[i] ? fa[i] : INT_MAX, fb[i] <= lb[i] ? fb[i] : INT_MAX);
      ul[i] = max(fa[i] <= la[i] ? la[i] : INT_MIN, fb[i] <= lb[i] ? lb[i] : INT_MIN);
    }
    const float da = sp[threadIdx.x][3], db = sp[o][3];
    const int parity = (threadIdx.x >> 5) & 1;
    if (uf[0] <= ul[0]) {
      for (int ix = uf[0] + ((parity - uf[0]) & 1); ix <= ul[0]; ix += 2) {
        const float cx = static_cast<float>(ix) * a.vs[0] + a.corner[0];
        const float dxa = pa[0] - cx, dxb = pb[0] - cx;
        const float dxa2 = dxa * dxa, dxb2 = dxb * dxb;
        const bool xa = fa[0] <= ix && ix <= la[0], xb = fb[0] <= ix && ix <= lb[0];
        for (int iy = uf[1]; iy <= ul[1]; ++iy) {
          const float cy = static_cast<float>(iy) * a.vs[1] + a.corner[1];
          const float dya = pa[1] - cy, dyb = pb[1] - cy;
          const float sa = dxa2 + dya * dya, sb = dxb2 + dyb * dyb;
          const bool ya = xa && fa[1] <= iy && iy <= la[1] && sa <= a.cr2;
          const bool yb = xb && fb[1] <= iy && iy <= lb[1] && sb <= a.cr2;
          if (!(ya || yb)) continue;
          for (int iz = uf[2]; iz <= ul[2]; ++iz) {
            const float cz = static_cast<float>(iz) * a.vs[2] + a.corner[2];
            const float dza = pa[2] - cz, dzb = pb[2] - cz;
            const float ra = sa + dza * dza, rb = sb + dzb * dzb;
            const bool ta = ya && fa[2] <= iz && iz <= la[2] && ra <= a.cr2;
            const bool tb = yb && fb[2] <= iz && iz <= lb[2] && rb <= a.cr2;
            if (ta || tb) {
              float v = 0.f;
              if (ta) v = expf((-ra) / a.c2k) * da;
              if (tb) {
                const float t = expf((-rb) / a.c2k) * db;
                v = ta ? v + t : t;
              }
              atomicAdd(tile + ((ix - box[0]) * by + (iy - box[1])) * bz + (iz - box[2]), v);
            }
          }
        }
      }
    }
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

cudaError_t launch_pairs(const P2VParams& a, float* vol, int* tiled, cudaStream_t stream) {
  voxelize_fwd_pairs_kernel<<<(a.Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol, tiled);
  return cudaGetLastError();
}

// The shipped walk and terms, a thread a point, no adds.
__global__ void __launch_bounds__(kThreads)
voxelize_fwd_no_atomics_kernel(const P2VParams a, float* __restrict__ vol) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.Q) return;
  const float dens = __ldg(a.features + static_cast<size_t>(q) * a.F + (a.F - 1));
  const Window w = window(a, q);
  int first[3], last[3];
  if (!window_span(a, w, first, last)) return;
  float sum = 0.f;
  walk_span(a, w, first, last, [&](int, int, int, float r2) { sum = sum + expf((-r2) / a.c2k) * dens; });
  if (sum == -12345.f) vol[q] = sum;
}

cudaError_t launch_gather(const P2VParams& a, float* vol, int* tiled, cudaStream_t stream) {
  voxelize_fwd_gather_kernel<<<(a.Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol, tiled);
  return cudaGetLastError();
}

cudaError_t launch_no_atomics(const P2VParams& a, float* vol, int*, cudaStream_t stream) {
  voxelize_fwd_no_atomics_kernel<<<(a.Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, vol);
  return cudaGetLastError();
}

}  // namespace
