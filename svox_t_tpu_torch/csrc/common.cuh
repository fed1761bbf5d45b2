// Shared device functions of the octree kernels (K1) and the spherical
// bases of the two march kernels.
//
// Replaces: svox_t_tpu/ops/traversal.py `descend` (the batched
// fixed-trip-count descent), `dda_unit`, `get_delta_scale` and
// `clamp_coord`, and svox_t_tpu/ops/sh.py `eval_basis` (SH, SG, ASG). On
// the TPU the descent was n_levels rounds of one batched gather; here it
// is a per-thread pointer chase that stops at the leaf, as in the CUDA
// reference's query_single_from_root.
//
// Bound on an H100: latency. Each level is one dependent 4-byte load from
// the child table (9.5 MB at depth 9, so it lives in the 50 MB L2 after
// the first touches), so a descent costs depth x L2 latency. The design
// answer is occupancy: a thread per point or ray and small register
// footprints, so enough warps are resident to hide the chase.
//
// Arithmetic is kept in the order of the plain PyTorch version
// (ops/traversal.py), and the library is built with -fmad=false, so the
// same point descends to the same cell with the same fraction.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace svox {

// float32(1 - 1e-6): the upper clamp of tree coordinates.
constexpr float kClampHi = 0.999999f;

__device__ __forceinline__ float clamp_coord(float x) {
  return fminf(fmaxf(x, 0.f), kClampHi);
}

struct Leaf {
  int32_t flat;    // packed leaf cell id, index into child/data tables
  float cube_sz;   // N^(depth+1)
  float fx, fy, fz;  // in-leaf fraction
};

// Root-to-leaf walk over relative child offsets: node += child[flat].
// Runs at most n_levels iterations and stops at the first 0 entry. A point
// that finds no leaf within n_levels keeps flat 0, as the JAX descent does.
__device__ __forceinline__ Leaf descend(const int32_t* __restrict__ child,
                                        int N, int n_levels,
                                        float x, float y, float z) {
  x = clamp_coord(x);
  y = clamp_coord(y);
  z = clamp_coord(z);
  const float Nf = static_cast<float>(N);
  const float hi = static_cast<float>(N - 1);
  int32_t node = 0;
  float cube = Nf;
  int32_t leaf = 0;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const float xs = x * Nf, ys = y * Nf, zs = z * Nf;
    const int u = static_cast<int>(fminf(floorf(xs), hi));
    const int v = static_cast<int>(fminf(floorf(ys), hi));
    const int w = static_cast<int>(fminf(floorf(zs), hi));
    x = xs - static_cast<float>(u);
    y = ys - static_cast<float>(v);
    z = zs - static_cast<float>(w);
    const int32_t flat = ((node * N + u) * N + v) * N + w;
    const int32_t skip = __ldg(child + flat);
    if (skip == 0) {
      leaf = flat;
      break;
    }
    node += skip;
    cube *= Nf;
  }
  return Leaf{leaf, cube, x, y, z};
}

// Entry/exit of a ray with the unit cube; tmin clamped to >= 0 and tmax to
// <= 1e9.
__device__ __forceinline__ void dda_unit(float cx, float cy, float cz,
                                         float ivx, float ivy, float ivz,
                                         float& tmin, float& tmax) {
  const float t1x = -cx * ivx, t2x = t1x + ivx;
  const float t1y = -cy * ivy, t2y = t1y + ivy;
  const float t1z = -cz * ivz, t2z = t1z + ivz;
  tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  tmin = fmaxf(tmin, 0.f);
  tmax = fminf(tmax, 1e9f);
}

// Scale a world direction into tree space and normalize it in place;
// returns delta_scale = 1 / |scaling * dir|.
__device__ __forceinline__ float delta_scale(const float* __restrict__ scaling,
                                             float& dx, float& dy, float& dz) {
  dx = dx * scaling[0];
  dy = dy * scaling[1];
  dz = dz * scaling[2];
  const float norm = sqrtf((dx * dx + dy * dy) + dz * dz);
  const float ds = 1.f / norm;
  dx = dx * ds;
  dy = dy * ds;
  dz = dz * ds;
  return ds;
}

// A camera ray in tree space (render.py _ray_setup): origin, unit
// direction, its inverse, delta_scale and the cube's [tmin, tmax].
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, ds, tmin, tmax;
};

// Set up ray i of the world-space (B, 3) origins and dirs. False for a
// ray that misses the cube.
__device__ __forceinline__ bool setup_ray(const float* __restrict__ origins,
                                          const float* __restrict__ dirs,
                                          const float* __restrict__ offset,
                                          const float* __restrict__ scaling, int i,
                                          Ray& r) {
  r.ox = offset[0] + scaling[0] * origins[3 * i + 0];
  r.oy = offset[1] + scaling[1] * origins[3 * i + 1];
  r.oz = offset[2] + scaling[2] * origins[3 * i + 2];
  r.dx = dirs[3 * i + 0];
  r.dy = dirs[3 * i + 1];
  r.dz = dirs[3 * i + 2];
  r.ds = delta_scale(scaling, r.dx, r.dy, r.dz);
  r.ivx = 1.f / (r.dx + 1e-9f);
  r.ivy = 1.f / (r.dy + 1e-9f);
  r.ivz = 1.f / (r.dz + 1e-9f);
  dda_unit(r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz, r.tmin, r.tmax);
  return !(r.tmax < 0.f || r.tmin > r.tmax);
}

// ---------------------------------------------------------------------
// Spherical bases (ops/sh.py), evaluated at a view direction as passed.

// Feature formats, as utils/spec.py numbers them.
constexpr int kRGBA = 0;
constexpr int kSH = 1;
constexpr int kSG = 2;
constexpr int kASG = 3;
// Largest basis a kernel holds in registers.
constexpr int kMaxBasis = 25;

// Basis capacity of the kernel instance that runs a basis of nb terms:
// the smallest SH size (1, 4, 9, 16, 25) that holds nb, or 0 when nb is
// out of range or (for SH) not an SH size. SG and ASG of any size run on
// that instance with nb a run-time value; SH runs on its own size.
__host__ __device__ constexpr int basis_capacity(int fmt, int nb) {
  if (nb < 1 || nb > kMaxBasis) return 0;
  const int cap = nb <= 1 ? 1 : nb <= 4 ? 4 : nb <= 9 ? 9 : nb <= 16 ? 16 : 25;
  return fmt == kSH && cap != nb ? 0 : cap;
}

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;
constexpr float C4_0 = 2.5033429417967046f;
constexpr float C4_1 = -1.7701307697799304f;
constexpr float C4_2 = 0.9461746957575601f;
constexpr float C4_3 = -0.6690465435572892f;
constexpr float C4_4 = 0.10578554691520431f;
constexpr float C4_5 = -0.6690465435572892f;
constexpr float C4_6 = 0.47308734787878004f;
constexpr float C4_7 = -1.7701307697799304f;
constexpr float C4_8 = 0.6258357354491761f;

// SH basis of BD = (deg+1)^2 terms; expressions keep the association
// order of ops/sh.py.
template <int BD>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = C0;
  if constexpr (BD > 1) {
    b[1] = -C1 * y;
    b[2] = C1 * z;
    b[3] = -C1 * x;
  }
  if constexpr (BD > 4) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * (2.f * zz - xx - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if constexpr (BD > 9) {
      b[9] = C3_0 * y * (3.f * xx - yy);
      b[10] = C3_1 * xy * z;
      b[11] = C3_2 * y * (4.f * zz - xx - yy);
      b[12] = C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy);
      b[13] = C3_4 * x * (4.f * zz - xx - yy);
      b[14] = C3_5 * z * (xx - yy);
      b[15] = C3_6 * x * (xx - 3.f * yy);
    }
    if constexpr (BD > 16) {
      b[16] = C4_0 * xy * (xx - yy);
      b[17] = C4_1 * yz * (3.f * xx - yy);
      b[18] = C4_2 * xy * (7.f * zz - 1.f);
      b[19] = C4_3 * yz * (7.f * zz - 3.f);
      b[20] = C4_4 * (zz * (35.f * zz - 30.f) + 3.f);
      b[21] = C4_5 * xz * (7.f * zz - 3.f);
      b[22] = C4_6 * (xx - yy) * (7.f * zz - 1.f);
      b[23] = C4_7 * xz * (xx - 3.f * yy);
      b[24] = C4_8 * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
    }
  }
}

// (x, y, z) . (a[0], a[1], a[2]), summed as ops/sh.py `_dot` sums.
__device__ __forceinline__ float dot3(float x, float y, float z, const float* a) {
  return (x * __ldg(a) + y * __ldg(a + 1)) + z * __ldg(a + 2);
}

// Basis of format FMT (kSH, kSG or kASG) and size nb at (x, y, z),
// windowed to [lo, hi], into b[0, nb). BD is the instance's capacity
// (basis_capacity; SH: BD == nb). SG rows of `extra` (stride ld) are
// [lambda, mu_xyz]: exp(lambda * (dot - 1)) / nb. ASG rows are
// [a, b, x(3), y(3), z(3)]: s * exp(-a * dx^2 - b * dy^2) / nb with s,
// dx, dy the dots with the z, x and y axes.
template <int FMT, int BD>
__device__ __forceinline__ void eval_basis(float x, float y, float z,
                                           const float* __restrict__ extra,
                                           int ld, int nb, int lo, int hi,
                                           float* b) {
  if constexpr (FMT == kSH) {
    sh_basis<BD>(x, y, z, b);
  } else {
    const float fnb = static_cast<float>(nb);
#pragma unroll
    for (int k = 0; k < BD; ++k) {
      if (k < nb) {
        const float* e = extra + static_cast<size_t>(k) * ld;
        if constexpr (FMT == kSG) {
          b[k] = expf(__ldg(e) * (dot3(x, y, z, e + 1) - 1.f)) / fnb;
        } else {
          const float s = dot3(x, y, z, e + 8);
          const float dx = dot3(x, y, z, e + 2);
          const float dy = dot3(x, y, z, e + 5);
          b[k] = s * expf((-__ldg(e)) * dx * dx - __ldg(e + 1) * dy * dy) / fnb;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < BD; ++k) {
    if (k < nb && (k < lo || k > hi)) b[k] = 0.f;
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace svox

extern "C" const char* svox_error_string(int err);
