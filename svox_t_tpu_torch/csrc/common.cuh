// Shared device functions of the octree kernels (K1), the baked lookup
// (K6), the march step, trilinear interpolation (K4), the feature pool's
// row loads (K5) and the spherical bases of the march kernels.
//
// Replaces: svox_t_tpu/ops/traversal.py `descend` (the batched
// fixed-trip-count descent), `dda_unit`, `get_delta_scale` and
// `clamp_coord`; svox_t_tpu/ops/bake.py `lookup_xyz` / `lookup` (with
// `_descend_chain`); svox_t_tpu/ops/render.py `_clip_to_occupied` and the
// skip-box exit of `_lookup_leaf_xyz`; and svox_t_tpu/ops/sh.py
// `eval_basis` (SH, SG, ASG). On the TPU the descent was n_levels rounds
// of one batched gather; here it is a per-thread pointer chase that stops
// at the leaf, as in the CUDA reference's query_single_from_root.
//
// Bound on an H100: latency. Each level is one dependent 4-byte load from
// the child table (9.5 MB at depth 9, so it lives in the 50 MB L2 after
// the first touches), so a descent costs depth x L2 latency. The baked
// lookup replaces the chase with at most three dependent loads (top grid,
// mid and fine bricks), computing the in-leaf fraction from one
// finest-grid floor. The design answer is occupancy: a thread per point or
// ray and small register footprints, so enough warps are resident to hide
// the chains.
//
// The march kernels take the structure as a template parameter: TreeWalk
// (the descent) or Baked (the lookup, the occupied-box cull and the skip
// boxes), each with one lookup(), so a kernel changes in one place.
//
// Arithmetic is kept in the order of the plain PyTorch versions
// (ops/traversal.py, ops/bake.py, ops/render.py), and the library is built
// with -fmad=false, so the same point finds the same cell with the same
// fraction. The one fused multiply-add is explicit: a sample lies at
// o + t * d rounded once (sample_pos, ops/render.py `sample_position`).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Entry-point names of a structure's kernel instances: a source (or the
// build's -D flags, for a pool type) defines SVOX_STRUCTURE and
// SVOX_SUFFIX (empty for the tree walk, _baked for the bake; then _interp,
// then _bf16 or _i8 for a pool type, SVOX_POOL) and includes a march
// header, whose entry SVOX_NAME(svox_x) is then svox_x,
// svox_x_baked, ...
#define SVOX_CAT2(a, b) a##b
#define SVOX_CAT(a, b) SVOX_CAT2(a, b)
#define SVOX_NAME(base) SVOX_CAT(base, SVOX_SUFFIX)

namespace svox {

// float32(1 - 1e-6): the upper clamp of tree coordinates.
constexpr float kClampHi = 0.999999f;

__device__ __forceinline__ float clamp_coord(float x) {
  return fminf(fmaxf(x, 0.f), kClampHi);
}

struct Leaf {
  int32_t flat;    // leaf cell: packed tree cell, or baked cell
  float cube_sz;   // N^(depth+1)
  float fx, fy, fz;  // in-leaf fraction
  int32_t row;     // feature row (>= M: empty space; set by a lookup())
};

// One level of the descent on one axis: the child index floor(x * N),
// clamped to N - 1, with x replaced by the fraction within that child.
__device__ __forceinline__ int level_step(float& x, float Nf, float hi) {
  const float xs = x * Nf;
  const int u = static_cast<int>(fminf(floorf(xs), hi));
  x = xs - static_cast<float>(u);
  return u;
}

// Root-to-leaf walk over relative child offsets: node += child[flat].
// Runs at most n_levels iterations and stops at the first 0 entry. A point
// that finds no leaf within n_levels keeps flat 0, as the JAX descent does.
// Also returns the leaf's integer cell at its own resolution, the cell the
// per-level floors selected (points_leaf_aabb).
__device__ __forceinline__ Leaf descend_cell(const int32_t* __restrict__ child,
                                             int N, int n_levels, float x, float y,
                                             float z, int& cx, int& cy, int& cz) {
  x = clamp_coord(x);
  y = clamp_coord(y);
  z = clamp_coord(z);
  const float Nf = static_cast<float>(N);
  const float hi = static_cast<float>(N - 1);
  int32_t node = 0;
  float cube = Nf;
  int32_t leaf = 0;
  cx = cy = cz = 0;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int u = level_step(x, Nf, hi);
    const int v = level_step(y, Nf, hi);
    const int w = level_step(z, Nf, hi);
    cx = cx * N + u;
    cy = cy * N + v;
    cz = cz * N + w;
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

// Float atomic min and max through the ordered-int trick: a non-negative
// float orders as a signed int, a negative one in reverse as an unsigned
// int. Exact, so a box folded with them equals a plain min / max.
__device__ __forceinline__ void atomic_min_float(float* a, float v) {
  if (v >= 0.f) {
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_float(float* a, float v) {
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

// descend_cell without the cell, whose sums the compiler drops.
__device__ __forceinline__ Leaf descend(const int32_t* __restrict__ child,
                                        int N, int n_levels,
                                        float x, float y, float z) {
  int cx, cy, cz;
  return descend_cell(child, N, n_levels, x, y, z, cx, cy, cz);
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

// The sample point o + t * d of a ray, rounded once.
__device__ __forceinline__ void sample_pos(const Ray& r, float t, float& x, float& y,
                                           float& z) {
  x = __fmaf_rn(t, r.dx, r.ox);
  y = __fmaf_rn(t, r.dy, r.oy);
  z = __fmaf_rn(t, r.dz, r.oz);
}

// ---------------------------------------------------------------------
// The structures a march walks.

// What the host passes (ops/bake.py `StructureDesc`, field for field): the
// tree's tables, or the bake's tables, occupied box and fast-mode flags.
struct StructDesc {
  const int32_t* child;
  const int32_t* data;
  int N;
  int n_levels;
  const int32_t* top;
  const int32_t* mid;
  const int32_t* brick;
  const int32_t* src_map;
  int top_levels;
  int mid_levels;
  int brick_levels;
  int n_mid;
  const float* aabb_lo;
  const float* aabb_hi;
  int box_advance;
  int skip_base;
};

__host__ __device__ constexpr int ipow(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

// K2+K4's corner lookups (render_fwd.cuh's interp instances): the tree
// walk's own descent keeps the node of each of its first kPathLevels levels
// in shared memory, kPathStride (the block's threads) apart.
constexpr int kPathLevels = 16;
constexpr int kPathStride = 128;

// The integer cell of a corner at a leaf's resolution 2^sh a side, of its
// clamped coordinate x: exact (a power-of-two scale and a truncation).
__device__ __forceinline__ unsigned pow2_cell(float x, int sh) {
  return static_cast<unsigned>(x * __int_as_float((sh + 127) << 23));
}

// The octree walk: descend, then the leaf's row.
struct TreeWalk {
  static constexpr bool kBaked = false;
  const int32_t* child;
  const int32_t* data;
  int N;
  int n_levels;

  static TreeWalk from(const StructDesc& s) { return {s.child, s.data, s.N, s.n_levels}; }

  __device__ __forceinline__ Leaf lookup(float x, float y, float z) const {
    Leaf l = descend(child, N, n_levels, x, y, z);
    l.row = __ldg(data + l.flat);
    return l;
  }
  // The tree cell a leaf's weight adds into.
  __device__ __forceinline__ int32_t tree_cell(int32_t c) const { return c; }
  // No occupied box: the cube test stands.
  __device__ __forceinline__ bool cull(Ray&, bool hit) const { return hit; }

  // What a sample's own descent keeps for its corners (K2+K4): the leaf's
  // cell at its own resolution (descend_cell's), its level (n_levels where
  // no leaf was found) and, at path[lvl * kPathStride], the node of each
  // level it passed.
  struct Keep {
    int cx, cy, cz, level;
    int32_t* path;
  };

  // lookup(), keeping what corner_row reuses.
  __device__ __forceinline__ Leaf lookup_keep(float x, float y, float z, Keep& k) const {
    x = clamp_coord(x);
    y = clamp_coord(y);
    z = clamp_coord(z);
    const float Nf = static_cast<float>(N);
    const float hi = static_cast<float>(N - 1);
    int32_t node = 0;
    float cube = Nf;
    int32_t leaf = 0;
    k.cx = k.cy = k.cz = 0;
    k.level = n_levels;
    for (int lvl = 0; lvl < n_levels; ++lvl) {
      if (lvl < kPathLevels) k.path[lvl * kPathStride] = node;
      const int u = level_step(x, Nf, hi);
      const int v = level_step(y, Nf, hi);
      const int w = level_step(z, Nf, hi);
      k.cx = k.cx * N + u;
      k.cy = k.cy * N + v;
      k.cz = k.cz * N + w;
      const int32_t flat = ((node * N + u) * N + v) * N + w;
      const int32_t skip = __ldg(child + flat);
      if (skip == 0) {
        leaf = flat;
        k.level = lvl;
        break;
      }
      node += skip;
      cube *= Nf;
    }
    Leaf l{leaf, cube, x, y, z};
    l.row = __ldg(data + leaf);
    return l;
  }

  // The row of a corner point (x, y, z) of a sample whose own descent kept
  // k and found own_row: lookup(x, y, z).row bit for bit. For N a power of
  // two the corner's descent follows the own one down to the first level m
  // at which their cells' digits part (the corner's cell at the leaf's
  // resolution differs from the own one by at most 1 on each axis, so
  // usually at the last level or two): it starts at the own path's node of
  // level m, the fraction there frac(x * N^m) computed at once (level_step
  // is exact for such N: a scale by N, a floor, a subtraction), and a
  // corner in the own cell takes the own row with no load. Any other N
  // descends from the root.
  __device__ __forceinline__ int32_t corner_row(float x, float y, float z, const Keep& k,
                                                int32_t own_row) const {
    x = clamp_coord(x);
    y = clamp_coord(y);
    z = clamp_coord(z);
    int m = 0;
    int32_t node = 0;
    if ((N & (N - 1)) == 0) {
      const int L = __ffs(N) - 1;
      const int sh = L * (k.level + 1);
      const unsigned diff = (pow2_cell(x, sh) ^ static_cast<unsigned>(k.cx)) |
                            (pow2_cell(y, sh) ^ static_cast<unsigned>(k.cy)) |
                            (pow2_cell(z, sh) ^ static_cast<unsigned>(k.cz));
      if (diff == 0) return own_row;
      const int bits = 32 - __clz(diff);
      m = min(k.level + 1 - (L == 1 ? bits : (bits + L - 1) / L), kPathLevels - 1);
      node = k.path[m * kPathStride];
      const float nm = __int_as_float((L * m + 127) << 23);
      x = x * nm;
      y = y * nm;
      z = z * nm;
      x = x - floorf(x);
      y = y - floorf(y);
      z = z - floorf(z);
    }
    const float Nf = static_cast<float>(N);
    const float hi = static_cast<float>(N - 1);
    int32_t leaf = 0;
    for (int lvl = m; lvl < n_levels; ++lvl) {
      const int u = level_step(x, Nf, hi);
      const int v = level_step(y, Nf, hi);
      const int w = level_step(z, Nf, hi);
      const int32_t flat = ((node * N + u) * N + v) * N + w;
      const int32_t skip = __ldg(child + flat);
      if (skip == 0) {
        leaf = flat;
        break;
      }
      node += skip;
    }
    return __ldg(data + leaf);
  }
};

constexpr int kRowBits = 27;
constexpr int32_t kRowMask = (1 << kRowBits) - 1;
constexpr int32_t kSkipBitsSpan = 1 << 24;

// The baked structure (ops/bake.py): top grid -> [mid brick ->] brick.
struct Baked {
  static constexpr bool kBaked = true;
  const int32_t* top;
  const int32_t* mid;
  const int32_t* brick;
  const int32_t* src_map;
  const float* lo;
  const float* hi;
  int N, R, M1, Bk, G, D, n_top, n_mid, log2N, mid_levels, brick_levels;
  // For N a power of two, the stage divisions as shifts: a finest cell's
  // top cell is g >> sh_top, its brick cell g & (Bk - 1), its mid cell
  // (g >> sh_brick) & (M1 - 1).
  int sh_top, sh_brick;
  int box_advance, skip_base;

  static Baked from(const StructDesc& s) {
    Baked b;
    b.top = s.top;
    b.mid = s.mid;
    b.brick = s.brick;
    b.src_map = s.src_map;
    b.lo = s.aabb_lo;
    b.hi = s.aabb_hi;
    b.N = s.N;
    b.R = ipow(s.N, s.top_levels);
    b.M1 = ipow(s.N, s.mid_levels);
    b.Bk = ipow(s.N, s.brick_levels);
    b.G = b.R * b.M1 * b.Bk;
    b.D = s.top_levels + s.mid_levels + s.brick_levels;
    b.n_top = b.R * b.R * b.R;
    b.n_mid = s.n_mid;
    b.log2N = (s.N & (s.N - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(s.N)) : -1;
    b.sh_top = b.log2N * (s.mid_levels + s.brick_levels);
    b.sh_brick = b.log2N * s.brick_levels;
    b.mid_levels = s.mid_levels;
    b.brick_levels = s.brick_levels;
    b.box_advance = s.box_advance;
    b.skip_base = s.skip_base;
    return b;
  }

  // One axis of the per-level descent chain over `levels` levels: the
  // finest-grid cell g and the fraction after the last level.
  __device__ __forceinline__ float chain(float x, int levels, int& g) const {
    const float Nf = static_cast<float>(N);
    const float hi_u = static_cast<float>(N - 1);
    g = 0;
    for (int l = 0; l < levels; ++l) g = g * N + level_step(x, Nf, hi_u);
    return x;
  }

  // K6: the leaf of a tree-space point. All stage indices come from one
  // finest-grid floor per axis (integer division up the stages): for N a
  // power of two the floor of p * G, exact; for other N the descent's own
  // per-level chain, so floors and fractions are the tree walk's bit for
  // bit.
  __device__ __forceinline__ Leaf lookup(float x, float y, float z) const {
    x = clamp_coord(x);
    y = clamp_coord(y);
    z = clamp_coord(z);
    int gx, gy, gz;
    // Cells of the finest grid: top (t), mid (m) and brick (b) stages.
    int tx, ty, tz, mx, my, mz, bx, by, bz;
    if (log2N >= 0) {
      const float Gf = static_cast<float>(G);
      gx = min(static_cast<int>(x * Gf), G - 1);
      gy = min(static_cast<int>(y * Gf), G - 1);
      gz = min(static_cast<int>(z * Gf), G - 1);
      tx = gx >> sh_top, ty = gy >> sh_top, tz = gz >> sh_top;
      mx = (gx >> sh_brick) & (M1 - 1), my = (gy >> sh_brick) & (M1 - 1);
      mz = (gz >> sh_brick) & (M1 - 1);
      bx = gx & (Bk - 1), by = gy & (Bk - 1), bz = gz & (Bk - 1);
    } else {
      chain(x, D, gx);
      chain(y, D, gy);
      chain(z, D, gz);
      const int st = G / R;
      tx = gx / st, ty = gy / st, tz = gz / st;
      mx = (gx / Bk) % M1, my = (gy / Bk) % M1, mz = (gz / Bk) % M1;
      bx = gx % Bk, by = gy % Bk, bz = gz % Bk;
    }
    int32_t cell = (tx * R + ty) * R + tz;
    int32_t e = __ldg(top + cell);
    if (mid_levels > 0) {
      if (e < 0) {
        const int32_t m = (((-e - 1) * M1 + mx) * M1 + my) * M1 + mz;
        e = __ldg(mid + m);
        cell = n_top + m;
        if (e < 0) {
          const int32_t f = (((-e - 1) * Bk + bx) * Bk + by) * Bk + bz;
          e = __ldg(brick + f);
          cell = n_top + n_mid + f;
        }
      }
    } else if (brick_levels > 0 && e < 0) {
      const int32_t b = (((-e - 1) * Bk + bx) * Bk + by) * Bk + bz;
      e = __ldg(brick + b);
      cell = n_top + b;
    }
    const int depth = static_cast<int>(static_cast<uint32_t>(e) >> kRowBits);
    Leaf l;
    l.flat = cell;
    l.row = e & kRowMask;
    if (log2N >= 0) {
      // 2^((depth + 1) log2 N), built from its exponent bits: exact.
      l.cube_sz = __int_as_float(((depth + 1) * log2N + 127) << 23);
      const float sx = x * l.cube_sz, sy = y * l.cube_sz, sz = z * l.cube_sz;
      l.fx = sx - floorf(sx);
      l.fy = sy - floorf(sy);
      l.fz = sz - floorf(sz);
    } else {
      int g;
      l.cube_sz = static_cast<float>(ipow(N, depth + 1));
      l.fx = chain(x, depth + 1, g);
      l.fy = chain(y, depth + 1, g);
      l.fz = chain(z, depth + 1, g);
    }
    return l;
  }

  __device__ __forceinline__ int32_t tree_cell(int32_t c) const { return __ldg(src_map + c); }

  // What a sample's own lookup keeps for its corners (K2+K4): its cell at
  // the leaf's resolution (the finest-grid floor's leading depth + 1
  // digits).
  struct Keep {
    int cx, cy, cz;
  };

  // The stage cells of a clamped point's finest-grid cell, as lookup()
  // computes them.
  __device__ __forceinline__ void stage_cells(float x, float y, float z, int& gx, int& gy, int& gz,
                                              int& tx, int& ty, int& tz, int& mx, int& my, int& mz,
                                              int& bx, int& by, int& bz) const {
    if (log2N >= 0) {
      const float Gf = static_cast<float>(G);
      gx = min(static_cast<int>(x * Gf), G - 1);
      gy = min(static_cast<int>(y * Gf), G - 1);
      gz = min(static_cast<int>(z * Gf), G - 1);
      tx = gx >> sh_top, ty = gy >> sh_top, tz = gz >> sh_top;
      mx = (gx >> sh_brick) & (M1 - 1), my = (gy >> sh_brick) & (M1 - 1);
      mz = (gz >> sh_brick) & (M1 - 1);
      bx = gx & (Bk - 1), by = gy & (Bk - 1), bz = gz & (Bk - 1);
    } else {
      chain(x, D, gx);
      chain(y, D, gy);
      chain(z, D, gz);
      const int st = G / R;
      tx = gx / st, ty = gy / st, tz = gz / st;
      mx = (gx / Bk) % M1, my = (gy / Bk) % M1, mz = (gz / Bk) % M1;
      bx = gx % Bk, by = gy % Bk, bz = gz % Bk;
    }
  }

  // lookup(), keeping the own cell for the corners (svox::corners_keep).
  __device__ __forceinline__ Leaf lookup_keep(float x, float y, float z, Keep& k) const {
    x = clamp_coord(x);
    y = clamp_coord(y);
    z = clamp_coord(z);
    int gx, gy, gz, tx, ty, tz, mx, my, mz, bx, by, bz;
    stage_cells(x, y, z, gx, gy, gz, tx, ty, tz, mx, my, mz, bx, by, bz);
    int32_t cell = (tx * R + ty) * R + tz;
    int32_t e = __ldg(top + cell);
    if (mid_levels > 0) {
      if (e < 0) {
        const int32_t m = (((-e - 1) * M1 + mx) * M1 + my) * M1 + mz;
        e = __ldg(mid + m);
        cell = n_top + m;
        if (e < 0) {
          const int32_t f = (((-e - 1) * Bk + bx) * Bk + by) * Bk + bz;
          e = __ldg(brick + f);
          cell = n_top + n_mid + f;
        }
      }
    } else if (brick_levels > 0 && e < 0) {
      const int32_t b = (((-e - 1) * Bk + bx) * Bk + by) * Bk + bz;
      e = __ldg(brick + b);
      cell = n_top + b;
    }
    const int depth = static_cast<int>(static_cast<uint32_t>(e) >> kRowBits);
    Leaf l;
    l.flat = cell;
    l.row = e & kRowMask;
    if (log2N >= 0) {
      const int below = log2N * (D - depth - 1);
      k.cx = gx >> below, k.cy = gy >> below, k.cz = gz >> below;
      l.cube_sz = __int_as_float(((depth + 1) * log2N + 127) << 23);
      const float sx = x * l.cube_sz, sy = y * l.cube_sz, sz = z * l.cube_sz;
      l.fx = sx - floorf(sx);
      l.fy = sy - floorf(sy);
      l.fz = sz - floorf(sz);
    } else {
      const int below = ipow(N, D - depth - 1);
      k.cx = gx / below, k.cy = gy / below, k.cz = gz / below;
      int g;
      l.cube_sz = static_cast<float>(ipow(N, depth + 1));
      l.fx = chain(x, depth + 1, g);
      l.fy = chain(y, depth + 1, g);
      l.fz = chain(z, depth + 1, g);
    }
    return l;
  }

  // The exact cull against the occupied box: a ray that misses it, or an
  // inverted (empty) box, renders the background; the march ends at the
  // box exit; with box_advance (fast mode) it starts at the box entry.
  // Returns the culled hit.
  __device__ __forceinline__ bool cull(Ray& r, bool hit) const {
    const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
    const float hx = __ldg(hi), hy = __ldg(hi + 1), hz = __ldg(hi + 2);
    const float t1x = (lx - r.ox) * r.ivx, t2x = (hx - r.ox) * r.ivx;
    const float t1y = (ly - r.oy) * r.ivy, t2y = (hy - r.oy) * r.ivy;
    const float t1z = (lz - r.oz) * r.ivz, t2z = (hz - r.oz) * r.ivz;
    const float a_lo = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float a_hi = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool valid = lx <= hx && ly <= hy && lz <= hz;
    hit = hit && valid && a_hi >= fmaxf(a_lo, 0.f) && a_hi >= r.tmin;
    if (box_advance) r.tmin = fmaxf(r.tmin, a_lo);
    r.tmax = fminf(r.tmax, a_hi);
    return hit;
  }
};

// The leaf-adaptive step from a sample's leaf: (sub_tmax - sub_tmin) /
// cube_sz + step from the in-leaf DDA. On a bake with skip codes on (fast
// mode), an empty leaf whose row is SKIP_BASE + bits exits the packed box
// instead of its cell; the box form with extent 0 is the cell DDA bit for
// bit, so the branch only saves work.
template <class S>
__device__ __forceinline__ float step_dt(const S& s, const Leaf& l, const Ray& r,
                                         float step_size) {
  float sub_tmin, sub_tmax;
  if constexpr (S::kBaked) {
    const int32_t bits = l.row - s.skip_base;
    if (s.skip_base != 0 && bits >= 0 && bits < kSkipBitsSpan) {
      const float elx = static_cast<float>(bits & 15);
      const float ely = static_cast<float>((bits >> 8) & 15);
      const float elz = static_cast<float>((bits >> 16) & 15);
      const float t1x = -(l.fx + elx) * r.ivx;
      const float t2x = t1x + ((1.f + static_cast<float>((bits >> 4) & 15)) + elx) * r.ivx;
      const float t1y = -(l.fy + ely) * r.ivy;
      const float t2y = t1y + ((1.f + static_cast<float>((bits >> 12) & 15)) + ely) * r.ivy;
      const float t1z = -(l.fz + elz) * r.ivz;
      const float t2z = t1z + ((1.f + static_cast<float>((bits >> 20) & 15)) + elz) * r.ivz;
      sub_tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      sub_tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      sub_tmin = fmaxf(sub_tmin, 0.f);
      sub_tmax = fminf(sub_tmax, 1e9f);
      return (sub_tmax - sub_tmin) / l.cube_sz + step_size;
    }
  }
  dda_unit(l.fx, l.fy, l.fz, r.ivx, r.ivy, r.ivz, sub_tmin, sub_tmax);
  return (sub_tmax - sub_tmin) / l.cube_sz + step_size;
}

// A ray's sample at t: its leaf (with row) and step.
template <class S>
__device__ __forceinline__ Leaf sample_leaf(const S& s, const Ray& r, float t,
                                            float step_size, float& dt) {
  float x, y, z;
  sample_pos(r, t, x, y, z);
  const Leaf l = s.lookup(x, y, z);
  dt = step_dt(s, l, r, step_size);
  return l;
}

// ---------------------------------------------------------------------
// K5: the feature pool's element type. Replaces svox_t_tpu/ops/render.py
// `_gather_features` (with `QuantizedFeatures`, `_pack_features`): the
// JAX package gathers whole rows, dequantizes or upcasts them, and packs
// a large pool G rows to a table row for the TPU's gather; that packing
// is a TPU table layout and has no counterpart here. An instance that
// defines SVOX_POOL (svox::PoolBF16 or svox::PoolI8) instantiates its
// kernels for that pool; the others keep svox::PoolF32. A kernel holds
// the pool as svox::Pool, forms a row's address as pool + row * D (for
// PoolF32 the pointer arithmetic of before) and reads a column with ld,
// which returns float32 right after the load:
//   PoolF32:  a float pointer; ld is __ldg, as before K5, so the float32
//             instances compile to the code they compiled to before.
//   PoolBF16: 2-byte loads; a bf16 value widens to float32 exactly (its
//             bits are the float's top 16).
//   PoolI8:   1-byte loads and per-column scale and zero (D floats each,
//             read through __ldg: they stay in L1); the column is
//             float(q) * scale + zero, a multiply and an add, each rounded
//             (the library is built with -fmad=false), as the plain version
//             (ops/render.py `gather_rows`) and the JAX package compute it.
// A row address is a "pointer" of the pool's type: adding k moves to
// column + k (for PoolI8 the scale and zero move with it), so the march
// code indexes rows as it indexes a float row. The bf16 and int8 sources
// run SG and ASG of every size on their 25-term instance (kFloatPool,
// launch_basis): 20 more sources with every capacity made the build more
// than twice as long.
// Bound on an H100: the pool is the march's largest table (157 MB in
// float32 at depth 9 SH9); bf16 halves and int8 quarters the bytes of
// every row a sample reads, which moves the march's byte bound and, for
// the rows that miss L2, its latency. The work per sample is unchanged.

using PoolF32 = const float*;
using PoolBF16 = const uint16_t*;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// An int8 pool: rows of D values and the per-column scale and zero.
struct PoolI8 {
  const int8_t* q;
  const float* scale;
  const float* zero;
};

// A column of an int8 row: its value and its column's scale and zero.
struct QPtr {
  const int8_t* q;
  const float* scale;
  const float* zero;
  __device__ __forceinline__ QPtr operator+(int k) const { return {q + k, scale + k, zero + k}; }
  __device__ __forceinline__ QPtr operator-(int k) const { return {q - k, scale - k, zero - k}; }
};

// The int8 pool at element offset `off` (a row start): its value at
// column 0 of that row.
__device__ __forceinline__ QPtr operator+(const PoolI8& f, size_t off) {
  return {f.q + off, f.scale, f.zero};
}
__device__ __forceinline__ float ld(const QPtr& p) {
  return static_cast<float>(__ldg(p.q)) * __ldg(p.scale) + __ldg(p.zero);
}

// The pool a C entry point is given: features (M, D) of the pool's type,
// and for an int8 pool the (D,) float32 scale and zero (else null).
template <class P>
inline P make_pool(const void* features, const float* scale, const float* zero);
template <>
inline PoolF32 make_pool<PoolF32>(const void* features, const float*, const float*) {
  return static_cast<const float*>(features);
}
template <>
inline PoolBF16 make_pool<PoolBF16>(const void* features, const float*, const float*) {
  return static_cast<const uint16_t*>(features);
}
template <>
inline PoolI8 make_pool<PoolI8>(const void* features, const float* scale, const float* zero) {
  return {static_cast<const int8_t*>(features), scale, zero};
}

#ifndef SVOX_POOL
#define SVOX_POOL svox::PoolF32
#endif
using Pool = SVOX_POOL;
constexpr bool kFloatPool = std::is_same<Pool, PoolF32>::value;

// A pool row in vectors (K2 and K13c-e at vector width 4, the three-colour
// RGBA, SH1 and SH9 rows with no spare column: D = 4, 4 or 28, so every
// group of 4 columns is aligned when the pool is).

// Bytes of a pool value.
template <class P>
struct PoolElem {
  static constexpr size_t value = sizeof(std::remove_pointer_t<P>);
};
template <>
struct PoolElem<PoolI8> {
  static constexpr size_t value = sizeof(int8_t);
};

// Whether a width-4 launch may load the pool's rows 4 values at a time:
// the pool aligned to 4 values, an int8 pool's scale and zero to 16 bytes
// (the rows of D = 4 or 28 values then keep the alignment; so do the frames
// of a stack).
template <class P = Pool>
inline bool vector_aligned(const void* features, const float* scale, const float* zero) {
  constexpr size_t elem = PoolElem<P>::value;
  return reinterpret_cast<uintptr_t>(features) % (elem * 4) == 0 &&
         reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(zero) % 16 == 0;
}

// Four consecutive columns of a pool row, widened to float32: one 16-byte
// load of a float32 row, one 8-byte load of a bf16 row (a bf16 value is
// the top 16 bits of its float32), one 4-byte load of an int8 row with
// 16-byte loads of its columns' scale and zero, each value dequantized as
// ld does (a multiply, then an add, each rounded). The column is aligned
// to 4 elements.
__device__ __forceinline__ float4 load_cols(const float* col) {
  return __ldg(reinterpret_cast<const float4*>(col));
}
__device__ __forceinline__ float4 load_cols(const uint16_t* col) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(col));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load_cols(const QPtr& col) {
  const char4 q = __ldg(reinterpret_cast<const char4*>(col.q));
  const float4 s = __ldg(reinterpret_cast<const float4*>(col.scale));
  const float4 z = __ldg(reinterpret_cast<const float4*>(col.zero));
  return make_float4(static_cast<float>(q.x) * s.x + z.x, static_cast<float>(q.y) * s.y + z.y,
                     static_cast<float>(q.z) * s.z + z.z, static_cast<float>(q.w) * s.w + z.w);
}

// Columns e .. e + 3 of a row into the register row.
template <class Row>
__device__ __forceinline__ void load_row4(const Row& row, float* buf, int e) {
  const float4 v = load_cols(row + e);
  buf[e] = v.x;
  buf[e + 1] = v.y;
  buf[e + 2] = v.z;
  buf[e + 3] = v.w;
}

// The whole of pool row r, when r is in [0, M), into the register row b
// (rows of kD values, kD a multiple of 4).
template <int kD, class P>
__device__ __forceinline__ void load_row(const P& features, int32_t r, int M, float* b) {
  if (static_cast<uint32_t>(r) < static_cast<uint32_t>(M)) {
    const auto row = features + static_cast<size_t>(r) * kD;
#pragma unroll
    for (int e = 0; e < kD; e += 4) load_row4(row, b, e);
  }
}

// Column e of the sample's row: the register copy (W = 4), or the pool's.
template <int W, class Row>
__device__ __forceinline__ float row_col(const Row& row, const float* buf, int e) {
  if constexpr (W == 4) {
    return buf[e];
  } else {
    return ld(row + e);
  }
}

// ---------------------------------------------------------------------
// K4: trilinear interpolation. Replaces svox_t_tpu/ops/render.py
// `_interp_corners` and `_gather_interp` (ops/render.py `interp_corners`,
// `_interp`). A source that defines SVOX_INTERP 1 instantiates its march
// kernels with kInterp: each sample then reads the 8 cells around it on
// its own leaf's grid, each one S::lookup (a descent, or the baked
// lookup), instead of its own row. The nearest-mode instances leave SVOX_INTERP
// undefined, and every interp branch is an `if constexpr` that compiles
// away there.

#ifndef SVOX_INTERP
#define SVOX_INTERP 0
#endif
constexpr bool kInterp = SVOX_INTERP != 0;

// The structure's cull of a ray (S::cull), which is off under interp:
// corner cells bleed sigma up to half a cell outside the occupied box.
template <class S>
__device__ __forceinline__ bool march_cull(const S& s, Ray& r, bool hit) {
  if constexpr (kInterp) {
    return hit;
  } else {
    return s.cull(r, hit);
  }
}

// The 8 corners of a sample: each corner's row (-1 where it is not < M,
// empty space, which adds nothing) and trilinear weight; corner
// n = 4 i + 2 j + k.
struct Corners {
  int32_t row[8];
  float w[8];
};

// The corners of the point (x, y, z) in a leaf of cube_sz cells a side:
// g = p * cube_sz - 0.5, b = floor(g), corner (i, j, k) at
// (b + (i + 0.5)) * (1 / cube_sz) per axis (the lookup clamps it to the
// cube: clamp to the edge), weight (fx * fy) * fz with f = w or 1 - w,
// w = g - b. The arithmetic is the plain version's, multiply by the
// reciprocal included; with -fmad=false the corners are its bit for bit.
// The 8 lookups do not depend on each other, so their load chains
// overlap.
template <class S>
__device__ __forceinline__ Corners sample_corners(const S& s, const Ray& r, float t,
                                                  float cube_sz, int M) {
  float x, y, z;
  sample_pos(r, t, x, y, z);
  const float gx = x * cube_sz - 0.5f, gy = y * cube_sz - 0.5f, gz = z * cube_sz - 0.5f;
  const float bx = floorf(gx), by = floorf(gy), bz = floorf(gz);
  const float wx = gx - bx, wy = gy - by, wz = gz - bz;
  const float inv = 1.f / cube_sz;
  Corners c;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int i = n >> 2, j = (n >> 1) & 1, k = n & 1;
    const int32_t row = s.lookup((bx + (i ? 1.5f : 0.5f)) * inv, (by + (j ? 1.5f : 0.5f)) * inv,
                                 (bz + (k ? 1.5f : 0.5f)) * inv).row;
    c.row[n] = static_cast<uint32_t>(row) < static_cast<uint32_t>(M) ? row : -1;
    c.w[n] = ((i ? wx : 1.f - wx) * (j ? wy : 1.f - wy)) * (k ? wz : 1.f - wz);
  }
  return c;
}

// sum_n w_n * f(row_n) over the corners with a row, in corner order from
// 0, as the plain version sums. f is linear in the row's features, so this
// equals f of the interpolated row to rounding, without holding that row.
template <class F>
__device__ __forceinline__ float interp_sum(const Corners& c, F f) {
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (c.row[n] >= 0) s = s + c.w[n] * f(c.row[n]);
  }
  return s;
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

// The pre-sigmoid color c of a feature row (the interp marches; K3 keeps
// its own inline, K2 and K13c use color_logit): row[c] (RGBA), or sum_k
// basis_k * row[c * nb + k] summed over k in order (KB the basis
// capacity, nb its run-time size).
// R is a row address of the pool's type (pool + row * D).
template <int FMT, int KB, class R>
__device__ __forceinline__ float row_logit(const R row, int c, int nb, const float* basis) {
  if constexpr (FMT == kRGBA) {
    return ld(row + c);
  } else {
    const R coef = row + c * nb;
    float s = basis[0] * ld(coef);
#pragma unroll
    for (int k = 1; k < KB; ++k) {
      if (k < nb) s = s + basis[k] * ld(coef + k);
    }
    return s;
  }
}

// The pre-sigmoid colour c of a nearest sample's row (K2, K13c): column c
// (RGBA), or sum_k basis_k * column c * nb + k, summed over k in order, from
// the register row (W = 4) or the pool's row (row_col).
template <int FMT, int kB, int W, class Row>
__device__ __forceinline__ float color_logit(const Row& row, const float* buf, int c, int nb,
                                             const float* basis) {
  if constexpr (FMT == kRGBA) {
    return row_col<W>(row, buf, c);
  } else {
    const int e0 = c * nb;
    float s = basis[0] * row_col<W>(row, buf, e0);
#pragma unroll
    for (int k2 = 1; k2 < kB; ++k2) {
      if (k2 < nb) s = s + basis[k2] * row_col<W>(row, buf, e0 + k2);
    }
    return s;
  }
}

// The pre-sigmoid colors of an interp sample: z[c] = sum_n w_n *
// row_logit(row_n, c) over the corners with a row, in corner order from 0
// (as `interp_sum`), for c < nc of the instance's KMAX. The corner loop is
// not unrolled: 8 corners x KMAX colors x KB basis terms of straight-line
// code per instance is more than the compiler finishes in a build's time.
template <int FMT, int KB, int KMAX, class P>
__device__ __forceinline__ void interp_logits(const Corners& cn, const P features, int D, int nc,
                                              int nb, const float* basis, float* z) {
#pragma unroll
  for (int c = 0; c < KMAX; ++c) z[c] = 0.f;
#pragma unroll 1
  for (int n = 0; n < 8; ++n) {
    const int32_t row = cn.row[n];
    if (row < 0) continue;
    const auto f = features + static_cast<size_t>(row) * D;
    const float w = cn.w[n];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < nc) z[c] = z[c] + w * row_logit<FMT, KB>(f, c, nb, basis);
    }
  }
}

// ---------------------------------------------------------------------
// K2+K4: the trilinear marches' corners and corner rows (render_fwd.cuh's
// interp instances, render_bwd.cuh's K3+K4 at width 4 and K9a+K4, and
// render_aux.cuh's K9b+K4, K9c+K4 and K9d+K4; K3+K4 at width 1 and the tapes
// keep sample_corners and interp_logits, so their code is unchanged).

// sample_leaf through S::lookup_keep: the leaf, its step, and what the
// sample's corners reuse.
template <class S>
__device__ __forceinline__ Leaf sample_leaf_keep(const S& s, const Ray& r, float t,
                                                 float step_size, float& dt,
                                                 typename S::Keep& k) {
  float x, y, z;
  sample_pos(r, t, x, y, z);
  const Leaf l = s.lookup_keep(x, y, z, k);
  dt = step_dt(s, l, r, step_size);
  return l;
}

// sample_corners from the sample's own lookup (own, kept in k), bit for
// bit. On each axis exactly one of b and b + 1 is the own cell (b = floor(p
// * cube_sz - 0.5), the own cell floor(p * cube_sz) on the leaf's grid), so
// one corner lies in the own leaf, whose row the own lookup found (kReuse
// >= 1). The other 7 are looked up in the order of their offsets from it
// (mask 1 to 7, the same for every thread of a warp, so no lane idles
// while another looks up), by TreeWalk::corner_row, which starts on the
// own descent's path (kReuse 2, the tree walk only), or S::lookup (kReuse
// 1); the rows then return to corner
// order (three conditional swaps of pairs, one per axis). Where a clamped
// sample has neither b nor b + 1 as its cell on an axis, all 8 corners are
// looked up.
template <int kReuse, class S>
__device__ __forceinline__ Corners corners_keep(const S& s, const Ray& r, float t, const Leaf& own,
                                                const typename S::Keep& k, int M) {
  float x, y, z;
  sample_pos(r, t, x, y, z);
  const float cube_sz = own.cube_sz;
  const float gx = x * cube_sz - 0.5f, gy = y * cube_sz - 0.5f, gz = z * cube_sz - 0.5f;
  const float bx = floorf(gx), by = floorf(gy), bz = floorf(gz);
  const float wx = gx - bx, wy = gy - by, wz = gz - bz;
  const float inv = 1.f / cube_sz;
  Corners c;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int i = n >> 2, j = (n >> 1) & 1, kk = n & 1;
    c.w[n] = ((i ? wx : 1.f - wx) * (j ? wy : 1.f - wy)) * (kk ? wz : 1.f - wz);
  }
  const int ibx = static_cast<int>(bx), iby = static_cast<int>(by), ibz = static_cast<int>(bz);
  const bool known = (ibx == k.cx || ibx + 1 == k.cx) && (iby == k.cy || iby + 1 == k.cy) &&
                     (ibz == k.cz || ibz + 1 == k.cz);
  const int own_n = known ? ((ibx + 1 == k.cx) << 2) | ((iby + 1 == k.cy) << 1) | (ibz + 1 == k.cz) : 0;
  int32_t rows[8];
#pragma unroll
  for (int mask = 0; mask < 8; ++mask) {
    const int n = own_n ^ mask;
    const float px = (bx + ((n >> 2) ? 1.5f : 0.5f)) * inv;
    const float py = (by + (((n >> 1) & 1) ? 1.5f : 0.5f)) * inv;
    const float pz = (bz + ((n & 1) ? 1.5f : 0.5f)) * inv;
    if (mask == 0 && known) {
      rows[0] = own.row;
    } else if constexpr (kReuse >= 2) {
      rows[mask] = s.corner_row(px, py, pz, k, own.row);
    } else {
      rows[mask] = s.lookup(px, py, pz).row;
    }
  }
  // rows[mask] is corner own_n ^ mask's: swap the pairs along each axis
  // on which the own corner is the upper one.
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const bool flip = (own_n >> b) & 1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (!(n & (1 << b))) {
        const int32_t lo = rows[n], hi = rows[n | (1 << b)];
        rows[n] = flip ? hi : lo;
        rows[n | (1 << b)] = flip ? lo : hi;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    c.row[n] = static_cast<uint32_t>(rows[n]) < static_cast<uint32_t>(M) ? rows[n] : -1;
  }
  return c;
}

// The sigma and pre-sigmoid colours of an interp sample of a three-colour
// row with no spare column (kD = 4 or 28: RGBA, SH1, SH9) in one pass over
// its corners, each corner's whole row loaded once in 16-, 8- or 4-byte
// loads (load_row4) and only one corner's row live at a time: sigma =
// sum_n w_n * row_n[kD - 1] and z[c] = sum_n w_n * color_logit(row_n, c),
// each in corner order from 0, as interp_sum and interp_logits sum them.
// basis must be ready (a rotation's, from the own row, before the pass).
template <int FMT, int KB, int kD, class P>
__device__ __forceinline__ float interp_row4_pass(const Corners& cn, const P features, int nb,
                                                  const float* basis, float* z) {
  float sigma = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) z[c] = 0.f;
#pragma unroll 1
  for (int n = 0; n < 8; ++n) {
    const int32_t row = cn.row[n];
    if (row < 0) continue;
    const auto f = features + static_cast<size_t>(row) * kD;
    float buf[kD];
#pragma unroll
    for (int e = 0; e < kD; e += 4) load_row4(f, buf, e);
    const float w = cn.w[n];
    sigma = sigma + w * buf[kD - 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = z[c] + w * color_logit<FMT, KB, 4>(f, buf, c, nb, basis);
  }
  return sigma;
}

}  // namespace svox

extern "C" const char* svox_error_string(int err);
