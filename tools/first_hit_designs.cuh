// The first-hit march (K9b) with every lever tools/first_hit_ab.py times,
// the ones that did not ship included (PERF.md §6): the shipped
// kernel (svox_t_tpu_torch/csrc/render_aux.cuh) keeps kFhLoop 0 and 1 and
// kFhReuse; this file adds the rotated loop's lookup ahead (kFhLoop 2), the
// tree walk's descents started on the previous sample's path (kFhPath 1 and
// 2) and the bake's reused top and mid entries (kFhTop). It is not part of
// the library: first_hit_ab.py puts it in place of render_aux.cuh's K9b
// section (inside that header's anonymous namespace, after sample_at,
// path_slot, init_keep and sample_mf) in a copy of the sources, and its
// designs set the constants below. Every lookup equals the root's bit for
// bit, so each design's hits are the shipped kernel's.

// The levers:
//  * kFhLoop: 0 the earlier kernel's loop (a sample's lookup at the top of
//    each step); 1 the loop rotated (the next sample's lookup at the end of
//    a step, after the branch); 2 rotated with the next sample's lookup
//    issued before this sample's sigma is compared (its point depends only
//    on this sample's step), so its loads overlap the sigma's;
//  * kFhPath (the tree walk, N a power of two): the next sample's descent
//    started on the previous sample's path where their cells' digits part
//    (1: every level's node in shared memory, lookup_next; 2: the
//    last two levels' nodes in registers, else from the root);
//  * kFhTop (the bake, nearest): the previous sample's top and mid entries
//    taken again while the point stays in their cells (lookup_trail);
//  * interp (K4): the corners from the sample's own lookup
//    (svox::corners_keep<kFhReuse>: the own corner's row, and at 2 the tree
//    walk's other corner descents started on the own path; 0 is
//    svox::sample_corners' 9 lookups), the sigma summed in corner order. An
//    empty own leaf is then "over" but not resident.

// kFhPath 1: lookup_keep() of a ray's next sample point, its descent
// started on the previous sample's path: k and prev are what lookup_keep
// or lookup_next kept and found for the previous sample (k.level == n_levels: none, or no leaf found; then from the
// root). lookup(x, y, z) bit for bit. For N a power of two: a point whose
// cell at the kept leaf's resolution is the kept one lies in that leaf
// (its row and cube size with no load, the fraction frac(x * cube_sz));
// any other starts at the kept path's node of the first level m at which
// their cells' digits part, the fraction there frac(x * N^m) computed at
// once (level_step is exact for such N), and rewrites the path and the
// cell from there. Any other N, or a cell wider than 30 bits, descends
// from the root.
__device__ __forceinline__ svox::Leaf lookup_next(const svox::TreeWalk& st, float x, float y, float z,
                                                svox::TreeWalk::Keep& k, const svox::Leaf& prev) {
  x = svox::clamp_coord(x);
  y = svox::clamp_coord(y);
  z = svox::clamp_coord(z);
  const int L = __ffs(st.N) - 1;
  const int sh = L * (k.level + 1);
  if ((st.N & (st.N - 1)) != 0 || k.level >= st.n_levels || sh > 30) return st.lookup_keep(x, y, z, k);
  const unsigned px = svox::pow2_cell(x, sh), py = svox::pow2_cell(y, sh), pz = svox::pow2_cell(z, sh);
  const unsigned diff = (px ^ static_cast<unsigned>(k.cx)) | (py ^ static_cast<unsigned>(k.cy)) |
                        (pz ^ static_cast<unsigned>(k.cz));
  if (diff == 0) {
    svox::Leaf l;
    l.flat = prev.flat;
    l.row = prev.row;
    l.cube_sz = prev.cube_sz;
    const float sx = x * l.cube_sz, sy = y * l.cube_sz, sz = z * l.cube_sz;
    l.fx = sx - floorf(sx);
    l.fy = sy - floorf(sy);
    l.fz = sz - floorf(sz);
    return l;
  }
  const int bits = 32 - __clz(diff);
  const int m = min(k.level + 1 - (bits + L - 1) / L, svox::kPathLevels - 1);
  int32_t node = k.path[m * svox::kPathStride];
  const float nm = __int_as_float((L * m + 127) << 23);
  x = x * nm;
  y = y * nm;
  z = z * nm;
  x = x - floorf(x);
  y = y - floorf(y);
  z = z - floorf(z);
  const int drop = L * (k.level + 1 - m);
  k.cx = static_cast<int>(px >> drop);
  k.cy = static_cast<int>(py >> drop);
  k.cz = static_cast<int>(pz >> drop);
  const float Nf = static_cast<float>(st.N);
  const float hi = static_cast<float>(st.N - 1);
  float cube = __int_as_float((L * (m + 1) + 127) << 23);
  int32_t leaf = 0;
  k.level = st.n_levels;
  for (int lvl = m; lvl < st.n_levels; ++lvl) {
    if (lvl < svox::kPathLevels) k.path[lvl * svox::kPathStride] = node;
    const int u = svox::level_step(x, Nf, hi);
    const int v = svox::level_step(y, Nf, hi);
    const int w = svox::level_step(z, Nf, hi);
    k.cx = k.cx * st.N + u;
    k.cy = k.cy * st.N + v;
    k.cz = k.cz * st.N + w;
    const int32_t flat = ((node * st.N + u) * st.N + v) * st.N + w;
    const int32_t skip = __ldg(st.child + flat);
    if (skip == 0) {
      leaf = flat;
      k.level = lvl;
      break;
    }
    node += skip;
    cube *= Nf;
  }
  svox::Leaf l{leaf, cube, x, y, z};
  l.row = __ldg(st.data + leaf);
  return l;
}

// kFhTop: the top and mid entries a ray's previous lookup loaded, and their
// cells (-1: none yet).
struct Trail {
  int32_t top_cell, top_e, mid_cell, mid_e;
};

// lookup() bit for bit, the previous sample's top and mid entries taken
// again without a load while the point stays in their cells.
__device__ __forceinline__ svox::Leaf lookup_trail(const svox::Baked& st, float x, float y, float z, Trail& k) {
  x = svox::clamp_coord(x);
  y = svox::clamp_coord(y);
  z = svox::clamp_coord(z);
  int gx, gy, gz, tx, ty, tz, mx, my, mz, bx, by, bz;
  st.stage_cells(x, y, z, gx, gy, gz, tx, ty, tz, mx, my, mz, bx, by, bz);
  int32_t cell = (tx * st.R + ty) * st.R + tz;
  if (cell != k.top_cell) {
    k.top_cell = cell;
    k.top_e = __ldg(st.top + cell);
  }
  int32_t e = k.top_e;
  if (st.mid_levels > 0) {
    if (e < 0) {
      const int32_t m = (((-e - 1) * st.M1 + mx) * st.M1 + my) * st.M1 + mz;
      if (m != k.mid_cell) {
        k.mid_cell = m;
        k.mid_e = __ldg(st.mid + m);
      }
      e = k.mid_e;
      cell = st.n_top + m;
      if (e < 0) {
        const int32_t f = (((-e - 1) * st.Bk + bx) * st.Bk + by) * st.Bk + bz;
        e = __ldg(st.brick + f);
        cell = st.n_top + st.n_mid + f;
      }
    }
  } else if (st.brick_levels > 0 && e < 0) {
    const int32_t b = (((-e - 1) * st.Bk + bx) * st.Bk + by) * st.Bk + bz;
    e = __ldg(st.brick + b);
    cell = st.n_top + b;
  }
  const int depth = static_cast<int>(static_cast<uint32_t>(e) >> svox::kRowBits);
  svox::Leaf l;
  l.flat = cell;
  l.row = e & svox::kRowMask;
  if (st.log2N >= 0) {
    l.cube_sz = __int_as_float(((depth + 1) * st.log2N + 127) << 23);
    const float sx = x * l.cube_sz, sy = y * l.cube_sz, sz = z * l.cube_sz;
    l.fx = sx - floorf(sx);
    l.fy = sy - floorf(sy);
    l.fz = sz - floorf(sz);
  } else {
    int g;
    l.cube_sz = static_cast<float>(svox::ipow(st.N, depth + 1));
    l.fx = st.chain(x, depth + 1, g);
    l.fy = st.chain(y, depth + 1, g);
    l.fz = st.chain(z, depth + 1, g);
  }
  return l;
}


constexpr int kFhLoop = !S::kBaked && !svox::kInterp ? 1 : 0;
constexpr int kFhPath = 0;
constexpr bool kFhTop = false;
constexpr int kFhReuse = S::kBaked ? 1 : 2;
static_assert(kFhPath != 2 || !svox::kInterp || kFhReuse < 2,
              "the corners' path-started descents need the own descent's whole path (kFhPath 1)");

// What a ray's lookups carry from sample to sample (templates on the
// structure T = S, so that only the instance's own members compile).
template <class T>
struct FhCarry;
template <>
struct FhCarry<svox::TreeWalk> {
  svox::TreeWalk::Keep keep;
  svox::Leaf prev;
  int32_t node_leaf, node_up;  // kFhPath 2: the nodes of the kept leaf's level and the one above
};
template <>
struct FhCarry<svox::Baked> {
  svox::Baked::Keep keep;
  Trail trail;
};

template <class T>
__device__ __forceinline__ void fh_init(const T& st, FhCarry<T>& c) {
  if constexpr (!T::kBaked) {
    c.keep.level = st.n_levels;
    c.node_up = -1;
    if constexpr (kFhPath == 1 || (svox::kInterp && kFhReuse > 0)) c.keep.path = path_slot<T>();
  } else {
    c.trail = {-1, 0, -1, 0};
  }
}

// kFhPath 2: TreeWalk::lookup_next with the nodes of the kept leaf's level
// and of the level above it in registers (c.node_leaf, c.node_up): a point
// whose digits part from the kept cell's at either level starts there,
// any other descends from the root. lookup(x, y, z) bit for bit.
__device__ __forceinline__ svox::Leaf lookup_next_reg(const svox::TreeWalk& st, float x, float y, float z,
                                                      FhCarry<svox::TreeWalk>& c) {
  svox::TreeWalk::Keep& k = c.keep;
  x = svox::clamp_coord(x);
  y = svox::clamp_coord(y);
  z = svox::clamp_coord(z);
  const int N = st.N;
  const int L = __ffs(N) - 1;
  int m = 0;
  int32_t node = 0, up = -1;  // up: the node of the level above the leaf's, -1 where unknown
  unsigned px = 0, py = 0, pz = 0;
  const int sh = L * (k.level + 1);
  if ((N & (N - 1)) == 0 && k.level < st.n_levels && sh <= 30) {
    px = svox::pow2_cell(x, sh);
    py = svox::pow2_cell(y, sh);
    pz = svox::pow2_cell(z, sh);
    const unsigned diff = (px ^ static_cast<unsigned>(k.cx)) | (py ^ static_cast<unsigned>(k.cy)) |
                          (pz ^ static_cast<unsigned>(k.cz));
    if (diff == 0) {
      svox::Leaf l;
      l.flat = c.prev.flat;
      l.row = c.prev.row;
      l.cube_sz = c.prev.cube_sz;
      const float sx = x * l.cube_sz, sy = y * l.cube_sz, sz = z * l.cube_sz;
      l.fx = sx - floorf(sx);
      l.fy = sy - floorf(sy);
      l.fz = sz - floorf(sz);
      return l;
    }
    const int bits = 32 - __clz(diff);
    const int part = k.level + 1 - (bits + L - 1) / L;
    if (part >= 1 && part == k.level) {
      m = part;
      node = c.node_leaf;
      up = c.node_up;
    } else if (part >= 1 && part == k.level - 1 && c.node_up >= 0) {
      m = part;
      node = c.node_up;
    }
    if (m > 0) {
      const float nm = __int_as_float((L * m + 127) << 23);
      x = x * nm;
      y = y * nm;
      z = z * nm;
      x = x - floorf(x);
      y = y - floorf(y);
      z = z - floorf(z);
    }
  }
  const int drop = L * (k.level + 1 - m);
  k.cx = m > 0 ? static_cast<int>(px >> drop) : 0;
  k.cy = m > 0 ? static_cast<int>(py >> drop) : 0;
  k.cz = m > 0 ? static_cast<int>(pz >> drop) : 0;
  const float Nf = static_cast<float>(N);
  const float hi = static_cast<float>(N - 1);
  float cube = m > 0 ? __int_as_float((L * (m + 1) + 127) << 23) : Nf;
  int32_t leaf = 0;
  k.level = st.n_levels;
  for (int lvl = m; lvl < st.n_levels; ++lvl) {
    const int u = svox::level_step(x, Nf, hi);
    const int v = svox::level_step(y, Nf, hi);
    const int w = svox::level_step(z, Nf, hi);
    k.cx = k.cx * N + u;
    k.cy = k.cy * N + v;
    k.cz = k.cz * N + w;
    const int32_t flat = ((node * N + u) * N + v) * N + w;
    const int32_t skip = __ldg(st.child + flat);
    if (skip == 0) {
      leaf = flat;
      k.level = lvl;
      break;
    }
    up = node;
    node += skip;
    cube *= Nf;
  }
  c.node_leaf = node;
  c.node_up = up;
  svox::Leaf l{leaf, cube, x, y, z};
  l.row = __ldg(st.data + leaf);
  c.prev = l;
  return l;
}

// The leaf of a ray's sample at t, by the instance's levers.
template <class T>
__device__ __forceinline__ svox::Leaf fh_leaf(const T& st, const Ray& r, float t, FhCarry<T>& c) {
  float x, y, z;
  svox::sample_pos(r, t, x, y, z);
  if constexpr (!T::kBaked && kFhPath == 1) {
    c.prev = lookup_next(st, x, y, z, c.keep, c.prev);
    return c.prev;
  } else if constexpr (!T::kBaked && kFhPath == 2) {
    return lookup_next_reg(st, x, y, z, c);
  } else if constexpr (svox::kInterp && kFhReuse > 0) {
    return st.lookup_keep(x, y, z, c.keep);
  } else if constexpr (T::kBaked && kFhTop) {
    return lookup_trail(st, x, y, z, c.trail);
  } else {
    return st.lookup(x, y, z);
  }
}

// The sigma of the sample at t whose own lookup found l (sample_at's).
template <class T>
__device__ __forceinline__ float fh_sigma(const March& m, const Ray& r, float t, const svox::Leaf& l,
                                          const FhCarry<T>& c) {
  if constexpr (svox::kInterp) {
    svox::Corners cn;
    if constexpr (kFhReuse > 0) {
      cn = svox::corners_keep<kFhReuse>(m.st, r, t, l, c.keep, m.M);
    } else {
      cn = svox::sample_corners(m.st, r, t, l.cube_sz, m.M);
    }
    return svox::interp_sum(cn, [&](int32_t row) {
      return svox::ld(m.features + static_cast<size_t>(row) * m.D + m.D - 1);
    });
  } else {
    return static_cast<uint32_t>(l.row) < static_cast<uint32_t>(m.M)
               ? svox::ld(m.features + static_cast<size_t>(l.row) * m.D + m.D - 1)
               : 0.f;
  }
}

struct FirstHitParams {
  March m;
  float sigma_thresh;
  bool* found;     // (B,)
  float* t_hit;    // (B,)
  int32_t* row;    // (B,)
  float* frac;     // (B, 3)
};

__global__ void __launch_bounds__(kThreads) first_hit_kernel(const FirstHitParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.m.B) return;
  bool found = false, found_t = false, same = false;
  float t_hit = 0.f, fx = 0.f, fy = 0.f, fz = 0.f;
  int32_t row = 0;
  Ray r;
  if (setup_ray(p.m, i, r)) {
    FhCarry<S> c;
    fh_init(p.m.st, c);
    float t = r.tmin;
    // A sample over the threshold: its t, and where it is resident, the hit.
    auto over = [&](const svox::Leaf& l, float ts) {
      const bool first = !found_t;
      if (first) {
        found_t = true;
        t_hit = ts;
      }
      if (static_cast<uint32_t>(l.row) < static_cast<uint32_t>(p.m.M)) {
        found = true;
        same = first;
        row = l.row;
        fx = l.fx;
        fy = l.fy;
        fz = l.fz;
        return true;
      }
      return false;
    };
    if constexpr (kFhLoop == 0) {
      for (int step = 0; step < p.m.max_steps; ++step) {
        const svox::Leaf l = fh_leaf(p.m.st, r, t, c);
        const float dt = svox::step_dt(p.m.st, l, r, p.m.step_size);
        if (fh_sigma(p.m, r, t, l, c) > p.sigma_thresh && over(l, t)) break;
        t = t + dt;
        if (!(t < r.tmax)) break;
      }
    } else {
      svox::Leaf l = fh_leaf(p.m.st, r, t, c);
      for (int step = 0; step < p.m.max_steps; ++step) {
        const float dt = svox::step_dt(p.m.st, l, r, p.m.step_size);
        const float sigma = fh_sigma(p.m, r, t, l, c);
        const float t_next = t + dt;
        const bool more = step + 1 < p.m.max_steps && t_next < r.tmax;
        svox::Leaf next;
        if constexpr (kFhLoop == 2) {
          if (more) next = fh_leaf(p.m.st, r, t_next, c);
        }
        if (sigma > p.sigma_thresh && over(l, t)) break;
        if (!more) break;
        t = t_next;
        if constexpr (kFhLoop == 2) {
          l = next;
        } else {
          l = fh_leaf(p.m.st, r, t, c);
        }
      }
    }
    if (found && !same) {
      // sigma_thresh < 0: t_hit lies before the resident sample.
      float x, y, z;
      svox::sample_pos(r, t_hit, x, y, z);
      const svox::Leaf leaf = p.m.st.lookup(x, y, z);
      fx = leaf.fx;
      fy = leaf.fy;
      fz = leaf.fz;
    }
  }
  p.found[i] = found;
  p.t_hit[i] = t_hit;
  p.row[i] = row;
  p.frac[3 * i + 0] = fx;
  p.frac[3 * i + 1] = fy;
  p.frac[3 * i + 2] = fz;
}

