// Designs of K13a+K13b, the tape recorder's walks (csrc/tape_record.cuh),
// that lost to the shipped one on an H100 (PERF.md §6,
// tools/tape_record_ab.py). tools/tape_record_ab.py includes this file in
// tape_record.cuh just before `stage_kernel`, inside the header's anonymous
// namespace, and launches a design in place of the shipped kernel; it is
// not part of the library.
//
//  * runtime: the shipped fused walk and copy with `compact` and the
//    optional streams as run-time tests a sample, one instance for every
//    launch (launch_stage_runtime, launch_copy_runtime);
//  * scalar: the shipped fused walk storing each sample's entries into its
//    chunk as it walks, 4 bytes a stream, with no registers held
//    (launch_stage_scalar);
//  * loop1: the shipped fused walk on a rotated loop, the next sample's
//    lookup at the end of a step (walk_rotated, patched into stage_kernel);
//  * warp: arena layout (i), chunks of kChunk steps x 32 lanes a warp,
//    lane-minor, so that the lanes of a step store to neighbouring
//    addresses; the warp walks its rays in step (a vote a step) and takes
//    a chunk when one of its lanes reaches the chunk's first entry, the
//    chunk numbers kept in shared memory; a chunk's owner is (warp,
//    ordinal), and the copy moves entry (e, lane) of chunk (w, j) to ray
//    32 w + lane's sample j * kChunk + e (launch_stage_warp,
//    launch_copy_warp: the tool passes offsets padded to a multiple of 32
//    rays and an arena of capacity * kChunk * 32 entries);
//  * stop: the earlier pair with record_kernel's walk ending, in compact
//    mode, at the ray's last occupied sample (record_stop_kernel);
//  * resume: stop, and count_kernel also saving each ray's walk state (t,
//    step) at its first occupied sample, 8 bytes a ray, where the compact
//    record walk starts (count_resume_kernel, record_resume_kernel; the
//    state in a buffer of this file's, resume_buffer).

#pragma once

// ---------------------------------------------------------------------
// runtime and scalar

template <class S>
__global__ void __launch_bounds__(kThreads) stage_runtime_kernel(const StageParams<S> a, int compact) {
  const Params<S>& p = a.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t occ = 0, tot = 0, k = 0, chunk = 0;
  Flush b_idx, b_dt, b_flat, b_t;
  auto flush = [&](int e0) {
    if (chunk >= a.capacity) return;
    const int32_t q = chunk * kChunk + e0;
    if (a.idx != nullptr) b_idx.store(a.idx + q);
    b_dt.store(a.dt + q);
    if (a.flat != nullptr) b_flat.store(a.flat + q);
    if (a.tval != nullptr) b_t.store(a.tval + q);
  };
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float dt) {
    ++tot;
    const bool is_occ = occupied(p, leaf);
    occ += is_occ;
    if (compact && !is_occ) return;
    const int e = k % kChunk;
    if (e == 0) chunk = take_chunk(a, i, k / kChunk);
    const int f = e % kFlush;
    if (a.idx != nullptr) b_idx.set(f, static_cast<uint32_t>(leaf.row));
    b_dt.set(f, __float_as_uint(dt));
    if (a.flat != nullptr) b_flat.set(f, static_cast<uint32_t>(leaf.flat));
    if (a.tval != nullptr) b_t.set(f, __float_as_uint(t));
    if (f == kFlush - 1) flush(e - f);
    ++k;
  });
  if (k % kFlush != 0) flush((k - 1) % kChunk - (k - 1) % kFlush);
  p.n_occ[i] = occ;
  p.n_tot[i] = tot;
  p.dscale[i] = r.ds;
}

// scalar: a store a sample into the ray's chunk.
template <class S, bool kCompact, bool kIdx, bool kCell, bool kT>
__global__ void __launch_bounds__(kThreads) stage_scalar_kernel(const StageParams<S> a) {
  const Params<S>& p = a.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t occ = 0, tot = 0, k = 0, chunk = 0;
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float dt) {
    ++tot;
    const bool is_occ = occupied(p, leaf);
    occ += is_occ;
    if (kCompact && !is_occ) return;
    const int e = k % kChunk;
    if (e == 0) chunk = take_chunk(a, i, k / kChunk);
    if (chunk < a.capacity) {
      const int32_t q = chunk * kChunk + e;
      if constexpr (kIdx) a.idx[q] = leaf.row;
      a.dt[q] = dt;
      if constexpr (kCell) a.flat[q] = leaf.flat;
      if constexpr (kT) a.tval[q] = t;
    }
    ++k;
  });
  p.n_occ[i] = occ;
  p.n_tot[i] = tot;
  p.dscale[i] = r.ds;
}

template <class S, bool... kB>
cudaError_t launch_stage_scalar(const StageParams<S>& a, const bool* flags, cudaStream_t stream) {
  if constexpr (sizeof...(kB) < 4) {
    return flags[sizeof...(kB)] ? launch_stage_scalar<S, kB..., true>(a, flags, stream)
                                : launch_stage_scalar<S, kB..., false>(a, flags, stream);
  } else {
    constexpr bool kI[] = {kB...};
    if constexpr (!kI[1] && !kI[2]) {
      return cudaErrorInvalidValue;
    } else {
      stage_scalar_kernel<S, kB...><<<(a.w.B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads) copy_runtime_kernel(const CopyParams<S> a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_entries) return;
  const int2 o = __ldg(a.owner + q / kChunk);
  const int32_t start = __ldg(a.offsets + o.x);
  const int32_t j = o.y * kChunk + q % kChunk;
  if (j >= __ldg(a.offsets + o.x + 1) - start) return;
  const int32_t d = start + j;
  if (a.idx != nullptr) a.idx[d] = __ldg(a.a_idx + q);
  a.dt[d] = __ldg(a.a_dt + q);
  if (a.cell != nullptr) a.cell[d] = a.st.tree_cell(__ldg(a.a_flat + q));
  if (a.tval != nullptr) a.tval[d] = __ldg(a.a_t + q);
}

template <class S>
cudaError_t launch_stage_runtime(const StageParams<S>& a, const bool* flags, cudaStream_t stream) {
  stage_runtime_kernel<S><<<(a.w.B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, flags[0]);
  return cudaGetLastError();
}

template <class S>
cudaError_t launch_copy_runtime(const CopyParams<S>& a, const bool*, cudaStream_t stream) {
  copy_runtime_kernel<S><<<(a.n_entries + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// loop1

template <class S, class F>
__device__ __forceinline__ bool walk_rotated(const Params<S>& p, int i, svox::Ray& r, F&& f) {
  const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  if (!svox::march_cull(p.st, r, hit)) return false;
  float t = r.tmin, x, y, z;
  svox::sample_pos(r, t, x, y, z);
  svox::Leaf leaf = p.st.lookup(x, y, z);
  for (int step = 0; step < p.max_steps; ++step) {
    const float dt = svox::step_dt(p.st, leaf, r, p.step_size);
    const float t_next = t + dt;
    const bool more = step + 1 < p.max_steps && t_next < r.tmax;
    f(leaf, t, dt);
    if (!more) break;
    t = t_next;
    svox::sample_pos(r, t, x, y, z);
    leaf = p.st.lookup(x, y, z);
  }
  return true;
}

// ---------------------------------------------------------------------
// warp: layout (i)

constexpr unsigned kAll = 0xffffffffu;

template <class S, bool kCompact, bool kIdx, bool kCell, bool kT>
__global__ void __launch_bounds__(kThreads) stage_warp_kernel(const StageParams<S> a, int max_chunks) {
  extern __shared__ int32_t s_chunks[];
  const Params<S>& p = a.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int w = i / 32;
  int32_t* chunks = s_chunks + (threadIdx.x / 32) * max_chunks;
  svox::Ray r;
  bool live = false;
  if (i < p.B) {
    const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
    live = svox::march_cull(p.st, r, hit);
  }
  float t = live ? r.tmin : 0.f;
  int32_t occ = 0, tot = 0, k = 0, nch = 0;
  int step = 0;
  while (__any_sync(kAll, live)) {
    bool store = false;
    svox::Leaf leaf{};
    float dt = 0.f;
    if (live) {
      leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      ++tot;
      const bool is_occ = occupied(p, leaf);
      occ += is_occ;
      store = !kCompact || is_occ;
    }
    if (__any_sync(kAll, store && k == nch * kChunk)) {
      if (lane == 0) {
        const int32_t c = atomicAdd(a.n_chunks, 1);
        chunks[nch] = c;
        if (c < a.capacity) a.owner[c] = make_int2(w, nch);
      }
      __syncwarp();
      ++nch;
    }
    if (store) {
      const int32_t c = chunks[k / kChunk];
      if (c < a.capacity) {
        const int32_t q = (c * kChunk + k % kChunk) * 32 + lane;
        if constexpr (kIdx) a.idx[q] = leaf.row;
        a.dt[q] = dt;
        if constexpr (kCell) a.flat[q] = leaf.flat;
        if constexpr (kT) a.tval[q] = t;
      }
      ++k;
    }
    if (live) {
      t = t + dt;
      ++step;
      live = step < p.max_steps && t < r.tmax;
    }
  }
  if (i < p.B) {
    p.n_occ[i] = occ;
    p.n_tot[i] = tot;
    p.dscale[i] = r.ds;
  }
}

template <class S, bool kIdx, bool kCell, bool kT>
__global__ void __launch_bounds__(kThreads) copy_warp_kernel(const CopyParams<S> a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_entries) return;
  const int2 o = __ldg(a.owner + q / (kChunk * 32));
  const int ray = o.x * 32 + q % 32;
  const int32_t start = __ldg(a.offsets + ray);
  const int32_t j = o.y * kChunk + (q / 32) % kChunk;
  if (j >= __ldg(a.offsets + ray + 1) - start) return;
  const int32_t d = start + j;
  if constexpr (kIdx) a.idx[d] = __ldg(a.a_idx + q);
  a.dt[d] = __ldg(a.a_dt + q);
  if constexpr (kCell) a.cell[d] = a.st.tree_cell(__ldg(a.a_flat + q));
  if constexpr (kT) a.tval[d] = __ldg(a.a_t + q);
}

template <class S, bool... kB>
cudaError_t launch_stage_warp(const StageParams<S>& a, const bool* flags, cudaStream_t stream) {
  if constexpr (sizeof...(kB) < 4) {
    return flags[sizeof...(kB)] ? launch_stage_warp<S, kB..., true>(a, flags, stream)
                                : launch_stage_warp<S, kB..., false>(a, flags, stream);
  } else {
    constexpr bool kI[] = {kB...};
    if constexpr (!kI[1] && !kI[2]) {
      return cudaErrorInvalidValue;
    } else {
      const int max_chunks = (a.w.max_steps + kChunk - 1) / kChunk;
      const size_t smem = sizeof(int32_t) * max_chunks * (kThreads / 32);
      stage_warp_kernel<S, kB...><<<(a.w.B + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a, max_chunks);
      return cudaGetLastError();
    }
  }
}

template <class S, bool... kB>
cudaError_t launch_copy_warp(const CopyParams<S>& a0, const bool* flags, cudaStream_t stream) {
  if constexpr (sizeof...(kB) < 3) {
    return flags[sizeof...(kB)] ? launch_copy_warp<S, kB..., true>(a0, flags, stream)
                                : launch_copy_warp<S, kB..., false>(a0, flags, stream);
  } else {
    constexpr bool kI[] = {kB...};
    if constexpr (!kI[0] && !kI[1]) {
      return cudaErrorInvalidValue;
    } else {
      CopyParams<S> a = a0;
      a.n_entries = a0.n_entries * 32;
      copy_warp_kernel<S, kB...><<<(a.n_entries + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
}

// ---------------------------------------------------------------------
// stop and resume (the earlier pair)

// Ray i's run, its walk ending in compact mode at its last occupied sample.
template <class S>
__device__ __forceinline__ void record_stop(const Params<S>& p, int i) {
  int32_t k = p.offsets[i];
  const int32_t end = p.offsets[i + 1];
  svox::Ray r;
  const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  if (svox::march_cull(p.st, r, hit)) {
    float t = r.tmin;
    for (int step = 0; step < p.max_steps && !(p.compact && k >= end); ++step) {
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      if (!(p.compact && !occupied(p, leaf)) && k < end) {
        if (p.idx != nullptr) p.idx[k] = leaf.row;
        p.dt[k] = dt;
        if (p.cell != nullptr) p.cell[k] = p.st.tree_cell(leaf.flat);
        if (p.tval != nullptr) p.tval[k] = t;
        ++k;
      }
      t = t + dt;
      if (!(t < r.tmax)) break;
    }
  }
  p.dscale[i] = r.ds;
}

template <class S>
__global__ void __launch_bounds__(kThreads) record_stop_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.B) record_stop(p, i);
}

float2* g_resume = nullptr;
int g_resume_n = 0;

// A buffer of (t, step) for n rays, kept for the process.
float2* resume_buffer(int n) {
  if (n > g_resume_n) {
    if (g_resume != nullptr) cudaFree(g_resume);
    cudaMalloc(&g_resume, sizeof(float2) * n);
    g_resume_n = n;
  }
  return g_resume;
}

template <class S>
__global__ void __launch_bounds__(kThreads) count_resume_kernel(const Params<S> p, float2* resume) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t occ = 0, tot = 0;
  float2 first = make_float2(0.f, __int_as_float(-1));
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float) {
    if (occupied(p, leaf)) {
      if (occ == 0) first = make_float2(t, __int_as_float(tot));
      ++occ;
    }
    ++tot;
  });
  p.n_occ[i] = occ;
  p.n_tot[i] = tot;
  resume[i] = first;
}

template <class S>
__global__ void __launch_bounds__(kThreads) record_resume_kernel(const Params<S> p, const float2* resume) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  if (!p.compact) {
    record_stop(p, i);
    return;
  }
  int32_t k = p.offsets[i];
  const int32_t end = p.offsets[i + 1];
  svox::Ray r;
  const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  const float2 first = resume[i];
  const int step0 = __float_as_int(first.y);
  if (svox::march_cull(p.st, r, hit) && step0 >= 0) {
    float t = first.x;
    for (int step = step0; step < p.max_steps && k < end; ++step) {
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      if (occupied(p, leaf)) {
        if (p.idx != nullptr) p.idx[k] = leaf.row;
        p.dt[k] = dt;
        if (p.cell != nullptr) p.cell[k] = p.st.tree_cell(leaf.flat);
        if (p.tval != nullptr) p.tval[k] = t;
        ++k;
      }
      t = t + dt;
      if (!(t < r.tmax)) break;
    }
  }
  p.dscale[i] = r.ds;
}
