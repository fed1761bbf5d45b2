// K13a and K13b: the tape recorder's walks, and K15, the cost walk of the
// ray schedules, on either structure. Included by tape_record.cu (the tree
// walk: svox_tape_stage, svox_tape_copy, svox_tape_count, svox_tape_record,
// svox_march_cost) and tape_record_baked.cu (the bake: the same names with
// _baked), which define SVOX_STRUCTURE and SVOX_SUFFIX first.
//
// Replaces: svox_t_tpu/ops/tape.py `_count_samples` (K13a) and
// `_record_chunks` (K13b). The TPU version recorded rays sorted by sample
// count into (S, C) chunk tables, K-sample rounds at a time, and compacted
// each column with a stable sort; here the layout is SIMT: rays in input
// order, each ray's samples one run in a flat buffer at offsets[i] (the
// cumulative sum of the counts).
//
// Every kernel walks a ray exactly as K2 (render_fwd.cuh) does, taking every
// step and not only the compositing ones: svox::setup_ray, march_cull (the
// bake's occupied-box cull and, in fast mode, its box advance), then per
// sample svox::sample_leaf (the lookup and the step, skip boxes included),
// t = t + dt, and out at t >= tmax or max_steps samples. None stops
// early: the stop is a replay-time decision. A hit ray takes its first
// sample at tmin, as K2 does. The library is built with -fmad=false, so the
// recorded t-chain is K2's bit for bit, and a replay that composites the
// recorded samples in order equals K2 bit for bit.
//
// The recording (ops/tape.py `record_tape`) walks each ray once:
//  * stage_kernel (K13a+K13b) writes per ray the occupied count (rows r
//    with 0 <= r < n_rows), the total count and delta_scale, and stages the
//    ray's recorded samples (every one, or with `compact` the occupied
//    ones) in an arena of chunks of kChunk entries: a ray takes a chunk
//    when its sample k has k % kChunk == 0, the lanes that take one at the
//    same step with one atomicAdd on the chunk counter (warp-aggregated),
//    and writes the chunk's owner (ray, k / kChunk). Each entry holds the
//    sample's row, step, leaf cell (unresolved: the bake's src_map is read
//    by the copy, off the walk's chain) and t, each stream only if wanted.
//    A thread holds kFlush entries of each stream in registers and stores
//    them at once, so every sector of the arena is written whole, in two
//    16-byte stores (a store a sample, as the earlier record walk stores
//    into each ray's run, writes a sector 4 bytes at a time). A chunk past
//    the arena's capacity is counted and not written: the counter then
//    says how many the launch needed;
//  * the wrapper forms the offsets from the counts (a cumsum) and reads
//    the tape's size, the longest run and the chunk count in one host
//    copy; if the arena was short, it reruns the launch with that
//    capacity (the walk counting the size and the longest run itself, a
//    warp-level sum and max and an atomic each beside the chunk counter,
//    was slower on the bake and the rig: PERF.md §6);
//  * copy_kernel moves the staged entries into the tape's runs, a thread
//    an arena entry: chunk c's entry e is the ray's sample
//    ord * kChunk + e, stored at offsets[ray] + ord * kChunk + e, so a
//    warp's loads are one chunk of the arena and its stores one run of up
//    to kChunk entries; the cell stream resolves its leaf cells here.
// The tape is the earlier two walks' bit for bit: the samples are the same
// walk's, each at the same place in its run.
//
// Bound on an H100: latency, as K2 (a dependent lookup chain per sample,
// no feature row read). The walk stores 8-16 bytes a recorded sample into
// its ray's chunk; the copy reads and writes each once. One thread per ray,
// small blocks, so enough warps are resident to hide the chains. The
// earlier design walked each ray twice: count_kernel (the counts) and then
// record_kernel (each ray's run at offsets[i], written in the walk); both
// stay for direct callers (ops/tape.py `count_samples_cuda`,
// `record_samples_cuda`) and the designs the A/B tool times them against
// (tools/tape_record_ab.py, tools/tape_record_designs.cuh, PERF.md §6).
// The optional streams and `compact` are template parameters of the new
// kernels, one instance per combination record_tape launches.
//
// K15 replaces svox_t_tpu/ops/schedule.py `march_cost`: per ray the number
// of steps of the same walk (K13a's total), capped at max_steps, the cost
// a plan sorts rays by. Two differences from K13a, both JAX's: under
// `interp` (a run-time flag, tested once per ray; these units compile
// without kInterp) the cull and the box advance are off, and a hit ray
// with tmin >= tmax takes no step. With a sigma column (float32, one value
// per row; given only when stop_thresh > 0) the walk also carries the
// transmittance, L *= exp(-dt * delta_scale * sigma) on each occupied
// sample whose sigma exceeds sigma_thresh, and the ray retires after the
// step whose L is at most stop_thresh; that step is counted. Writes one
// int32 a ray. Bound as K13a, plus one dependent sigma load per occupied
// sample in the predicted-stop mode.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <class S>
struct Params {
  S st;
  const float* origins;
  const float* dirs;
  int B;
  const float* offset;
  const float* scaling;
  int n_rows;
  float step_size;
  int max_steps;
  int32_t* n_occ;           // K13a
  int32_t* n_tot;
  const int32_t* offsets;   // K13b: (B + 1,) run starts
  int compact;
  int32_t* idx;             // null on a data-indirect tape
  float* dt;
  int32_t* cell;            // null unless cells are recorded
  float* tval;              // null unless t is recorded
  float* dscale;
};

// Walk ray i as K2 does, calling f(leaf, t, dt) at every sample. False for
// a ray that misses (the cube or, on the bake, the occupied box); r holds
// the ray's setup either way.
template <class S, class F>
__device__ __forceinline__ bool walk(const Params<S>& p, int i, svox::Ray& r, F&& f) {
  const bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  if (!svox::march_cull(p.st, r, hit)) return false;
  float t = r.tmin;
  for (int step = 0; step < p.max_steps; ++step) {
    float dt;
    const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
    f(leaf, t, dt);
    t = t + dt;
    if (!(t < r.tmax)) break;
  }
  return true;
}

template <class S>
__device__ __forceinline__ bool occupied(const Params<S>& p, const svox::Leaf& leaf) {
  return static_cast<uint32_t>(leaf.row) < static_cast<uint32_t>(p.n_rows);
}

template <class S>
__global__ void __launch_bounds__(kThreads) count_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t occ = 0, tot = 0;
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float, float) {
    ++tot;
    if (occupied(p, leaf)) ++occ;
  });
  p.n_occ[i] = occ;
  p.n_tot[i] = tot;
}

template <class S>
__global__ void __launch_bounds__(kThreads) record_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t k = p.offsets[i];
  const int32_t end = p.offsets[i + 1];
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float dt) {
    if ((p.compact && !occupied(p, leaf)) || k >= end) return;
    if (p.idx != nullptr) p.idx[k] = leaf.row;
    p.dt[k] = dt;
    if (p.cell != nullptr) p.cell[k] = p.st.tree_cell(leaf.flat);
    if (p.tval != nullptr) p.tval[k] = t;
    ++k;
  });
  p.dscale[i] = r.ds;
}

// K15's arguments beside the walk's.
template <class S>
struct CostParams {
  Params<S> w;
  int interp;
  float sigma_thresh;
  float stop_thresh;
  const float* sigmas;  // null: no stop prediction
  int32_t* cost;
};

template <class S>
__global__ void __launch_bounds__(kThreads) cost_kernel(const CostParams<S> c) {
  const Params<S>& p = c.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  svox::Ray r;
  bool hit = svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r);
  if (!c.interp) hit = p.st.cull(r, hit);
  int32_t n = 0;
  if (hit && r.tmin < r.tmax) {
    const bool stop = c.sigmas != nullptr;
    float t = r.tmin, L = 1.f;
    while (n < p.max_steps) {
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      if (stop && occupied(p, leaf)) {
        const float sig = __ldg(c.sigmas + leaf.row);
        if (sig > c.sigma_thresh) L = L * expf((-dt * r.ds) * sig);
      }
      t = t + dt;
      ++n;
      if (!(t < r.tmax)) break;
      if (stop && !(L > c.stop_thresh)) break;
    }
  }
  c.cost[i] = n;
}

// K13a+K13b: the arena's chunk, in entries (ops/tape.py ARENA_CHUNK): 128
// bytes of a stream, a line; a thread holds kFlush entries of each stream
// (a 32-byte sector) in registers and stores them at once, in 16-byte
// vectors.
constexpr int kChunk = 32;
constexpr int kFlush = 8;
static_assert(kChunk % kFlush == 0 && kFlush % 4 == 0, "a flush is whole vectors within a chunk");

// kFlush 32-bit entries of one stream, in registers.
struct Flush {
  uint32_t v[kFlush];
  __device__ __forceinline__ void set(int f, uint32_t x) {
#pragma unroll
    for (int u = 0; u < kFlush; ++u) v[u] = u == f ? x : v[u];
  }
  __device__ __forceinline__ void store(void* dst) const {
#pragma unroll
    for (int u = 0; u < kFlush; u += 4)
      reinterpret_cast<uint4*>(dst)[u / 4] = make_uint4(v[u], v[u + 1], v[u + 2], v[u + 3]);
  }
};

// The fused walk's arguments: the walk's (w, its n_occ, n_tot, dscale),
// the chunk counter (zeroed by the caller) and the arena's capacity, each
// chunk's owner (ray, ordinal), and the arena's streams, capacity * kChunk
// entries each (null: not recorded; flat holds leaf cells).
template <class S>
struct StageParams {
  Params<S> w;
  int32_t* n_chunks;
  int capacity;
  int2* owner;
  int32_t* idx;
  float* dt;
  int32_t* flat;
  float* tval;
};

// A chunk for ray `ray`'s entries ord * kChunk onwards: the lanes that ask
// at the same time take consecutive chunks with one atomicAdd.
template <class S>
__device__ __forceinline__ int32_t take_chunk(const StageParams<S>& a, int ray, int ord) {
  const unsigned group = __activemask();
  const int lane = threadIdx.x % 32;
  const int leader = __ffs(group) - 1;
  int32_t base = 0;
  if (lane == leader) base = atomicAdd(a.n_chunks, __popc(group));
  base = __shfl_sync(group, base, leader);
  const int32_t c = base + __popc(group & ((1u << lane) - 1u));
  if (c < a.capacity) a.owner[c] = make_int2(ray, ord);
  return c;
}

// The copy's arguments: the structure (its tree cells), the staged
// entries (n_chunks * kChunk) and chunk owners, the tape's offsets and
// its streams (null: not recorded; then the arena's is null too).
template <class S>
struct CopyParams {
  S st;
  int n_entries;
  const int2* owner;
  const int32_t* offsets;
  const int32_t* a_idx;
  const float* a_dt;
  const int32_t* a_flat;
  const float* a_t;
  int32_t* idx;
  float* dt;
  int32_t* cell;
  float* tval;
};

template <class S, bool kIdx, bool kCell, bool kT>
__global__ void __launch_bounds__(kThreads) copy_kernel(const CopyParams<S> a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.n_entries) return;
  const int2 o = __ldg(a.owner + q / kChunk);
  const int32_t start = __ldg(a.offsets + o.x);
  const int32_t j = o.y * kChunk + q % kChunk;
  if (j >= __ldg(a.offsets + o.x + 1) - start) return;
  const int32_t d = start + j;
  if constexpr (kIdx) a.idx[d] = __ldg(a.a_idx + q);
  a.dt[d] = __ldg(a.a_dt + q);
  if constexpr (kCell) a.cell[d] = a.st.tree_cell(__ldg(a.a_flat + q));
  if constexpr (kT) a.tval[d] = __ldg(a.a_t + q);
}

// K13a+K13b: walk ray i once; its counts, delta_scale and staged samples.
template <class S, bool kCompact, bool kIdx, bool kCell, bool kT>
__global__ void __launch_bounds__(kThreads) stage_kernel(const StageParams<S> a) {
  const Params<S>& p = a.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  int32_t occ = 0, tot = 0, k = 0, chunk = 0;
  Flush b_idx, b_dt, b_flat, b_t;
  // Entries e0 .. e0 + kFlush - 1 of the current chunk (past a ray's last
  // sample they hold what the registers held: the copy never reads them).
  auto flush = [&](int e0) {
    if (chunk >= a.capacity) return;
    const int32_t q = chunk * kChunk + e0;
    if constexpr (kIdx) b_idx.store(a.idx + q);
    b_dt.store(a.dt + q);
    if constexpr (kCell) b_flat.store(a.flat + q);
    if constexpr (kT) b_t.store(a.tval + q);
  };
  svox::Ray r;
  walk(p, i, r, [&](const svox::Leaf& leaf, float t, float dt) {
    ++tot;
    const bool is_occ = occupied(p, leaf);
    occ += is_occ;
    if (kCompact && !is_occ) return;
    const int e = k % kChunk;
    if (e == 0) chunk = take_chunk(a, i, k / kChunk);
    const int f = e % kFlush;
    if constexpr (kIdx) b_idx.set(f, static_cast<uint32_t>(leaf.row));
    b_dt.set(f, __float_as_uint(dt));
    if constexpr (kCell) b_flat.set(f, static_cast<uint32_t>(leaf.flat));
    if constexpr (kT) b_t.set(f, __float_as_uint(t));
    if (f == kFlush - 1) flush(e - f);
    ++k;
  });
  if (k % kFlush != 0) flush((k - 1) % kChunk - (k - 1) % kFlush);
  p.n_occ[i] = occ;
  p.n_tot[i] = tot;
  p.dscale[i] = r.ds;
}

// The instances record_tape launches: every stream choice but neither the
// row nor the cell stream; flags (compact, idx, cell, t) pick one.
template <class S, bool... kB>
cudaError_t launch_stage(const StageParams<S>& a, const bool* flags, cudaStream_t stream) {
  if constexpr (sizeof...(kB) < 4) {
    return flags[sizeof...(kB)] ? launch_stage<S, kB..., true>(a, flags, stream)
                                : launch_stage<S, kB..., false>(a, flags, stream);
  } else {
    constexpr bool kI[] = {kB...};
    if constexpr (!kI[1] && !kI[2]) {
      return cudaErrorInvalidValue;
    } else {
      stage_kernel<S, kB...><<<(a.w.B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
}

template <class S, bool... kB>
cudaError_t launch_copy(const CopyParams<S>& a, const bool* flags, cudaStream_t stream) {
  if constexpr (sizeof...(kB) < 3) {
    return flags[sizeof...(kB)] ? launch_copy<S, kB..., true>(a, flags, stream)
                                : launch_copy<S, kB..., false>(a, flags, stream);
  } else {
    constexpr bool kI[] = {kB...};
    if constexpr (!kI[0] && !kI[1]) {
      return cudaErrorInvalidValue;
    } else {
      copy_kernel<S, kB...><<<(a.n_entries + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
}

template <class S>
Params<S> make_params(const svox::StructDesc* s, const float* origins, const float* dirs, int B,
                      const float* offset, const float* scaling, int n_rows, float step_size,
                      int max_steps) {
  Params<S> p{};
  p.st = S::from(*s);
  p.origins = origins;
  p.dirs = dirs;
  p.B = B;
  p.offset = offset;
  p.scaling = scaling;
  p.n_rows = n_rows;
  p.step_size = step_size;
  p.max_steps = max_steps;
  return p;
}

}  // namespace

// K13a. s: the structure (svox::StructDesc, host memory); rays (B, 3) f32:
// origins, dirs (world space); offset/scaling (3,) f32; n_rows the pool's
// row count (rows below it are occupied); n_occ, n_tot (B,) int32 out. All
// pointers but s are device pointers. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_count)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, int n_rows, float step_size, int max_steps,
    int32_t* n_occ, int32_t* n_tot, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  Params<S> p = make_params<S>(s, origins, dirs, B, offset, scaling, n_rows, step_size, max_steps);
  p.n_occ = n_occ;
  p.n_tot = n_tot;
  count_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K13b. As svox_tape_count, plus offsets (B + 1,) int32 (each ray's run
// start; offsets[B] the total), compact (record only occupied samples),
// and the flat outputs: idx (int32, or null on a data-indirect tape), dt
// (f32), cell (int32 tree cells, or null), tval (f32, or null), each of
// offsets[B] entries; dscale (B,) f32. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_record)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, int n_rows, float step_size, int max_steps,
    const int32_t* offsets, int compact, int32_t* idx, float* dt, int32_t* cell, float* tval,
    float* dscale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  Params<S> p = make_params<S>(s, origins, dirs, B, offset, scaling, n_rows, step_size, max_steps);
  p.offsets = offsets;
  p.compact = compact;
  p.idx = idx;
  p.dt = dt;
  p.cell = cell;
  p.tval = tval;
  p.dscale = dscale;
  record_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K15. As svox_tape_count, plus interp (nonzero: no cull and no box
// advance), sigma_thresh and stop_thresh, sigmas (n_rows float32 density
// values, or null: the walk then never stops early), and cost (B,) int32
// out: each ray's step count, at most max_steps. Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_march_cost)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, int n_rows, float step_size, int max_steps,
    int interp, float sigma_thresh, float stop_thresh, const float* sigmas, int32_t* cost,
    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  CostParams<S> c{};
  c.w = make_params<S>(s, origins, dirs, B, offset, scaling, n_rows, step_size, max_steps);
  c.interp = interp;
  c.sigma_thresh = sigma_thresh;
  c.stop_thresh = stop_thresh;
  c.sigmas = sigmas;
  c.cost = cost;
  cost_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(c);
  return cudaGetLastError();
}

// K13a+K13b, the walk. As svox_tape_count, plus compact (stage only the
// occupied samples), dscale (B,) f32 out, n_chunks (one int32 on the card,
// zeroed by the caller: the chunks the launch needed), capacity (chunks the
// arena holds), owner (capacity, 2) int32, and the arena's streams, each
// capacity * 32 entries, 16-byte aligned: idx (int32, or null), dt (f32),
// flat (int32 leaf cells, or null), tval (f32, or null). Returns a
// cudaError_t.
extern "C" int SVOX_NAME(svox_tape_stage)(
    const svox::StructDesc* s, const float* origins, const float* dirs, int B,
    const float* offset, const float* scaling, int n_rows, float step_size, int max_steps,
    int compact, int32_t* n_occ, int32_t* n_tot, float* dscale, int32_t* n_chunks, int capacity,
    int32_t* owner, int32_t* idx, float* dt, int32_t* flat, float* tval, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  StageParams<S> a{};
  a.w = make_params<S>(s, origins, dirs, B, offset, scaling, n_rows, step_size, max_steps);
  a.w.n_occ = n_occ;
  a.w.n_tot = n_tot;
  a.w.dscale = dscale;
  a.n_chunks = n_chunks;
  a.capacity = capacity;
  a.owner = reinterpret_cast<int2*>(owner);
  a.idx = idx;
  a.dt = dt;
  a.flat = flat;
  a.tval = tval;
  const bool flags[] = {compact != 0, idx != nullptr, flat != nullptr, tval != nullptr};
  return launch_stage<S>(a, flags, stream);
}

// K13a+K13b, the copy. s the structure; n_chunks the chunks staged (at
// most the arena's capacity); owner and the arena's streams as
// svox_tape_stage wrote them; offsets (B + 1,) int32; the tape's streams,
// each offsets[B] entries: idx (int32, or null), dt (f32), cell (int32 tree
// cells, or null), tval (f32, or null), each null where the arena's is.
// Returns a cudaError_t.
extern "C" int SVOX_NAME(svox_tape_copy)(
    const svox::StructDesc* s, int n_chunks, const int32_t* owner, const int32_t* a_idx,
    const float* a_dt, const int32_t* a_flat, const float* a_t, const int32_t* offsets,
    int32_t* idx, float* dt, int32_t* cell, float* tval, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_chunks <= 0) return cudaSuccess;
  using S = SVOX_STRUCTURE;
  CopyParams<S> a{};
  a.st = S::from(*s);
  a.n_entries = n_chunks * kChunk;
  a.owner = reinterpret_cast<const int2*>(owner);
  a.offsets = offsets;
  a.a_idx = a_idx;
  a.a_dt = a_dt;
  a.a_flat = a_flat;
  a.a_t = a_t;
  a.idx = idx;
  a.dt = dt;
  a.cell = cell;
  a.tval = tval;
  const bool flags[] = {idx != nullptr, cell != nullptr, tval != nullptr};
  return launch_copy<S>(a, flags, stream);
}
