// K13a and K13b: the tape recorder's count and record walks, and K15, the
// cost walk of the ray schedules, on either structure. Included by
// tape_record.cu (the tree walk: svox_tape_count, svox_tape_record,
// svox_march_cost) and tape_record_baked.cu (the bake: the same names with
// _baked), which define SVOX_STRUCTURE and SVOX_SUFFIX first.
//
// Replaces: svox_t_tpu/ops/tape.py `_count_samples` (K13a) and
// `_record_chunks` (K13b). The TPU version recorded rays sorted by sample
// count into (S, C) chunk tables, K-sample rounds at a time, and compacted
// each column with a stable sort; here the layout is SIMT: rays in input
// order, each ray's samples one run in a flat buffer at offsets[i] (the
// cumulative sum of K13a's counts, formed between the two launches).
//
// Both kernels walk a ray exactly as K2 (render_fwd.cuh) does, taking every
// step and not only the compositing ones: svox::setup_ray, march_cull (the
// bake's occupied-box cull and, in fast mode, its box advance), then per
// sample svox::sample_leaf (the lookup and the step, skip boxes included),
// t = t + dt, and out at t >= tmax or max_steps samples. Neither stops
// early: the stop is a replay-time decision. A hit ray takes its first
// sample at tmin, as K2 does. The library is built with -fmad=false, so the
// recorded t-chain is K2's bit for bit, and a replay that composites the
// recorded samples in order equals K2 bit for bit.
//
// K13a writes per ray the occupied count (rows r with 0 <= r < n_rows) and
// the total count. K13b writes ray i's run at offsets[i]: every sample, or
// with `compact` only the occupied ones, in order; each with its row (idx)
// and step (dt), optionally its tree cell (the leaf cell, on the bake
// through src_map) and its march parameter t; and the ray's delta_scale
// once. A data-indirect tape records the cell stream only (idx null).
//
// Bound on an H100: latency, as K2 (a dependent lookup chain per sample,
// no feature row read); K13b adds 8-16 streamed bytes written per sample.
// The design answer is K2's: one thread per ray, small blocks, so enough
// warps are resident to hide the chains.
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
