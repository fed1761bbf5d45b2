// K12: dense-grid max-weight pass (svox_grid_weight), the PlenOctrees
// conversion and pruning utility, and its occupancy pass
// (svox_grid_occupancy).
//
// Replaces: svox_t_tpu/ops/grid.py `grid_weight_render` (the CUDA
// reference's rt_kernel.cu:1240-1344, 1454-1478). On the TPU every chunk
// of rays marched a reso^3 sigma grid under a while loop, and the two
// outputs were the chunk scan's carry, updated by deterministic XLA
// scatter-max and scatter-add. Here one thread marches one ray, sample by
// sample, as the JAX body does (grid.py:57-75): the sample point o + t * d
// (rounded once, svox::sample_pos), clamped and scaled by reso, its voxel
// floor(pos) clamped to reso - 1, the in-voxel DDA on the fraction,
// delta_t = (sub_tmax - sub_tmin) / reso + step_size, at most max_steps
// samples, out at t >= tmax.
//
// A contributing sample (sigma > sigma_thresh) raises its voxel's weight to
// max(weight, L * (1 - att)) and adds 1 to its hits. The weights start at
// +0.0 and are compared as signed ints: on non-negative floats the int
// order is the float order, and a negative weight (a negative int) never
// wins, as `.at[].max` from 0 keeps 0. Both outputs are order-independent
// (a max, and sums of 1.0 below 2^24), so the kernel equals its plain
// version bit for bit, whatever order the atomics land in.
//
// Bound on an H100: the outputs' bytes, and the issue rate of the sample
// chain. A sample's position, voxel, DDA and step never depend on sigma,
// and on the depth-9 shell's 512^3 grid about 1% of the voxels hold a
// sigma above the threshold; a load of every sample's sigma from the
// 537 MB grid (a 32-byte sector for 4 bytes, on the chain's critical path)
// was the first design's cost. So the pass runs in two launches:
//
//  * occupancy_kernel reads the grid once, a lane per kBrick^3 brick in
//    16-byte loads (a warp's lanes on consecutive bricks of one row), and
//    writes one bit per brick, set where a voxel has sigma > sigma_thresh:
//    the march's own predicate, so NaN sigmas and NaN or negative
//    thresholds act as in the plain version. Bit b of word w is brick
//    32 w + b, bricks numbered x-major as the voxels are; edge bricks are
//    partial when reso % kBrick != 0. Every word is written (the warp's
//    ballot), so the mask needs no zero fill. At reso 512 it is 32 KB.
//  * grid_kernel marches as before and loads sigma only where the sample's
//    brick is marked (a 32 KB table that stays in L1); elsewhere no voxel
//    of the brick passes the predicate, so the sample adds nothing and L
//    stays. A warp marches an 8x4 tile of pixels where the caller gives
//    the rays' row width (fewer warp iterations, and in a dense scene far
//    fewer stalls on the same voxels' atomics than 32 pixels of one row).
//    Voxel indices are 32-bit where reso^3 < 2^31 (a template parameter;
//    64-bit above). tools/grid_ab.py times the designs against an earlier
//    checkout's kernel; those that lost (the next sample's loads issued
//    before this one composites, the mask in shared memory) are in
//    tools/grid_designs.cuh.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBrick = 8;

// The occupancy mask of the sigma grid, a lane per brick. kVec: every
// brick whole (reso % kB == 0) and the grid 16-byte aligned, each brick
// row read as kB / 4 float4s; else the scalar walk of any reso.
template <int kB, bool kVec>
__global__ void __launch_bounds__(kThreads) occupancy_kernel(
    const float* __restrict__ data, int reso, int nb, float sigma_thresh, int n_words,
    uint32_t* __restrict__ mask) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_words) return;  // whole warps: 32 lanes a word
  const int lane = threadIdx.x & 31;
  const int64_t bi = static_cast<int64_t>(w) * 32 + lane;
  unsigned any = 0;
  if (bi < static_cast<int64_t>(nb) * nb * nb) {
    const int bz = static_cast<int>(bi % nb);
    const int by = static_cast<int>((bi / nb) % nb);
    const int bx = static_cast<int>(bi / (static_cast<int64_t>(nb) * nb));
    const int x0 = bx * kB, y0 = by * kB, z0 = bz * kB;
    if (kVec) {
#pragma unroll 4
      for (int r = 0; r < kB * kB; ++r) {
        const float4* row = reinterpret_cast<const float4*>(
            data + (static_cast<int64_t>(x0 + r / kB) * reso + (y0 + r % kB)) * reso + z0);
#pragma unroll
        for (int q = 0; q < kB / 4; ++q) {
          const float4 v = __ldg(row + q);
          any |= (v.x > sigma_thresh ? 1u : 0u) | (v.y > sigma_thresh ? 1u : 0u) |
                 (v.z > sigma_thresh ? 1u : 0u) | (v.w > sigma_thresh ? 1u : 0u);
        }
      }
    } else {
      const int x1 = min(x0 + kB, reso), y1 = min(y0 + kB, reso), z1 = min(z0 + kB, reso);
      for (int x = x0; x < x1; ++x)
        for (int y = y0; y < y1; ++y) {
          const float* row = data + (static_cast<int64_t>(x) * reso + y) * reso;
          for (int z = z0; z < z1; ++z) any |= __ldg(row + z) > sigma_thresh ? 1u : 0u;
        }
    }
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, any != 0);
  if (lane == 0) mask[w] = bits;
}

// One sample of a ray at t: its voxel, step, brick bit and, where the
// brick is marked, its sigma.
template <typename Idx>
struct Sample {
  Idx node;
  float dt;
  float sigma;
  bool marked;
};

template <int kB, typename Idx>
__device__ __forceinline__ Sample<Idx> sample_at(const svox::Ray& r, float t, int reso, float res,
                                                 float hi, int nb, float step_size,
                                                 const uint32_t* __restrict__ mask,
                                                 const float* __restrict__ data) {
  float x, y, z;
  svox::sample_pos(r, t, x, y, z);
  x = svox::clamp_coord(x) * res;
  y = svox::clamp_coord(y) * res;
  z = svox::clamp_coord(z) * res;
  const float ux = fminf(floorf(x), hi), uy = fminf(floorf(y), hi), uz = fminf(floorf(z), hi);
  const int ix = static_cast<int>(ux), iy = static_cast<int>(uy), iz = static_cast<int>(uz);
  Sample<Idx> s;
  s.node = (static_cast<Idx>(ix) * reso + iy) * reso + iz;
  float sub_tmin, sub_tmax;
  svox::dda_unit(x - ux, y - uy, z - uz, r.ivx, r.ivy, r.ivz, sub_tmin, sub_tmax);
  s.dt = (sub_tmax - sub_tmin) / res + step_size;
  const unsigned b = (static_cast<unsigned>(ix) / kB * nb + static_cast<unsigned>(iy) / kB) * nb +
                     static_cast<unsigned>(iz) / kB;
  s.marked = (__ldg(mask + (b >> 5)) >> (b & 31)) & 1u;
  s.sigma = s.marked ? __ldg(data + s.node) : 0.f;
  return s;
}

// The ray a thread marches: ray i of the batch, or where the rays come in
// rows of `width` pixels (width a multiple of 8, B a multiple of 4 rows)
// the ray of lane i % 32 in the 8x4 pixel tile of warp i / 32, tiles in row order.
__device__ __forceinline__ int tile_ray(int i, int B, int width) {
  if (width <= 0 || width % 8 != 0 || B % (4 * width) != 0) return i;
  const int w = i >> 5, lane = i & 31, tiles = width / 8;
  return ((w / tiles) * 4 + (lane >> 3)) * width + (w % tiles) * 8 + (lane & 7);
}

// One ray's march (ray i of the batch).
template <int kB, typename Idx>
__device__ __forceinline__ void march(
    int i, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ offset, const float* __restrict__ scaling,
    const float* __restrict__ data, int reso, float step_size, float sigma_thresh, int max_steps,
    const uint32_t* __restrict__ mask, int nb, float* __restrict__ grid_weight,
    float* __restrict__ grid_hit) {
  svox::Ray r;
  if (!svox::setup_ray(origins, dirs, offset, scaling, i, r)) return;
  const float res = static_cast<float>(reso);
  const float hi = static_cast<float>(reso - 1);
  float t = r.tmin;
  float L = 1.f;
  for (int step = 0; step < max_steps; ++step) {
    const Sample<Idx> s = sample_at<kB, Idx>(r, t, reso, res, hi, nb, step_size, mask, data);
    if (s.marked && s.sigma > sigma_thresh) {
      const float att = expf((-s.dt * r.ds) * s.sigma);
      const float weight = L * (1.f - att);
      L = L * att;
      atomicMax(reinterpret_cast<int*>(grid_weight + s.node), __float_as_int(weight));
      atomicAdd(grid_hit + s.node, 1.f);
    }
    t = t + s.dt;
    if (!(t < r.tmax)) break;
  }
}

template <int kB, typename Idx>
__global__ void __launch_bounds__(kThreads) grid_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, int B, int width,
    const float* __restrict__ offset, const float* __restrict__ scaling,
    const float* __restrict__ data, int reso, float step_size, float sigma_thresh, int max_steps,
    const uint32_t* __restrict__ mask, int nb, float* __restrict__ grid_weight,
    float* __restrict__ grid_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B)
    march<kB, Idx>(tile_ray(i, B, width), origins, dirs, offset, scaling, data, reso, step_size,
                   sigma_thresh, max_steps, mask, nb, grid_weight, grid_hit);
}

int mask_bricks(int reso) { return (reso + kBrick - 1) / kBrick; }

int mask_words(int nb) {
  return static_cast<int>((static_cast<int64_t>(nb) * nb * nb + 31) / 32);
}

}  // namespace

// K12's occupancy pass. data (reso, reso, reso) f32 sigma; mask
// (ceil(ceil(reso / kBrick)^3 / 32),) u32 (ops/grid.py `mask_words`),
// every word written. Returns a cudaError_t.
extern "C" int svox_grid_occupancy(const float* data, int reso, float sigma_thresh,
                                   uint32_t* mask, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (reso <= 0) return cudaErrorInvalidValue;
  const int nb = mask_bricks(reso);
  const int n_words = mask_words(nb);
  const int64_t threads = static_cast<int64_t>(n_words) * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const bool vec = reso % kBrick == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  if (vec)
    occupancy_kernel<kBrick, true><<<blocks, kThreads, 0, stream>>>(data, reso, nb, sigma_thresh,
                                                                    n_words, mask);
  else
    occupancy_kernel<kBrick, false><<<blocks, kThreads, 0, stream>>>(data, reso, nb, sigma_thresh,
                                                                     n_words, mask);
  return cudaGetLastError();
}

// K12. origins, dirs (B, 3) f32 world-space rays, in rows of width pixels
// where width > 0 (the 8x4 tiles of tile_ray), else in any order; offset,
// scaling (3,) f32 world -> grid space; data (reso, reso, reso) f32 sigma;
// mask its occupancy (svox_grid_occupancy with the same sigma_thresh);
// grid_weight and grid_hit (reso, reso, reso) f32, zeroed by the caller
// (+0.0). All pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_grid_weight(const float* origins, const float* dirs, int B, int width,
                                const float* offset, const float* scaling, const float* data,
                                int reso, float step_size, float sigma_thresh, int max_steps,
                                const uint32_t* mask, float* grid_weight, float* grid_hit,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (reso <= 0) return cudaErrorInvalidValue;
  const int nb = mask_bricks(reso);
  const int blocks = (B + kThreads - 1) / kThreads;
  if (static_cast<int64_t>(reso) * reso * reso < (int64_t{1} << 31))
    grid_kernel<kBrick, int><<<blocks, kThreads, 0, stream>>>(
        origins, dirs, B, width, offset, scaling, data, reso, step_size, sigma_thresh, max_steps,
        mask, nb, grid_weight, grid_hit);
  else
    grid_kernel<kBrick, int64_t><<<blocks, kThreads, 0, stream>>>(
        origins, dirs, B, width, offset, scaling, data, reso, step_size, sigma_thresh, max_steps,
        mask, nb, grid_weight, grid_hit);
  return cudaGetLastError();
}
