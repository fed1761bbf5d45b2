// K12: dense-grid max-weight pass (svox_grid_weight), the PlenOctrees
// conversion and pruning utility.
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
// Bound on an H100: bytes and the latency of the dependent chain. A ray
// reads one sigma per sample (4 bytes from a 537 MB grid at reso 512,
// neighbouring rays touching neighbouring voxels) and issues two atomics
// per contributing sample; each sample's position needs the previous
// step. The design answer is a thread per ray with few registers, so many
// warps are resident to hide the loads, and atomics only where a sample
// contributes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) grid_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, int B,
    const float* __restrict__ offset, const float* __restrict__ scaling,
    const float* __restrict__ data, int reso, float step_size, float sigma_thresh, int max_steps,
    float* __restrict__ grid_weight, float* __restrict__ grid_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  svox::Ray r;
  if (!svox::setup_ray(origins, dirs, offset, scaling, i, r)) return;
  const float res = static_cast<float>(reso);
  const float hi = static_cast<float>(reso - 1);
  float t = r.tmin;
  float L = 1.f;
  for (int step = 0; step < max_steps; ++step) {
    float x, y, z;
    svox::sample_pos(r, t, x, y, z);
    x = svox::clamp_coord(x) * res;
    y = svox::clamp_coord(y) * res;
    z = svox::clamp_coord(z) * res;
    const float ux = fminf(floorf(x), hi), uy = fminf(floorf(y), hi), uz = fminf(floorf(z), hi);
    const int64_t node = (static_cast<int64_t>(static_cast<int>(ux)) * reso + static_cast<int>(uy)) *
                             reso + static_cast<int>(uz);
    float sub_tmin, sub_tmax;
    svox::dda_unit(x - ux, y - uy, z - uz, r.ivx, r.ivy, r.ivz, sub_tmin, sub_tmax);
    const float delta_t = (sub_tmax - sub_tmin) / res + step_size;
    const float sigma = __ldg(data + node);
    if (sigma > sigma_thresh) {
      const float att = expf((-delta_t * r.ds) * sigma);
      const float weight = L * (1.f - att);
      L = L * att;
      atomicMax(reinterpret_cast<int*>(grid_weight + node), __float_as_int(weight));
      atomicAdd(grid_hit + node, 1.f);
    }
    t = t + delta_t;
    if (!(t < r.tmax)) break;
  }
}

}  // namespace

// K12. origins, dirs (B, 3) f32 world-space rays; offset, scaling (3,) f32
// world -> grid space; data (reso, reso, reso) f32 sigma; grid_weight and
// grid_hit (reso, reso, reso) f32, zeroed by the caller (+0.0). All
// pointers are device pointers. Returns a cudaError_t.
extern "C" int svox_grid_weight(const float* origins, const float* dirs, int B,
                                const float* offset, const float* scaling, const float* data,
                                int reso, float step_size, float sigma_thresh, int max_steps,
                                float* grid_weight, float* grid_hit, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0) return cudaSuccess;
  if (reso <= 0) return cudaErrorInvalidValue;
  grid_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      origins, dirs, B, offset, scaling, data, reso, step_size, sigma_thresh, max_steps,
      grid_weight, grid_hit);
  return cudaGetLastError();
}
