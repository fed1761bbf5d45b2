// Designs of K12's march (`svox_t_tpu_torch/csrc/grid.cu` `grid_kernel`)
// that lost to the shipped one; `tools/grid_ab.py` times them beside it.
// The tool copies grid.cu, includes this file inside its anonymous
// namespace (before `mask_bricks`) and launches a design's kernel in place
// of `grid_kernel<kBrick, int>`; each takes grid_kernel's arguments and
// maps threads to rays as it does (`tile_ray`).
//
//  * grid_kernel_ahead: the loop rotated, the next sample's position, mask
//    bit and sigma load issued before this sample composites (the lever
//    that won on K2's march);
//  * grid_kernel_smem: each block copies the mask into shared memory and
//    reads it there (the mask at most kSmemWords words; else the shipped
//    kernel's global loads).

constexpr int kSmemWords = 8192;

template <int kB, typename Idx>
__global__ void __launch_bounds__(kThreads) grid_kernel_ahead(
    const float* __restrict__ origins, const float* __restrict__ dirs, int B, int width,
    const float* __restrict__ offset, const float* __restrict__ scaling,
    const float* __restrict__ data, int reso, float step_size, float sigma_thresh, int max_steps,
    const uint32_t* __restrict__ mask, int nb, float* __restrict__ grid_weight,
    float* __restrict__ grid_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  svox::Ray r;
  if (max_steps <= 0 || !svox::setup_ray(origins, dirs, offset, scaling, tile_ray(i, B, width), r))
    return;
  const float res = static_cast<float>(reso);
  const float hi = static_cast<float>(reso - 1);
  float t = r.tmin;
  float L = 1.f;
  Sample<Idx> s = sample_at<kB, Idx>(r, t, reso, res, hi, nb, step_size, mask, data);
  for (int step = 1;; ++step) {
    const float tn = t + s.dt;
    const bool more = step < max_steps && tn < r.tmax;
    Sample<Idx> n;
    if (more) n = sample_at<kB, Idx>(r, tn, reso, res, hi, nb, step_size, mask, data);
    if (s.marked && s.sigma > sigma_thresh) {
      const float att = expf((-s.dt * r.ds) * s.sigma);
      const float weight = L * (1.f - att);
      L = L * att;
      atomicMax(reinterpret_cast<int*>(grid_weight + s.node), __float_as_int(weight));
      atomicAdd(grid_hit + s.node, 1.f);
    }
    if (!more) break;
    s = n;
    t = tn;
  }
}

template <int kB, typename Idx>
__device__ __forceinline__ Sample<Idx> sample_at_shared(const svox::Ray& r, float t, int reso,
                                                        float res, float hi, int nb,
                                                        float step_size, const uint32_t* smask,
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
  s.marked = (smask[b >> 5] >> (b & 31)) & 1u;
  s.sigma = s.marked ? __ldg(data + s.node) : 0.f;
  return s;
}

template <int kB, typename Idx>
__global__ void __launch_bounds__(kThreads) grid_kernel_smem(
    const float* __restrict__ origins, const float* __restrict__ dirs, int B, int width,
    const float* __restrict__ offset, const float* __restrict__ scaling,
    const float* __restrict__ data, int reso, float step_size, float sigma_thresh, int max_steps,
    const uint32_t* __restrict__ mask, int nb, float* __restrict__ grid_weight,
    float* __restrict__ grid_hit) {
  __shared__ uint32_t smask[kSmemWords];
  const int n_words = static_cast<int>((static_cast<int64_t>(nb) * nb * nb + 31) / 32);
  for (int k = threadIdx.x; k < n_words; k += blockDim.x) smask[k] = __ldg(mask + k);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  svox::Ray r;
  if (!svox::setup_ray(origins, dirs, offset, scaling, tile_ray(i, B, width), r)) return;
  const float res = static_cast<float>(reso);
  const float hi = static_cast<float>(reso - 1);
  float t = r.tmin;
  float L = 1.f;
  for (int step = 0; step < max_steps; ++step) {
    const Sample<Idx> s = sample_at_shared<kB, Idx>(r, t, reso, res, hi, nb, step_size, smask, data);
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

// The smem design where the mask fits its table, else the shipped kernel.
template <int kB, typename Idx>
void launch_smem(int blocks, cudaStream_t stream, const float* origins, const float* dirs, int B,
                 int width, const float* offset, const float* scaling, const float* data, int reso,
                 float step_size, float sigma_thresh, int max_steps, const uint32_t* mask, int nb,
                 float* grid_weight, float* grid_hit) {
  if ((static_cast<int64_t>(nb) * nb * nb + 31) / 32 <= kSmemWords)
    grid_kernel_smem<kB, Idx><<<blocks, kThreads, 0, stream>>>(
        origins, dirs, B, width, offset, scaling, data, reso, step_size, sigma_thresh, max_steps,
        mask, nb, grid_weight, grid_hit);
  else
    grid_kernel<kB, Idx><<<blocks, kThreads, 0, stream>>>(
        origins, dirs, B, width, offset, scaling, data, reso, step_size, sigma_thresh, max_steps,
        mask, nb, grid_weight, grid_hit);
}
