// K9a, the opacity VJP, with every lever tools/render_bwd_ab.py --opacity
// times, the ones that did not ship included (PERF.md §6). The shipped
// kernel (svox_t_tpu_torch/csrc/render_bwd.cuh) keeps the own lookup's
// corners under interp (kOpReuse 1 on the bake, 2 on the tree walk), the
// lookup ahead on the bake's float32 instance (kOpLoop 2) and the earlier
// loop elsewhere, and no skip; this file adds svox::sample_corners' 9
// lookups from the root (kOpReuse 0), the rotated loop (kOpLoop 1) and the
// skip (kOpSkip). It is not part of the library: render_bwd_ab.py puts it
// in place of render_bwd.cuh's K9a section (inside the header's anonymous
// namespace, after K3's `launch`) in a copy of the sources, and its designs
// set the constants below, whose defaults are the shipped kernel's.
//
// The levers:
//  * kOpReuse, interp only: the corners from the sample's own lookup, as
//    K2+K4 finds them (svox::corners_keep: 1 the own corner's row, 2 also
//    the other corners' descents started on the own path, the tree walk),
//    or svox::sample_corners' 9 lookups from the root (0); the corner rows
//    are sample_corners' bit for bit (ops/corner_lookup.py mirrors them);
//  * kOpLoop, nearest only: 0 the earlier loop (a sample's lookup, step and
//    sigma at the top of each step); 1 the loop rotated as K9b's tree walk
//    (the next sample's lookup at the end of a step); 2 the next sample's
//    lookup issued before the sigma's test (the lookup ahead);
//  * kOpSkip: a ray whose coefficient g_alpha * L_ray is 0 (a zero
//    cotangent, an opaque ray in the single pass) adds only zeros, which
//    change no sum bit for bit: it returns before its march.

template <class S>
constexpr int kOpReuse = !svox::kInterp ? 0 : (S::kBaked ? 1 : 2);
template <class S>
constexpr int kOpLoop = S::kBaked && svox::kFloatPool ? 2 : 0;
constexpr bool kOpSkip = false;

// A contributing sample of the nearest march: with kAdd its add into column
// D - 1 of its row, and its attenuation of L (dead with kAdd: the caller
// drops it).
template <class S, bool kAdd>
__device__ __forceinline__ void opacity_sample(const Params<S>& p, const Ray& r, int32_t idx, float sigma,
                                               float dt, float coef, float& L) {
  if (sigma > 0.f) {
    if constexpr (kAdd) atomicAdd(p.grad + static_cast<size_t>(idx) * p.D + p.D - 1, (dt * r.ds) * coef);
    L = L * expf((-dt * r.ds) * sigma);
  }
}

// K9a's march: kAdd false is pass A (the final L under the backward's
// sigma > 0 rule, nothing written), true the adds of (dt * ds) * coef into
// column D - 1 of every contributing sample's row, or w_n times that into
// its corners' rows under interp. The samples and the rule are `march`'s.
template <class S, bool kAdd>
__device__ __forceinline__ float opacity_march(const Params<S>& p, const Ray& r, float coef) {
  float t = r.tmin;
  float L = 1.f;
  if constexpr (svox::kInterp) {
    typename S::Keep keep;
    if constexpr (!S::kBaked) keep.path = path_slot<S>();
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      svox::Corners cn;
      if constexpr (kOpReuse<S> == 0) {
        const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
        cn = svox::sample_corners(p.st, r, t, leaf.cube_sz, p.M);
      } else {
        const svox::Leaf leaf = svox::sample_leaf_keep(p.st, r, t, p.step_size, dt, keep);
        cn = svox::corners_keep<kOpReuse<S>>(p.st, r, t, leaf, keep, p.M);
      }
      const float sigma = svox::interp_sum(cn, [&](int32_t row) {
        return svox::ld(p.features + static_cast<size_t>(row) * p.D + p.D - 1);
      });
      if (sigma > 0.f) {
        if constexpr (kAdd) add_corners(p, cn, p.D - 1, (dt * r.ds) * coef);
        L = L * expf((-dt * r.ds) * sigma);
      }
      t = t + dt;
    }
  } else if constexpr (kOpLoop<S> == 0) {
    for (int step = 0; step < p.max_steps; ++step) {
      if (!(t < r.tmax)) break;
      float dt;
      const svox::Leaf leaf = svox::sample_leaf(p.st, r, t, p.step_size, dt);
      const int32_t idx = leaf.row;
      if (static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M)) {
        const float sigma = svox::ld(p.features + static_cast<size_t>(idx) * p.D + p.D - 1);
        opacity_sample<S, kAdd>(p, r, idx, sigma, dt, coef, L);
      }
      t = t + dt;
    }
  } else {
    if (!(t < r.tmax) || p.max_steps <= 0) return L;
    float x, y, z;
    svox::sample_pos(r, t, x, y, z);
    svox::Leaf leaf = p.st.lookup(x, y, z);
    for (int step = 0;; ++step) {
      const float dt = svox::step_dt(p.st, leaf, r, p.step_size);
      const int32_t idx = leaf.row;
      const bool resident = static_cast<uint32_t>(idx) < static_cast<uint32_t>(p.M);
      const float sigma = resident ? svox::ld(p.features + static_cast<size_t>(idx) * p.D + p.D - 1) : 0.f;
      const float t_next = t + dt;
      const bool more = step + 1 < p.max_steps && t_next < r.tmax;
      if constexpr (kOpLoop<S> == 2) {
        svox::Leaf next = leaf;
        if (more) {
          svox::sample_pos(r, t_next, x, y, z);
          next = p.st.lookup(x, y, z);
        }
        opacity_sample<S, kAdd>(p, r, idx, sigma, dt, coef, L);
        if (!more) break;
        leaf = next;
      } else {
        opacity_sample<S, kAdd>(p, r, idx, sigma, dt, coef, L);
        if (!more) break;
        svox::sample_pos(r, t_next, x, y, z);
        leaf = p.st.lookup(x, y, z);
      }
      t = t_next;
    }
  }
  return L;
}

// K9a, one instance a mode: the single pass (grad_out and out_res (B, 1),
// g_alpha and the forward alpha: L_ray = 1 - alpha) or, kTwoPass, pass A
// for L_ray and then the adds.
template <class S, bool kTwoPass>
__global__ void __launch_bounds__(kThreads) opacity_bwd_kernel(const Params<S> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const float g_alpha = p.grad_out[i];
  if (kOpSkip && g_alpha == 0.f) return;
  Ray r;
  if (!svox::march_cull(p.st, r, svox::setup_ray(p.origins, p.dirs, p.offset, p.scaling, i, r))) return;
  float L_ray;
  if constexpr (kTwoPass) {
    L_ray = opacity_march<S, false>(p, r, 0.f);
  } else {
    L_ray = 1.f - p.out_res[i];
  }
  const float coef = g_alpha * L_ray;
  if (kOpSkip && coef == 0.f) return;
  opacity_march<S, true>(p, r, coef);
}

