// Median-cut color quantization, host C++ (svox_t_tpu_torch's own copy of
// the JAX package's `native/quantizer.cpp`; the port imports nothing of it).
//
// The PlenOctrees compression utility `quantize_median_cut` (svox_t's
// `csrc/quantizer.cpp`): split the rows recursively on the dimension of
// largest range, at the median or, with weights, at the half-total-weight
// point, giving 2^order representative colors and a color id per row.
// Offline CPU tooling: no GPU is involved.
//
// A plain C interface, bound with ctypes (`native/quantize.py`), which
// builds it with: g++ -O3 -shared -fPIC -std=c++17 -o <lib>.so quantizer.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

struct Ctx {
    const float* data;     // (n, k) row-major
    const float* weights;  // (n,) or nullptr
    int64_t k;
    float* colors;         // (2^order, k)
    int32_t* id_map;       // (n,)
    int32_t next_color;
};

// Pick the dimension with the largest value range over rows [l, r).
int widest_dim(const Ctx& c, const std::vector<int64_t>& order_buf,
               int64_t l, int64_t r) {
    const float inf = std::numeric_limits<float>::infinity();
    std::vector<float> lo(c.k, inf), hi(c.k, -inf);
    for (int64_t i = l; i < r; ++i) {
        const float* row = c.data + order_buf[i] * c.k;
        for (int64_t j = 0; j < c.k; ++j) {
            lo[j] = std::min(lo[j], row[j]);
            hi[j] = std::max(hi[j], row[j]);
        }
    }
    int best = 0;
    float best_range = -1.0f;
    for (int64_t j = 0; j < c.k; ++j) {
        const float range = hi[j] - lo[j];
        if (range > best_range) {
            best_range = range;
            best = static_cast<int>(j);
        }
    }
    return best;
}

void emit_cluster(Ctx& c, std::vector<int64_t>& order_buf, int64_t l, int64_t r) {
    float* color = c.colors + static_cast<int64_t>(c.next_color) * c.k;
    std::memset(color, 0, sizeof(float) * c.k);
    double total_w = 0.0;
    for (int64_t i = l; i < r; ++i) {
        const int64_t row_idx = order_buf[i];
        const float* row = c.data + row_idx * c.k;
        const float w = c.weights ? c.weights[row_idx] : 1.0f;
        for (int64_t j = 0; j < c.k; ++j) color[j] += w * row[j];
        total_w += w;
        c.id_map[row_idx] = c.next_color;
    }
    if (total_w > 0.0) {
        for (int64_t j = 0; j < c.k; ++j)
            color[j] = static_cast<float>(color[j] / total_w);
    }
    ++c.next_color;
}

void median_cut(Ctx& c, std::vector<int64_t>& order_buf, int32_t depth,
                int64_t l, int64_t r) {
    if (depth <= 0 || r - l <= 1) {
        emit_cluster(c, order_buf, l, r);
        return;
    }
    const int dim = widest_dim(c, order_buf, l, r);
    auto cmp = [&](int64_t a, int64_t b) {
        return c.data[a * c.k + dim] < c.data[b * c.k + dim];
    };

    int64_t m;
    if (!c.weights) {
        m = l + (r - l) / 2;
        std::nth_element(order_buf.begin() + l, order_buf.begin() + m,
                         order_buf.begin() + r, cmp);
    } else {
        std::sort(order_buf.begin() + l, order_buf.begin() + r, cmp);
        double total_w = 0.0;
        for (int64_t i = l; i < r; ++i) total_w += c.weights[order_buf[i]];
        double pfx = 0.0;
        for (m = l; m < r; ++m) {
            pfx += c.weights[order_buf[m]];
            if (pfx > 0.5 * total_w) break;
        }
    }
    median_cut(c, order_buf, depth - 1, l, m);
    median_cut(c, order_buf, depth - 1, m, r);
}

}  // namespace

extern "C" {

// data: (n, k) float32 row-major; weights: (n,) float32 or nullptr;
// colors_out: (2^order, k) float32 (zero-initialized by caller);
// id_map_out: (n,) int32. Returns number of colors emitted.
int32_t svoxt_quantize_median_cut(const float* data, const float* weights,
                                  int64_t n, int64_t k, int32_t order,
                                  float* colors_out, int32_t* id_map_out) {
    Ctx c{data, weights, k, colors_out, id_map_out, 0};
    std::vector<int64_t> order_buf(n);
    std::iota(order_buf.begin(), order_buf.end(), 0);
    median_cut(c, order_buf, order, 0, n);
    return c.next_color;
}

}  // extern "C"
