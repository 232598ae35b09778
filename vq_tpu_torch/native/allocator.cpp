// Native host-side components of vq_tpu_torch (a copy of the JAX package's allocator.cpp).
//
// Re-implementation of the reference engine's host-side scalar
// programs (scalar dynamic programs that do not vectorize onto a device):
//   * greedy bit allocator   (reference external/saq/src/bit_allocator_greedy.cpp)
//   * exact DP bit allocator (reference external/saq/src/quantization_plan.cpp:144-255)
//   * exact 1-D k-means codebook via divide-and-conquer DP, O(k·n·log n)
//     (reference external/saq/src/preprocessing/codebook_builder.cpp
//      build_codebook_exact)
//
// Exposed with C linkage and loaded with ctypes.
// Built at first use by vq_tpu_torch/native/__init__.py into vq_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Greedy marginal-gain allocation over blocks.
// block_mse: nb x (max_bits+1) row-major; out_bits: nb entries.
void vq_allocate_greedy(const double* block_mse, const int64_t* block_lens,
                        int64_t nb, int32_t max_bits, int64_t budget_bits,
                        int64_t* out_bits) {
    std::vector<int64_t> bits(nb, 0);
    int64_t spent = 0;
    const int stride = max_bits + 1;
    for (;;) {
        double best_gain = -std::numeric_limits<double>::infinity();
        int64_t best = -1;
        for (int64_t i = 0; i < nb; ++i) {
            const int64_t b = bits[i];
            if (b < max_bits && spent + block_lens[i] <= budget_bits) {
                const double g =
                    (block_mse[i * stride + b] - block_mse[i * stride + b + 1]) /
                    static_cast<double>(block_lens[i]);
                if (g > best_gain) { best_gain = g; best = i; }
            }
        }
        if (best < 0 || !(best_gain > 0)) break;
        bits[best] += 1;
        spent += block_lens[best];
    }
    for (int64_t i = 0; i < nb; ++i) out_bits[i] = bits[i];
}

// Exact DP over (block, spent-bits) minimizing total MSE.
void vq_allocate_dp(const double* block_mse, const int64_t* block_lens,
                    int64_t nb, int32_t max_bits, int64_t budget_bits,
                    int64_t* out_bits) {
    const double INF = std::numeric_limits<double>::infinity();
    const int stride = max_bits + 1;
    std::vector<double> dp(budget_bits + 1, INF);
    dp[0] = 0.0;
    std::vector<int8_t> choice(static_cast<size_t>(nb) * (budget_bits + 1), 0);
    std::vector<double> ndp(budget_bits + 1);
    for (int64_t i = 0; i < nb; ++i) {
        std::fill(ndp.begin(), ndp.end(), INF);
        int8_t* ch = choice.data() + static_cast<size_t>(i) * (budget_bits + 1);
        for (int32_t b = 0; b <= max_bits; ++b) {
            const int64_t cost = static_cast<int64_t>(b) * block_lens[i];
            if (cost > budget_bits) break;
            const double mse = block_mse[i * stride + b];
            for (int64_t j = cost; j <= budget_bits; ++j) {
                const double cand = dp[j - cost] + mse;
                if (cand < ndp[j]) { ndp[j] = cand; ch[j] = static_cast<int8_t>(b); }
            }
        }
        dp.swap(ndp);
    }
    // backtrack from the best total <= budget
    int64_t j = 0;
    double bestv = INF;
    for (int64_t t = 0; t <= budget_bits; ++t)
        if (dp[t] < bestv) { bestv = dp[t]; j = t; }
    for (int64_t i = nb - 1; i >= 0; --i) {
        const int8_t b = choice[static_cast<size_t>(i) * (budget_bits + 1) + j];
        out_bits[i] = b;
        j -= static_cast<int64_t>(b) * block_lens[i];
    }
}

namespace {

// SSE of sorted_data[i..j] inclusive around its mean, from prefix sums.
struct Cost {
    const double* ps;   // prefix sums, ps[0] = 0
    const double* ps2;  // prefix square sums
    inline double operator()(int64_t i, int64_t j) const {
        const double m = static_cast<double>(j - i + 1);
        const double s = ps[j + 1] - ps[i];
        const double s2 = ps2[j + 1] - ps2[i];
        return s2 - s * s / m;
    }
};

// Divide-and-conquer DP layer fill: dp_cur[j] = min_i dp_prev[i-1] + cost(i, j),
// exploiting monotonicity of the optimal split.
void dnc(int64_t lo, int64_t hi, int64_t opt_lo, int64_t opt_hi,
         const std::vector<double>& prev, std::vector<double>& cur,
         std::vector<int32_t>& opt, const Cost& cost) {
    if (lo > hi) return;
    const int64_t mid = (lo + hi) / 2;
    double best = std::numeric_limits<double>::infinity();
    int64_t best_i = opt_lo;
    const int64_t top = std::min(mid, opt_hi);
    for (int64_t i = opt_lo; i <= top; ++i) {
        const double v = (i > 0 ? prev[i - 1] : (i == 0 ? 0.0 : 0.0)) + cost(i, mid);
        if (v < best) { best = v; best_i = i; }
    }
    cur[mid] = best;
    opt[mid] = static_cast<int32_t>(best_i);
    dnc(lo, mid - 1, opt_lo, best_i, prev, cur, opt, cost);
    dnc(mid + 1, hi, best_i, opt_hi, prev, cur, opt, cost);
}

}  // namespace

// Exact optimal 1-D k-means on SORTED data (divide-and-conquer DP).
// sorted_data: n ascending floats; out_levels: k cluster means (sorted).
// Memory: O(k*n) int32 for backtracking.  Returns 0 on success.
int32_t vq_codebook_exact(const float* sorted_data, int64_t n, int32_t k,
                          float* out_levels) {
    if (n <= 0 || k <= 0) return -1;
    if (k >= n) {  // every point its own level, pad by repeating the last
        for (int32_t c = 0; c < k; ++c)
            out_levels[c] = sorted_data[c < n ? c : n - 1];
        return 0;
    }
    std::vector<double> ps(n + 1, 0.0), ps2(n + 1, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        const double v = sorted_data[i];
        ps[i + 1] = ps[i] + v;
        ps2[i + 1] = ps2[i] + v * v;
    }
    Cost cost{ps.data(), ps2.data()};

    std::vector<double> prev(n), cur(n);
    std::vector<std::vector<int32_t>> opts(k, std::vector<int32_t>(n, 0));
    for (int64_t j = 0; j < n; ++j) prev[j] = cost(0, j);  // 1 cluster
    for (int32_t c = 1; c < k; ++c) {
        dnc(0, n - 1, 0, n - 1, prev, cur, opts[c], cost);
        prev.swap(cur);
    }
    // backtrack cluster boundaries
    int64_t j = n - 1;
    std::vector<int64_t> starts(k);
    for (int32_t c = k - 1; c >= 1; --c) {
        starts[c] = opts[c][j];
        j = starts[c] - 1;
    }
    starts[0] = 0;
    double lastv = sorted_data[0];
    for (int32_t c = 0; c < k; ++c) {
        const int64_t s = starts[c];
        const int64_t e = (c + 1 < k ? starts[c + 1] - 1 : n - 1);
        if (e >= s) {  // empty clusters (heavy duplicates) repeat the last level
            const double m = static_cast<double>(e - s + 1);
            lastv = (ps[e + 1] - ps[s]) / m;
        }
        out_levels[c] = static_cast<float>(lastv);
    }
    return 0;
}

}  // extern "C"
