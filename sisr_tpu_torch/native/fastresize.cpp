// Fixed-point bicubic resampler, bit-exact with Pillow's 8bpc BICUBIC path.
//
// Native host-side hot path for the data pipeline: the reference framework resizes
// every image through PIL (ref: Code/sr_tools/image_manipulation.py:32-53), and this
// framework's LR-prep/eval paths must match it bit-for-bit.  The pure-numpy
// implementation (ops/resize.py resize_uint8) is ~12x slower than Pillow's C; this
// translation-free reimplementation of the same algorithm (Catmull-Rom a=-0.5,
// support widened by the scale factor, 22-bit fixed-point coefficients, rounding +
// clipping after each 1-D pass, horizontal then vertical) restores native speed.
//
// C ABI only (consumed via ctypes — no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8bpc coefficient precision

inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

struct Coeffs {
    std::vector<int> bounds_min;
    std::vector<int> bounds_len;
    std::vector<int32_t> kk;  // [out_size * ksize]
    int ksize = 0;
};

Coeffs precompute(int in_size, int out_size) {
    constexpr double support_base = 2.0;
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = support_base * filterscale;
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    const double ss = 1.0 / filterscale;

    Coeffs co;
    co.ksize = ksize;
    co.bounds_min.resize(out_size);
    co.bounds_len.resize(out_size);
    co.kk.assign(static_cast<size_t>(out_size) * ksize, 0);
    std::vector<double> w(ksize);

    for (int i = 0; i < out_size; ++i) {
        const double center = (i + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        const int n = xmax - xmin;
        double total = 0.0;
        for (int x = 0; x < n; ++x) {
            w[x] = bicubic_filter((x + xmin - center + 0.5) * ss);
            total += w[x];
        }
        co.bounds_min[i] = xmin;
        co.bounds_len[i] = n;
        for (int x = 0; x < n; ++x) {
            const double v = (total != 0.0 ? w[x] / total : w[x]) * (1 << kPrecisionBits);
            co.kk[static_cast<size_t>(i) * ksize + x] =
                static_cast<int32_t>(v >= 0.0 ? v + 0.5 : v - 0.5);
        }
    }
    return co;
}

inline uint8_t clip8(int64_t acc) {
    acc >>= kPrecisionBits;
    if (acc < 0) return 0;
    if (acc > 255) return 255;
    return static_cast<uint8_t>(acc);
}

// horizontal pass: (h, in_w, c) -> (h, out_w, c)
void resample_horizontal(const uint8_t* in, int h, int in_w, int c, uint8_t* out,
                         int out_w, const Coeffs& co) {
    const int64_t half = 1LL << (kPrecisionBits - 1);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = in + static_cast<size_t>(y) * in_w * c;
        uint8_t* orow = out + static_cast<size_t>(y) * out_w * c;
        for (int x = 0; x < out_w; ++x) {
            const int xmin = co.bounds_min[x];
            const int n = co.bounds_len[x];
            const int32_t* k = &co.kk[static_cast<size_t>(x) * co.ksize];
            for (int ch = 0; ch < c; ++ch) {
                int64_t acc = half;
                const uint8_t* p = row + (static_cast<size_t>(xmin) * c) + ch;
                for (int j = 0; j < n; ++j) acc += static_cast<int64_t>(k[j]) * p[static_cast<size_t>(j) * c];
                orow[static_cast<size_t>(x) * c + ch] = clip8(acc);
            }
        }
    }
}

// vertical pass: (in_h, w, c) -> (out_h, w, c)
void resample_vertical(const uint8_t* in, int in_h, int w, int c, uint8_t* out,
                       int out_h, const Coeffs& co) {
    const int64_t half = 1LL << (kPrecisionBits - 1);
    const size_t row_elems = static_cast<size_t>(w) * c;
    for (int y = 0; y < out_h; ++y) {
        const int ymin = co.bounds_min[y];
        const int n = co.bounds_len[y];
        const int32_t* k = &co.kk[static_cast<size_t>(y) * co.ksize];
        uint8_t* orow = out + static_cast<size_t>(y) * row_elems;
        for (size_t i = 0; i < row_elems; ++i) {
            int64_t acc = half;
            const uint8_t* p = in + static_cast<size_t>(ymin) * row_elems + i;
            for (int j = 0; j < n; ++j) acc += static_cast<int64_t>(k[j]) * p[static_cast<size_t>(j) * row_elems];
            orow[i] = clip8(acc);
        }
    }
}

}  // namespace

extern "C" {

// Bit-exact Pillow BICUBIC resize of an (h, w, c) uint8 image to (out_h, out_w, c).
// Returns 0 on success.
int resize_bicubic_u8(const uint8_t* in, int h, int w, int c, uint8_t* out, int out_h,
                      int out_w) {
    if (!in || !out || h <= 0 || w <= 0 || c <= 0 || out_h <= 0 || out_w <= 0) return 1;

    const uint8_t* cur = in;
    int cur_h = h, cur_w = w;
    std::vector<uint8_t> temp;

    if (out_w != w) {
        const Coeffs co = precompute(w, out_w);
        if (out_h != h) {
            temp.resize(static_cast<size_t>(h) * out_w * c);
            resample_horizontal(cur, h, w, c, temp.data(), out_w, co);
            cur = temp.data();
        } else {
            resample_horizontal(cur, h, w, c, out, out_w, co);
            cur = out;
        }
        cur_w = out_w;
    }
    if (out_h != h) {
        const Coeffs co = precompute(h, out_h);
        resample_vertical(cur, cur_h, cur_w, c, out, out_h, co);
    } else if (cur != out) {
        std::memcpy(out, cur, static_cast<size_t>(out_h) * out_w * c);
    }
    return 0;
}

}  // extern "C"
