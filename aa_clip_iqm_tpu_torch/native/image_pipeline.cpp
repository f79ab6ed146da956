// Native host-side image pipeline for the data layer.
//
// The reference's data path is torchvision/PIL transforms in Python
// (dataset/__init__.py:37-102). The input pipeline competes with the
// host's dispatch for CPU time, so the per-sample hot loop (bicubic resize,
// CLIP normalization, joint affine warp of the 4-channel image+mask stack,
// flips) lives here as a small C++ library, bound with ctypes, with a
// numpy/PIL fallback kept for machines without a compiler. The same source
// as the JAX package's native/image_pipeline.cpp, so that both packages
// produce the same bits.
//
// Resize matches PIL's convolution resampler: separable Keys cubic with
// a=-0.5, kernel stretched by max(scale,1), window clipped to the valid
// range and re-normalized (the same math validated against
// torch/PIL in ops/interp.bicubic_matrix).
//
// Build: aa_clip_iqm_tpu_torch/data/native.py runs
//   g++ -O3 -fPIC -shared -std=c++17 -Wall
// into build/aa_clip_iqm_tpu_torch/libaaclip_data.so at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double cubic(double x) {
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

struct Weights {
    std::vector<int> xmin;      // first source tap per output pixel
    std::vector<int> count;     // taps per output pixel
    std::vector<double> values; // flattened weights
    int max_count = 0;
};

Weights compute_weights(int src, int dst) {
    Weights w;
    w.xmin.resize(dst);
    w.count.resize(dst);
    const double scale = static_cast<double>(src) / dst;
    const double ss = scale > 1.0 ? scale : 1.0;
    const double support = 2.0 * ss;
    w.max_count = static_cast<int>(std::ceil(support)) * 2 + 1;
    w.values.assign(static_cast<size_t>(dst) * w.max_count, 0.0);
    for (int i = 0; i < dst; ++i) {
        const double center = (i + 0.5) * scale;
        int lo = static_cast<int>(center - support + 0.5);
        int hi = static_cast<int>(center + support + 0.5);
        if (lo < 0) lo = 0;
        if (hi > src) hi = src;
        double total = 0.0;
        double* row = &w.values[static_cast<size_t>(i) * w.max_count];
        for (int j = lo; j < hi; ++j) {
            row[j - lo] = cubic((j + 0.5 - center) / ss);
            total += row[j - lo];
        }
        if (total != 0.0) {
            for (int j = 0; j < hi - lo; ++j) row[j] /= total;
        }
        w.xmin[i] = lo;
        w.count[i] = hi - lo;
    }
    return w;
}

}  // namespace

extern "C" {

// uint8 HWC RGB (sh, sw, 3) -> float32 CHW (3, dh, dw) in [0, 1],
// PIL-compatible antialiased bicubic.
void resize_bicubic_rgb_u8(const uint8_t* src, int sh, int sw,
                           float* dst, int dh, int dw) {
    const Weights wx = compute_weights(sw, dw);
    const Weights wy = compute_weights(sh, dh);

    // Horizontal pass: (sh, dw, 3) intermediate, quantized back to uint8
    // after the pass — PIL's uint8 resampler rounds between passes, and the
    // data layer's parity target is PIL's output bit-for-bit (+-1 LSB).
    auto q8 = [](double v) -> uint8_t {
        const double r = std::round(v);
        if (r <= 0.0) return 0;
        if (r >= 255.0) return 255;
        return static_cast<uint8_t>(r);
    };
    std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * 3);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
        uint8_t* trow = &tmp[static_cast<size_t>(y) * dw * 3];
        for (int x = 0; x < dw; ++x) {
            const double* wv = &wx.values[static_cast<size_t>(x) * wx.max_count];
            const int lo = wx.xmin[x], n = wx.count[x];
            double acc[3] = {0, 0, 0};
            for (int j = 0; j < n; ++j) {
                const uint8_t* p = srow + static_cast<size_t>(lo + j) * 3;
                const double wj = wv[j];
                acc[0] += wj * p[0];
                acc[1] += wj * p[1];
                acc[2] += wj * p[2];
            }
            trow[x * 3 + 0] = q8(acc[0]);
            trow[x * 3 + 1] = q8(acc[1]);
            trow[x * 3 + 2] = q8(acc[2]);
        }
    }
    // Vertical pass, quantized like PIL, then scaled into [0,1] CHW floats.
    const double inv255 = 1.0 / 255.0;
    const size_t plane = static_cast<size_t>(dh) * dw;
    for (int y = 0; y < dh; ++y) {
        const double* wv = &wy.values[static_cast<size_t>(y) * wy.max_count];
        const int lo = wy.xmin[y], n = wy.count[y];
        for (int x = 0; x < dw; ++x) {
            double acc[3] = {0, 0, 0};
            for (int j = 0; j < n; ++j) {
                const uint8_t* p = &tmp[(static_cast<size_t>(lo + j) * dw + x) * 3];
                const double wj = wv[j];
                acc[0] += wj * p[0];
                acc[1] += wj * p[1];
                acc[2] += wj * p[2];
            }
            for (int c = 0; c < 3; ++c) {
                dst[c * plane + static_cast<size_t>(y) * dw + x] =
                    static_cast<float>(q8(acc[c]) * inv255);
            }
        }
    }
}

// Nearest-neighbor mask resize: uint8 (sh, sw) -> float32 (dh, dw) in {0,1}.
// PIL NEAREST sampling: src index = floor((i + 0.5) * src / dst).
void resize_nearest_mask_u8(const uint8_t* src, int sh, int sw,
                            float* dst, int dh, int dw) {
    for (int y = 0; y < dh; ++y) {
        int sy = static_cast<int>((y + 0.5) * sh / dh);
        if (sy >= sh) sy = sh - 1;
        for (int x = 0; x < dw; ++x) {
            int sx = static_cast<int>((x + 0.5) * sw / dw);
            if (sx >= sw) sx = sw - 1;
            dst[static_cast<size_t>(y) * dw + x] =
                src[static_cast<size_t>(sy) * sw + sx] != 0 ? 1.0f : 0.0f;
        }
    }
}

// In-place channelwise normalization of CHW float image.
void normalize_chw(float* img, int c, int h, int w,
                   const float* mean, const float* stddev) {
    const size_t plane = static_cast<size_t>(h) * w;
    for (int ch = 0; ch < c; ++ch) {
        const float m = mean[ch], inv = 1.0f / stddev[ch];
        float* p = img + ch * plane;
        for (size_t i = 0; i < plane; ++i) p[i] = (p[i] - m) * inv;
    }
}

// Inverse-mapped affine warp of a CHW stack (image+mask channels together —
// the joint geometric augmentation), zero padding outside. M is the 2x3
// forward cv2-style matrix; applies cv2.warpAffine semantics:
// dst(x,y) = src(Minv * (x,y,1)). bilinear=0 -> nearest neighbor (the
// torchvision default for RandomRotation/RandomAffine, which the reference
// relies on to keep the mask channel binary).
void warp_affine_chw(const float* src, float* dst, int c, int h, int w,
                     const double* M, int bilinear) {
    // invert [[a,b,tx],[d,e,ty]]
    const double a = M[0], b = M[1], tx = M[2];
    const double d = M[3], e = M[4], ty = M[5];
    const double det = a * e - b * d;
    const double ia = e / det, ib = -b / det;
    const double id = -d / det, ie = a / det;
    const double itx = -(ia * tx + ib * ty);
    const double ity = -(id * tx + ie * ty);
    const size_t plane = static_cast<size_t>(h) * w;

    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const double sx = ia * x + ib * y + itx;
            const double sy = id * x + ie * y + ity;
            if (bilinear) {
                const int x0 = static_cast<int>(std::floor(sx));
                const int y0 = static_cast<int>(std::floor(sy));
                const double fx = sx - x0, fy = sy - y0;
                for (int ch = 0; ch < c; ++ch) {
                    const float* p = src + ch * plane;
                    double acc = 0.0;
                    for (int dy2 = 0; dy2 <= 1; ++dy2) {
                        for (int dx2 = 0; dx2 <= 1; ++dx2) {
                            const int xx = x0 + dx2, yy = y0 + dy2;
                            if (xx < 0 || xx >= w || yy < 0 || yy >= h)
                                continue;
                            const double wgt =
                                (dx2 ? fx : 1.0 - fx) * (dy2 ? fy : 1.0 - fy);
                            acc += wgt * p[static_cast<size_t>(yy) * w + xx];
                        }
                    }
                    dst[ch * plane + static_cast<size_t>(y) * w + x] =
                        static_cast<float>(acc);
                }
            } else {
                // cv2 INTER_NEAREST rounding
                const int xx = static_cast<int>(std::floor(sx + 0.5));
                const int yy = static_cast<int>(std::floor(sy + 0.5));
                const bool inside = xx >= 0 && xx < w && yy >= 0 && yy < h;
                for (int ch = 0; ch < c; ++ch) {
                    dst[ch * plane + static_cast<size_t>(y) * w + x] =
                        inside ? src[ch * plane +
                                     static_cast<size_t>(yy) * w + xx]
                               : 0.0f;
                }
            }
        }
    }
}

// Horizontal / vertical flip of a CHW stack, in place into dst.
void flip_chw(const float* src, float* dst, int c, int h, int w,
              int horizontal, int vertical) {
    const size_t plane = static_cast<size_t>(h) * w;
    for (int ch = 0; ch < c; ++ch) {
        for (int y = 0; y < h; ++y) {
            const int sy = vertical ? h - 1 - y : y;
            for (int x = 0; x < w; ++x) {
                const int sx = horizontal ? w - 1 - x : x;
                dst[ch * plane + static_cast<size_t>(y) * w + x] =
                    src[ch * plane + static_cast<size_t>(sy) * w + sx];
            }
        }
    }
}

}  // extern "C"
