// cor_tpu_torch native data plane: Pillow-parity bilinear resample +
// normalize, and the PNG scanline unfilter.
//
// The manifest dataset decodes and resizes every sample on the host, on the
// loader's threads: one C call per image does the resize (bit-exact Pillow
// BILINEAR, its fixed-point 8-bit pipeline) and the /255 + mean/std
// normalize, and one call undoes a PNG's scanline filters (Average and Paeth
// depend on the pixel to their left, which a Python loop walks far too
// slowly for a 1024 x 1024 image). ctypes releases the GIL around each call.
//
// Resample parity notes (Pillow src/libImaging/Resample.c):
// - separable two-pass resample, HORIZONTAL first, the intermediate
//   quantized to uint8 (part of PIL's observable output, so reproduced);
// - triangle filter, support 1.0, widened by the scale factor on downscale;
// - per-window coefficients in double, normalized, then converted to int
//   fixed point with PRECISION_BITS = 32 - 8 - 2 and round-half-away;
// - accumulation starts at 1 << (PRECISION_BITS - 1) and clips via shift.
//
// Built by cor_tpu_torch/native/preproc.py with the host's g++ at first use.
// C ABI only.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

// int32 accumulators, as Pillow's own `int ss0` in
// ImagingResampleHorizontal_8bpc: worst case 255 * sum(kk) + rounding
// ~ 255 * 2^22 * (1 + eps) < 2^31.
inline uint8_t clip8(int32_t in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> PRECISION_BITS);
}

inline double triangle_filter(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc for one axis.
struct Coeffs {
    int ksize = 0;
    std::vector<int> bounds;  // [out, 2] = (xmin, count)
    std::vector<int> kk;      // [out, ksize] fixed point
};

Coeffs precompute(int in_size, int out_size) {
    Coeffs c;
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // triangle support = 1.0
    c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    c.bounds.resize(out_size * 2);
    c.kk.resize(static_cast<size_t>(out_size) * c.ksize);
    std::vector<double> k(c.ksize);
    double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double ww = 0.0;
        for (int x = 0; x < xmax; ++x) {
            double w = triangle_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; ++x)
            if (ww != 0.0) k[x] /= ww;
        for (int x = 0; x < xmax; ++x) {
            double v = k[x] * (1 << PRECISION_BITS);
            c.kk[static_cast<size_t>(xx) * c.ksize + x] =
                static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
        }
        for (int x = xmax; x < c.ksize; ++x)
            c.kk[static_cast<size_t>(xx) * c.ksize + x] = 0;
        c.bounds[xx * 2 + 0] = xmin;
        c.bounds[xx * 2 + 1] = xmax;
    }
    return c;
}

// horizontal pass: [h, w, ch] u8 -> [h, ow, ch] u8
void resample_h(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int ow,
                const Coeffs& c) {
    for (int yy = 0; yy < h; ++yy) {
        const uint8_t* row = src + static_cast<size_t>(yy) * w * ch;
        uint8_t* orow = dst + static_cast<size_t>(yy) * ow * ch;
        for (int xx = 0; xx < ow; ++xx) {
            int xmin = c.bounds[xx * 2], xmax = c.bounds[xx * 2 + 1];
            const int* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
            for (int b = 0; b < ch; ++b) {
                int32_t ss0 = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; ++x)
                    ss0 += row[(xmin + x) * ch + b] * k[x];
                orow[xx * ch + b] = clip8(ss0);
            }
        }
    }
}

// vertical pass: [h, w, ch] u8 -> [oh, w, ch] u8, per-tap AXPY over a
// contiguous int32 row accumulator (the compiler vectorizes the inner loop)
void resample_v(const uint8_t* src, int h, int w, int ch, uint8_t* dst, int oh,
                const Coeffs& c) {
    (void)h;
    const int row_elems = w * ch;
    std::vector<int32_t> acc(row_elems);
    for (int yy = 0; yy < oh; ++yy) {
        int ymin = c.bounds[yy * 2], ymax = c.bounds[yy * 2 + 1];
        const int* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
        for (int xx = 0; xx < row_elems; ++xx)
            acc[xx] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; ++y) {
            const uint8_t* srow = src + static_cast<size_t>(ymin + y) * row_elems;
            const int32_t ky = k[y];
            for (int xx = 0; xx < row_elems; ++xx)
                acc[xx] += srow[xx] * ky;
        }
        uint8_t* orow = dst + static_cast<size_t>(yy) * row_elems;
        for (int xx = 0; xx < row_elems; ++xx)
            orow[xx] = clip8(acc[xx]);
    }
}

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Pillow-BILINEAR-parity resize of an interleaved u8 image.
void cor_resize_bilinear_u8(const uint8_t* src, int h, int w, int ch,
                            uint8_t* dst, int oh, int ow) {
    if (h == oh && w == ow) {
        std::memcpy(dst, src, static_cast<size_t>(h) * w * ch);
        return;
    }
    Coeffs ch_coef = precompute(w, ow);
    Coeffs cv_coef = precompute(h, oh);
    if (w != ow && h != oh) {
        std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * ch);
        resample_h(src, h, w, ch, tmp.data(), ow, ch_coef);
        resample_v(tmp.data(), h, ow, ch, dst, oh, cv_coef);
    } else if (w != ow) {
        resample_h(src, h, w, ch, dst, ow, ch_coef);
    } else {
        resample_v(src, h, w, ch, dst, oh, cv_coef);
    }
}

// resize + (x/255 - mean)/std into float32 HWC (mean/std of length ch; pass
// zeros/ones for plain [0, 1] masks). The scale and shift are rounded
// separately (built with -ffp-contract=off), as the reference's build is.
void cor_resize_normalize_f32(const uint8_t* src, int h, int w, int ch,
                              float* dst, int oh, int ow, const float* mean,
                              const float* stdv) {
    std::vector<uint8_t> resized(static_cast<size_t>(oh) * ow * ch);
    cor_resize_bilinear_u8(src, h, w, ch, resized.data(), oh, ow);
    const float inv255 = 1.0f / 255.0f;
    std::vector<float> scale(ch), shift(ch);
    for (int b = 0; b < ch; ++b) {
        scale[b] = inv255 / stdv[b];
        shift[b] = mean[b] / stdv[b];
    }
    size_t n = static_cast<size_t>(oh) * ow;
    for (size_t i = 0; i < n; ++i)
        for (int b = 0; b < ch; ++b)
            dst[i * ch + b] = resized[i * ch + b] * scale[b] - shift[b];
}

// Undo a non-interlaced PNG's scanline filters (types 0-4: None, Sub, Up,
// Average, Paeth). raw holds h rows of 1 + rowbytes bytes (the filter type,
// then the filtered row), out receives h rows of rowbytes bytes; bpp is the
// bytes of one pixel (1 for bit depths below 8). Returns 0, or the 1-based
// row whose filter type is not 0-4.
int cor_png_unfilter(const uint8_t* raw, int h, long long rowbytes, int bpp,
                     uint8_t* out) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < h; ++y) {
        const uint8_t* in = raw + static_cast<size_t>(y) * (rowbytes + 1);
        const int type = in[0];
        ++in;
        uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
        switch (type) {
            case 0:
                std::memcpy(cur, in, rowbytes);
                break;
            case 1:
                for (long long i = 0; i < rowbytes; ++i)
                    cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (long long i = 0; i < rowbytes; ++i)
                    cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
                break;
            case 3:
                for (long long i = 0; i < rowbytes; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (long long i = 0; i < rowbytes; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
        prev = cur;
    }
    return 0;
}

}  // extern "C"
