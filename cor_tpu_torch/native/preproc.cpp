// cor_tpu_torch native data plane: Pillow-parity bilinear resample +
// normalize, the PNG scanline unfilter, and the training augmentation's
// colour jitter and bicubic rotation.
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
// The augmentation's two image operations reproduce Pillow's bits, so the
// card's machine (no Pillow) and a host with Pillow augment alike:
// - cor_color_enhance_u8: ImageEnhance's Brightness -> Contrast -> Color ->
//   Sharpness chain, each an Image.blend;
// - cor_affine_bicubic_u8: Image.transform(AFFINE, BICUBIC) with fill 0,
//   which Image.rotate(angle, BICUBIC) calls with its matrix (the matrix
//   itself is computed in Python, as Pillow computes it).
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

// ---------------------------------------------------------------------------
// ImageEnhance-parity colour jitter. Pillow's semantics:
// - every enhancer is Image.blend(degenerate, image, factor) in FLOAT32,
//   out = in1 + f * (in2 - in1), truncated to uint8; the clip to [0, 255]
//   happens only where the factor lies outside [0, 1] (extrapolation);
// - Brightness' degenerate is black, Contrast's a solid gray at
//   int(mean(L) + 0.5), Color's L replicated to RGB, Sharpness' the SMOOTH
//   3x3 filter (kernel [1,1,1,1,5,1,1,1,1] / 13, + 0.5 then truncated, the
//   border pixels copied);
// - L = (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16.
// ---------------------------------------------------------------------------

inline uint8_t blend1(uint8_t in1, uint8_t in2, float f, bool extrapolate) {
    float v = static_cast<float>(in1) +
              f * (static_cast<float>(in2) - static_cast<float>(in1));
    if (extrapolate) {
        if (v <= 0.0f) return 0;
        if (v >= 255.0f) return 255;
    }
    return static_cast<uint8_t>(v);
}

inline uint8_t lum(const uint8_t* px) {
    return static_cast<uint8_t>(
        (px[0] * 19595u + px[1] * 38470u + px[2] * 7471u + 0x8000u) >> 16);
}

void smooth3x3(const uint8_t* src, int h, int w, uint8_t* dst) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * 3);
    if (h < 3 || w < 3) return;
    const float k[9] = {1.f / 13, 1.f / 13, 1.f / 13, 1.f / 13, 5.f / 13,
                        1.f / 13, 1.f / 13, 1.f / 13, 1.f / 13};
    for (int y = 1; y < h - 1; ++y) {
        for (int x = 1; x < w - 1; ++x) {
            for (int b = 0; b < 3; ++b) {
                float ss = 0.0f;
                int ki = 0;
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dx = -1; dx <= 1; ++dx)
                        ss += k[ki++] *
                              src[(static_cast<size_t>(y + dy) * w + (x + dx)) * 3 + b];
                ss += 0.5f;
                uint8_t v;
                if (ss <= 0.0f) v = 0;
                else if (ss >= 255.0f) v = 255;
                else v = static_cast<uint8_t>(ss);
                dst[(static_cast<size_t>(y) * w + x) * 3 + b] = v;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Pillow's bicubic affine transform (Geometry.c, ImagingGenericTransform with
// bicubic_filter8 / bicubic_filter32RGB). Each output pixel's centre
// (x + 0.5, y + 0.5) maps through the matrix; a source point outside
// [0, w) x [0, h) gives 0 (the fill). Otherwise the point moves back by half
// a pixel, and four rows of four taps are interpolated with Pillow's cubic,
// p1 + d (p2 + d (p3 + d p4)) with p1 = v2, p2 = v3 - v1,
// p3 = 2 (v1 - v2) + v3 - v4, p4 = v2 - v1 + v4 - v3 (the a = -1 kernel):
// the columns clamped to the image, the first row clamped, a later row
// outside the image repeating the row before it. The result is clipped to
// [0, 255] and truncated.
// ---------------------------------------------------------------------------

inline double cubic(double v1, double v2, double v3, double v4, double d) {
    const double p1 = v2;
    const double p2 = -v1 + v3;
    const double p3 = 2 * (v1 - v2) + v3 - v4;
    const double p4 = -v1 + v2 - v3 + v4;
    return p1 + d * (p2 + d * (p3 + d * p4));
}

inline int clampi(int v, int n) { return v < 0 ? 0 : (v < n ? v : n - 1); }

inline int floor_int(double v) {
    return v < 0.0 ? static_cast<int>(std::floor(v)) : static_cast<int>(v);
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

// Pillow's ImageEnhance chain on an RGB u8 image: brightness -> contrast ->
// color -> sharpness. src and dst are [h, w, 3] and must not alias.
void cor_color_enhance_u8(const uint8_t* src, int h, int w, float f_bright,
                          float f_contrast, float f_color, float f_sharp,
                          uint8_t* dst) {
    const size_t n = static_cast<size_t>(h) * w;
    std::vector<uint8_t> tmp(n * 3);
    uint8_t* t = tmp.data();
    {  // brightness: blend(black, img, f)
        const bool ex = f_bright < 0.0f || f_bright > 1.0f;
        for (size_t i = 0; i < n * 3; ++i) t[i] = blend1(0, src[i], f_bright, ex);
    }
    {  // contrast: blend(solid gray at mean(L), img, f)
        uint64_t sum = 0;
        for (size_t i = 0; i < n; ++i) sum += lum(t + i * 3);
        const uint8_t mean = static_cast<uint8_t>(
            static_cast<int>(static_cast<double>(sum) / static_cast<double>(n) + 0.5));
        const bool ex = f_contrast < 0.0f || f_contrast > 1.0f;
        for (size_t i = 0; i < n * 3; ++i) t[i] = blend1(mean, t[i], f_contrast, ex);
    }
    {  // color: blend(L replicated, img, f)
        const bool ex = f_color < 0.0f || f_color > 1.0f;
        for (size_t i = 0; i < n; ++i) {
            const uint8_t g = lum(t + i * 3);
            for (int b = 0; b < 3; ++b) t[i * 3 + b] = blend1(g, t[i * 3 + b], f_color, ex);
        }
    }
    {  // sharpness: blend(SMOOTH(img), img, f); dst holds the smoothed image first
        smooth3x3(t, h, w, dst);
        const bool ex = f_sharp < 0.0f || f_sharp > 1.0f;
        for (size_t i = 0; i < n * 3; ++i) dst[i] = blend1(dst[i], t[i], f_sharp, ex);
    }
}

// Pillow's Image.transform(size (w, h), AFFINE, a, BICUBIC) of an
// interleaved u8 image with ch channels (1: "L", 3: "RGB"), black fill;
// a holds the six matrix entries. dst is [h, w, ch] and must not alias src.
void cor_affine_bicubic_u8(const uint8_t* src, int h, int w, int ch,
                           const double* a, uint8_t* dst) {
    const size_t stride = static_cast<size_t>(w) * ch;
    for (int y = 0; y < h; ++y) {
        uint8_t* out = dst + static_cast<size_t>(y) * stride;
        for (int x = 0; x < w; ++x, out += ch) {
            const double xo = x + 0.5, yo = y + 0.5;
            double xin = a[0] * xo + a[1] * yo + a[2];
            double yin = a[3] * xo + a[4] * yo + a[5];
            if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) {
                std::memset(out, 0, ch);
                continue;
            }
            xin -= 0.5;
            yin -= 0.5;
            int ix = floor_int(xin), iy = floor_int(yin);
            const double dx = xin - ix, dy = yin - iy;
            --ix;
            --iy;
            int xs[4];
            for (int k = 0; k < 4; ++k) xs[k] = clampi(ix + k, w) * ch;
            for (int b = 0; b < ch; ++b) {
                auto row = [&](int r) {
                    const uint8_t* in = src + static_cast<size_t>(r) * stride + b;
                    return cubic(in[xs[0]], in[xs[1]], in[xs[2]], in[xs[3]], dx);
                };
                const double v1 = row(clampi(iy, h));
                const double v2 = (iy + 1 >= 0 && iy + 1 < h) ? row(iy + 1) : v1;
                const double v3 = (iy + 2 >= 0 && iy + 2 < h) ? row(iy + 2) : v2;
                const double v4 = (iy + 3 >= 0 && iy + 3 < h) ? row(iy + 3) : v3;
                const double v = cubic(v1, v2, v3, v4, dy);
                out[b] = v <= 0.0 ? 0 : (v >= 255.0 ? 255 : static_cast<uint8_t>(v));
            }
        }
    }
}

}  // extern "C"
