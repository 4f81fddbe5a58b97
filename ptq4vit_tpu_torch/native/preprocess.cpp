// Native data plane: JPEG decode + Pillow-compatible bicubic resize +
// center crop + normalize -> float32 CHW.
//
// The eval input pipeline is the one genuinely host-bound stage of the
// framework (the reference relies on torchvision/PIL workers,
// utils/datasets.py in hahnyuan/PTQ4ViT).  This library reproduces
// Pillow's resample bit-for-bit (same fixed-point coefficients, same
// clip8 rounding, horizontal-then-vertical pass order, libjpeg islow
// decode) so the native fast path changes throughput, not pixels.
//
// Build: g++ -O3 -shared -fPIC preprocess.cpp -ljpeg -o libptq4vitpp.so
// (driven by ptq4vit_tpu_torch/native/__init__.py, which builds it into
// ptq4vit_tpu_torch/_build/; plain C ABI for ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>

namespace {

// ---- Pillow-compatible bicubic resample (Resample.c semantics) ----------

constexpr int PRECISION_BITS = 32 - 8 - 2;

static inline double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}
constexpr double BICUBIC_SUPPORT = 2.0;

static inline uint8_t clip8(int64_t in) {
    if (in >= (1LL << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> PRECISION_BITS);
}

// Precompute fixed-point coefficients for one axis (Pillow
// precompute_coeffs + normalize_coeffs_8bpc).
static int precompute_coeffs(int in_size, int out_size,
                             std::vector<int>& bounds,
                             std::vector<int32_t>& kk) {
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = BICUBIC_SUPPORT * filterscale;
    int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    std::vector<double> w(ksize);
    bounds.resize(out_size * 2);
    kk.assign(static_cast<size_t>(out_size) * ksize, 0);

    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; x++) {
            double wgt = bicubic_filter((x + xmin - center + 0.5) * ss);
            w[x] = wgt;
            ww += wgt;
        }
        for (int x = 0; x < xmax; x++) w[x] /= ww;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
        int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
        for (int x = 0; x < xmax; x++) {
            double v = w[x] * (1 << PRECISION_BITS);
            k[x] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
        }
    }
    return ksize;
}

// rgb: interleaved 3-channel uint8, h rows x w cols -> out (out_w x h)
static void resample_horizontal(const uint8_t* rgb, int w, int h, int out_w,
                                const std::vector<int>& bounds,
                                const std::vector<int32_t>& kk, int ksize,
                                uint8_t* out) {
    for (int y = 0; y < h; y++) {
        const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
        uint8_t* orow = out + static_cast<size_t>(y) * out_w * 3;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
            const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
            int64_t s0 = 1LL << (PRECISION_BITS - 1), s1 = s0, s2 = s0;
            for (int x = 0; x < xmax; x++) {
                const uint8_t* p = row + static_cast<size_t>(x + xmin) * 3;
                s0 += static_cast<int64_t>(p[0]) * k[x];
                s1 += static_cast<int64_t>(p[1]) * k[x];
                s2 += static_cast<int64_t>(p[2]) * k[x];
            }
            orow[xx * 3 + 0] = clip8(s0);
            orow[xx * 3 + 1] = clip8(s1);
            orow[xx * 3 + 2] = clip8(s2);
        }
    }
}

static void resample_vertical(const uint8_t* rgb, int w, int h, int out_h,
                              const std::vector<int>& bounds,
                              const std::vector<int32_t>& kk, int ksize,
                              uint8_t* out) {
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
        uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
        for (int x = 0; x < w * 3; x++) {
            int64_t s = 1LL << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                s += static_cast<int64_t>(
                         rgb[static_cast<size_t>(y + ymin) * w * 3 + x]) * k[y];
            orow[x] = clip8(s);
        }
    }
}

// Pillow-order (horizontal then vertical) full resize of interleaved RGB.
static std::vector<uint8_t> resize_bicubic(const uint8_t* rgb, int w, int h,
                                           int out_w, int out_h) {
    std::vector<int> bounds;
    std::vector<int32_t> kk;
    std::vector<uint8_t> tmp;
    const uint8_t* src = rgb;
    int cur_w = w;
    if (out_w != w) {
        int ksize = precompute_coeffs(w, out_w, bounds, kk);
        tmp.resize(static_cast<size_t>(out_w) * h * 3);
        resample_horizontal(src, w, h, out_w, bounds, kk, ksize, tmp.data());
        src = tmp.data();
        cur_w = out_w;
    }
    std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h * 3);
    if (out_h != h) {
        int ksize = precompute_coeffs(h, out_h, bounds, kk);
        resample_vertical(src, cur_w, h, out_h, bounds, kk, ksize, out.data());
    } else {
        std::memcpy(out.data(), src, out.size());
    }
    return out;
}

// ---- libjpeg decode (islow DCT, the PIL default -> identical pixels) ----

struct JpegErr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

static bool decode_jpeg(const uint8_t* buf, size_t len,
                        std::vector<uint8_t>& rgb, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    rgb.resize(static_cast<size_t>(*w) * *h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* rowp = rgb.data()
            + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
        jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// Shorter-side resize + center crop + normalize -> float32 CHW.
static int preprocess(const uint8_t* rgb, int w, int h, int scale_size,
                      int crop, const float* mean, const float* std_,
                      float* out) {
    int ow, oh;  // torchvision Resize(shorter side) semantics
    if (w <= h) {
        ow = scale_size;
        oh = static_cast<int>(static_cast<int64_t>(scale_size) * h / w);
    } else {
        oh = scale_size;
        ow = static_cast<int>(static_cast<int64_t>(scale_size) * w / h);
    }
    std::vector<uint8_t> resized = resize_bicubic(rgb, w, h, ow, oh);
    // torchvision CenterCrop semantics (python round() = half-to-even)
    int left = static_cast<int>(std::nearbyint((ow - crop) / 2.0));
    int top = static_cast<int>(std::nearbyint((oh - crop) / 2.0));
    if (left < 0 || top < 0 || left + crop > ow || top + crop > oh) return 2;
    for (int c = 0; c < 3; c++) {
        float m = mean[c], s = std_[c];
        float* oc = out + static_cast<size_t>(c) * crop * crop;
        for (int y = 0; y < crop; y++) {
            const uint8_t* row = resized.data()
                + (static_cast<size_t>(top + y) * ow + left) * 3 + c;
            for (int x = 0; x < crop; x++)
                oc[static_cast<size_t>(y) * crop + x] =
                    (row[static_cast<size_t>(x) * 3] / 255.0f - m) / s;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode a JPEG buffer and preprocess.  Returns 0 ok, 1 decode error,
// 2 geometry error.  out: float32[3 * crop * crop] CHW.
int pp_decode_preprocess(const uint8_t* buf, size_t len, int scale_size,
                         int crop, const float* mean, const float* std_,
                         float* out) {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    if (!decode_jpeg(buf, len, rgb, &w, &h)) return 1;
    return preprocess(rgb.data(), w, h, scale_size, crop, mean, std_, out);
}

// Preprocess an already-decoded interleaved RGB uint8 image.
int pp_preprocess_rgb(const uint8_t* rgb, int w, int h, int scale_size,
                      int crop, const float* mean, const float* std_,
                      float* out) {
    return preprocess(rgb, w, h, scale_size, crop, mean, std_, out);
}

// Bare Pillow-compatible bicubic resize (for tests): interleaved RGB.
int pp_resize(const uint8_t* rgb, int w, int h, int out_w, int out_h,
              uint8_t* out) {
    std::vector<uint8_t> r = resize_bicubic(rgb, w, h, out_w, out_h);
    std::memcpy(out, r.data(), r.size());
    return 0;
}

}  // extern "C"
