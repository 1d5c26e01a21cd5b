// Native JPEG decode + resize for the host input pipeline (a copy of
// icd_tpu/native/imageio.cpp, built by icd_tpu_torch/native/imageio.py).
//
// The reference's data loading rides torch's native DataLoader workers
// + PIL (reference: dataset.py:52-57, models/baseline.py:144-149); this
// is the icd_tpu native-loader equivalent. Two wins over PIL:
//  - libjpeg DCT scaling decodes directly at 1/2, 1/4, or 1/8 size when
//    the target is much smaller than the source (most COCO images),
//    skipping most of the IDCT work
//  - the resize is a separable triangle-filter (area-averaged bilinear)
//    matching PIL's antialiased BILINEAR, in single-pass C++
//
// C ABI for ctypes; thread-safe (no globals), releases the GIL from
// Python, so a thread pool scales across cores.

#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared first
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// PIL-compatible antialiased bilinear: separable triangle filter with
// support scaled by the downscale ratio.
void resize_triangle(const std::vector<uint8_t>& src, int sh, int sw,
                     uint8_t* dst, int dh, int dw) {
  const int C = 3;
  const double xr = static_cast<double>(sw) / dw;
  const double yr = static_cast<double>(sh) / dh;

  auto build = [](int dlen, int slen, double ratio,
                  std::vector<int>& starts, std::vector<int>& counts,
                  std::vector<double>& weights) {
    const double support = ratio < 1.0 ? 1.0 : ratio;
    const int kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
    starts.resize(dlen);
    counts.resize(dlen);
    weights.assign(static_cast<size_t>(dlen) * kmax, 0.0);
    for (int i = 0; i < dlen; ++i) {
      const double center = (i + 0.5) * ratio;
      int lo = static_cast<int>(std::floor(center - support));
      int hi = static_cast<int>(std::ceil(center + support));
      if (lo < 0) lo = 0;
      if (hi > slen) hi = slen;
      double total = 0.0;
      const double inv = ratio < 1.0 ? 1.0 : 1.0 / ratio;
      int n = 0;
      for (int s = lo; s < hi; ++s) {
        const double x = (s + 0.5 - center) * inv;
        const double wgt = x > -1.0 && x < 1.0 ? 1.0 - std::fabs(x) : 0.0;
        weights[static_cast<size_t>(i) * kmax + n] = wgt;
        total += wgt;
        ++n;
      }
      if (total > 0) {
        for (int j = 0; j < n; ++j)
          weights[static_cast<size_t>(i) * kmax + j] /= total;
      }
      starts[i] = lo;
      counts[i] = n;
    }
    return kmax;
  };

  std::vector<int> xs_start, xs_count, ys_start, ys_count;
  std::vector<double> xw, yw;
  const int xkmax = build(dw, sw, xr, xs_start, xs_count, xw);
  const int ykmax = build(dh, sh, yr, ys_start, ys_count, yw);

  // Horizontal pass: (sh, sw) -> (sh, dw), float intermediate.
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * C);
  for (int r = 0; r < sh; ++r) {
    const uint8_t* row = src.data() + static_cast<size_t>(r) * sw * C;
    float* out = tmp.data() + static_cast<size_t>(r) * dw * C;
    for (int i = 0; i < dw; ++i) {
      double acc[3] = {0, 0, 0};
      const double* wrow = xw.data() + static_cast<size_t>(i) * xkmax;
      const int lo = xs_start[i];
      for (int j = 0; j < xs_count[i]; ++j) {
        const double wgt = wrow[j];
        const uint8_t* px = row + static_cast<size_t>(lo + j) * C;
        acc[0] += wgt * px[0];
        acc[1] += wgt * px[1];
        acc[2] += wgt * px[2];
      }
      out[i * C + 0] = static_cast<float>(acc[0]);
      out[i * C + 1] = static_cast<float>(acc[1]);
      out[i * C + 2] = static_cast<float>(acc[2]);
    }
  }
  // Vertical pass: (sh, dw) -> (dh, dw), round to uint8.
  for (int i = 0; i < dh; ++i) {
    uint8_t* out = dst + static_cast<size_t>(i) * dw * C;
    const double* wrow = yw.data() + static_cast<size_t>(i) * ykmax;
    const int lo = ys_start[i];
    for (int c = 0; c < dw * C; ++c) {
      double acc = 0;
      for (int j = 0; j < ys_count[i]; ++j)
        acc += wrow[j] * tmp[static_cast<size_t>(lo + j) * dw * C + c];
      acc = acc < 0 ? 0 : (acc > 255 ? 255 : acc);
      out[c] = static_cast<uint8_t>(acc + 0.5);
    }
  }
}

}  // namespace

// All libjpeg work happens here with only POD locals, so the
// error-handler longjmp never skips a live C++ destructor; the pixel
// buffer is owned by the caller and survives the jump.
static int decode_impl(const uint8_t* data, uint64_t len,
                       uint64_t out_h, uint64_t out_w,
                       std::vector<uint8_t>* buf, int* sh, int* sw) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr -> RGB

  // DCT scaling: decode at the smallest 1/2^k size that still covers
  // the target (keeps the triangle filter a downscale).
  unsigned denom = 1;
  while (denom < 8 &&
         cinfo.image_width / (denom * 2) >= out_w &&
         cinfo.image_height / (denom * 2) >= out_h)
    denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  *sw = cinfo.output_width;
  *sh = cinfo.output_height;
  buf->resize(static_cast<size_t>(*sw) * *sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = buf->data()
        + static_cast<size_t>(cinfo.output_scanline) * *sw * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

extern "C" {

// Decode a JPEG and resize to (out_h, out_w) RGB. Returns 1 on success.
// out must hold out_h * out_w * 3 bytes.
int icd_decode_resize_jpeg(const uint8_t* data, uint64_t len,
                           uint64_t out_h, uint64_t out_w, uint8_t* out) {
  std::vector<uint8_t> buf;
  int sh = 0, sw = 0;
  if (!decode_impl(data, len, out_h, out_w, &buf, &sh, &sw)) return 0;
  resize_triangle(buf, sh, sw, out,
                  static_cast<int>(out_h), static_cast<int>(out_w));
  return 1;
}

}  // extern "C"
