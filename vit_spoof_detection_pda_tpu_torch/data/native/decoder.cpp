// Native image decode + resize (and JPEG encode) for the host data
// pipeline: the port's own copy of the JAX package's
// data/native/decoder.cpp, the same code, so both packages decode and
// encode the same bytes.
//
// The reference feeds its GPU from 28 forked Python workers running PIL
// decode + CPU transforms (reference train_advanced.py:554-573).  Here:
// libjpeg decode with DCT-domain prescaling (decode directly at ~target
// resolution instead of full size), libpng decode, and a fused bilinear
// resize straight into the caller's buffer.  Exposed as a C ABI consumed
// from Python via ctypes; the GIL is released for the whole call, so a
// small thread pool keeps the card fed without process forking.
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -ljpeg -lpng -o libdecoder.so
// (driven by data/native/__init__.py, into the port's build directory).

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// PIL-exact BILINEAR resize, RGB u8, HWC.
//
// Replicates Pillow's ImagingResample for 8-bit images (Resample.c):
// separable triangle filter whose support scales with the downscale
// factor (antialiasing), double-precision coefficient build, the same
// fixed-point quantization (PRECISION_BITS = 22) and the same clip8
// rounding, horizontal pass first into a u8 intermediate.  From an
// identical source this is BIT-IDENTICAL to Image.resize(...,
// Image.BILINEAR) — so the PNG path matches PIL exactly, and the JPEG
// path differs only by libjpeg's DCT-domain prescale.  The previous 2-tap
// half-pixel kernel (no antialiasing) drifted up to 15 u8 levels on
// downscales.
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc, for one axis.
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int>* kk) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle support = 1
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double total = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = triangle_filter((x + xmin - center + 0.5) * ss);
      total += w[x];
    }
    int* k = kk->data() + static_cast<size_t>(xx) * ksize;
    for (int x = 0; x < xmax; ++x) {
      const double c = total != 0.0 ? w[x] / total : w[x];
      k[x] = static_cast<int>(c < 0 ? c * (1 << kPrecisionBits) - 0.5
                                    : c * (1 << kPrecisionBits) + 0.5);
    }
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  return ksize;
}

void bilinear_resize(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  // horizontal pass: [sh, sw] -> [sh, dw] (u8 intermediate, as PIL)
  std::vector<int> bounds, kk;
  const uint8_t* hsrc = src;
  std::vector<uint8_t> tmp;
  if (dw != sw) {
    const int ksize = precompute_coeffs(sw, dw, &bounds, &kk);
    tmp.resize(static_cast<size_t>(sh) * dw * 3);
    for (int y = 0; y < sh; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
      uint8_t* out = tmp.data() + static_cast<size_t>(y) * dw * 3;
      for (int xx = 0; xx < dw; ++xx) {
        const int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
        const int* k = kk.data() + static_cast<size_t>(xx) * ksize;
        int s0 = 1 << (kPrecisionBits - 1);
        int s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* p = row + static_cast<size_t>(x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        out[xx * 3 + 0] = clip8(s0);
        out[xx * 3 + 1] = clip8(s1);
        out[xx * 3 + 2] = clip8(s2);
      }
    }
    hsrc = tmp.data();
  }
  // vertical pass: [sh, dw] -> [dh, dw]
  if (dh != sh) {
    const int ksize = precompute_coeffs(sh, dh, &bounds, &kk);
    for (int yy = 0; yy < dh; ++yy) {
      const int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
      const int* k = kk.data() + static_cast<size_t>(yy) * ksize;
      uint8_t* out = dst + static_cast<size_t>(yy) * dw * 3;
      for (int x = 0; x < dw * 3; ++x) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; ++y)
          ss += hsrc[static_cast<size_t>(y + ymin) * dw * 3 + x] * k[y];
        out[x] = clip8(ss);
      }
    }
  } else {
    std::memcpy(dst, hsrc, static_cast<size_t>(dh) * dw * 3);
  }
}

// Resize-with-mode: mode 0 = exact (target x target); mode 1 = scale the
// shorter side to target then center-crop the longer side.
void resize_into(const uint8_t* src, int sh, int sw, uint8_t* out,
                 int target, int mode) {
  if (mode == 0) {
    bilinear_resize(src, sh, sw, out, target, target);
    return;
  }
  int nh, nw;
  if (sh <= sw) {
    nh = target;
    nw = std::max(1, static_cast<int>(std::lround(
        static_cast<double>(sw) * target / sh)));
  } else {
    nw = target;
    nh = std::max(1, static_cast<int>(std::lround(
        static_cast<double>(sh) * target / sw)));
  }
  std::vector<uint8_t> tmp(static_cast<size_t>(nh) * nw * 3);
  bilinear_resize(src, sh, sw, tmp.data(), nh, nw);
  int top = (nh - target) / 2;
  int left = (nw - target) / 2;
  for (int y = 0; y < target; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * target * 3,
                tmp.data() + (static_cast<size_t>(y + top) * nw + left) * 3,
                static_cast<size_t>(target) * 3);
  }
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg(const uint8_t* data, size_t len, int target, int mode,
                uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  // declared BEFORE setjmp: the error longjmp lands at the setjmp
  // below and the function returns NORMALLY, so this destructor runs.
  // Declared after, the longjmp would jump across the live vector's
  // scope and the early return would skip its destructor — UB per the
  // standard and a decode-buffer heap leak per corrupt file (the
  // pipeline re-decodes every epoch).
  std::vector<uint8_t> buf;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescale: decode at the smallest 1/1..1/8 scale whose
  // shorter side still covers `target` — the big CPU win vs full decode.
  int shorter = std::min(cinfo.image_width, cinfo.image_height);
  int denom = 1;
  while (denom < 8 && shorter / (denom * 2) >= target) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);

  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  const int ch = cinfo.output_components;
  if (ch != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  buf.resize(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline)
                   * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_into(buf.data(), sh, sw, out, target, mode);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------
struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
  }
  std::memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

int decode_png(const uint8_t* data, size_t len, int target, int mode,
               uint8_t* out) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return 2;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  // before setjmp for the same destructor-skipping reason as the
  // JPEG path's buf (png_error longjmps here from png_read_image)
  std::vector<uint8_t> buf;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  // normalize everything to 8-bit RGB
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  buf.resize(static_cast<size_t>(h) * w * 3);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = buf.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  resize_into(buf.data(), static_cast<int>(h), static_cast<int>(w), out,
              target, mode);
  return 0;
}

}  // namespace

extern "C" {

// Decode JPEG or PNG bytes (sniffed by magic) into out[target*target*3]
// RGB u8.  mode: 0 = exact resize, 1 = shorter-side + center crop.
// Returns 0 on success.
int pad_decode_resize(const uint8_t* data, size_t len, int target,
                      int mode, uint8_t* out) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, target, mode, out);
  if (len >= 8 && !png_sig_cmp(data, 0, 8))
    return decode_png(data, len, target, mode, out);
  return 4;  // unknown format
}

// Encode an RGB u8 HWC image to JPEG (the materializer's writeback —
// reference augment_data.py:159-179 does this per image on the Python
// side through PIL; here the whole compress runs with the GIL released).
// *out_buf is malloc'd by libjpeg's jpeg_mem_dest; free via pad_free.
// Returns 0 on success.
int pad_encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                    unsigned char** out_buf, unsigned long* out_size) {
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  *out_buf = nullptr;
  *out_size = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (*out_buf) { free(*out_buf); *out_buf = nullptr; }
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out_buf, out_size);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

void pad_free(void* p) { free(p); }

}  // extern "C"
