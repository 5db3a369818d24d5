// Host JPEG decode + resize of the port's input pipeline (a copy of
// din_tpu/native/din_loader.cc, same C ABI and the same arithmetic, so the
// two packages decode a frame to the same bytes when built alike).
//
// libjpeg decodes with DCT-domain prescaling (scale_num/denom picks the
// largest power-of-two downscale that stays >= the target size, skipping
// most of the IDCT work) and a half-pixel bilinear resize finishes the
// frame; a batch is decoded by n_threads std::threads, outside Python's
// interpreter lock (ctypes releases it for the call).
//
// C ABI (ctypes-friendly):
//   din_decode_resize(buf, len, out_h, out_w, out_rgb)        -> 0 on ok
//   din_decode_resize_batch(bufs, lens, n, out_h, out_w, out, n_threads)
//                                                    -> number of failures
//
// Build (din_tpu_torch/native/__init__.py does it at first use, into
// build/host_loader/<hash>/):
//   g++ -O3 -shared -fPIC din_loader.cc -ljpeg -o libdin_loader.so

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize, half-pixel centers, RGB u8.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * scale_x - 0.5f;
    if (sx < 0) sx = 0;
    if (sx > sw - 1) sx = static_cast<float>(sw - 1);
    int x0 = static_cast<int>(sx);
    x0s[x] = x0;
    x1s[x] = x0 + 1 < sw ? x0 + 1 : sw - 1;
    fxs[x] = sx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > sh - 1) sy = static_cast<float>(sh - 1);
    int y0 = static_cast<int>(sy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float fy = sy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int x0 = x0s[x] * 3, x1 = x1s[x] * 3;
      const float fx = fxs[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 + c] + fx * (r0[x1 + c] - r0[x0 + c]);
        float bot = r1[x0 + c] + fx * (r1[x1 + c] - r1[x0 + c]);
        float v = top + fy * (bot - top);
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on decode failure.
int din_decode_resize(const uint8_t* buf, long len, int out_h, int out_w,
                      uint8_t* out_rgb) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: largest 1/2^k that stays >= the target.
  int denom = 1;
  while (denom < 8 &&
         (static_cast<int>(cinfo.image_height) / (denom * 2) >= out_h) &&
         (static_cast<int>(cinfo.image_width) / (denom * 2) >= out_w)) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  const int comps = cinfo.output_components;
  if (comps != 3) {  // grayscale etc. — expand later if needed
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  std::vector<uint8_t> decoded(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() +
        static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  resize_bilinear(decoded.data(), sh, sw, out_rgb, out_h, out_w);
  return 0;
}

// Decodes n JPEGs into out (n * out_h * out_w * 3, contiguous) with
// n_threads workers.  Returns the number of failures.
int din_decode_resize_batch(const uint8_t** bufs, const long* lens, int n,
                            int out_h, int out_w, uint8_t* out,
                            int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int> failures(n_threads, 0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      int rc = din_decode_resize(bufs[i], lens[i], out_h, out_w,
                                 out + frame_bytes * i);
      if (rc) failures[tid]++;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

}  // extern "C"
