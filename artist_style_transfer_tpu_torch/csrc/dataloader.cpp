// Native data-loader: multithreaded JPEG decode + resize for the host-side
// input pipeline.
//
// The reference decodes its corpora serially through cv2.imread
// (reference dataset.py:97, :140; inference.py:87). This library is the
// TPU-native build's equivalent of that native dependency: a std::thread
// pool over libjpeg-turbo with two resampling modes matching the
// framework's (and the reference's) semantics:
//
//   mode 0: bilinear resize, half-pixel centers, edge clamp, NO antialias
//           (cv2.resize INTER_LINEAR semantics, dataset.py:101)
//   mode 1: centered anisotropic affine rescale with zero border
//           (cv2.warpAffine of the reference `rescale`, dataset.py:36-52)
//
// Output: BGR float32 HWC in caller-provided buffers (the framework's
// canonical layout; libjpeg emits BGR directly via JCS_EXT_BGR).
//
// C ABI for ctypes; no Python.h dependency.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to BGR uint8 HWC. Returns false on any failure
// (unreadable file, corrupt stream) — callers skip, like the reference's
// `if im is None: continue` (dataset.py:98-99).
bool decode_jpeg(const char* path, std::vector<uint8_t>& pixels, int& h, int& w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_EXT_BGR;  // canonical BGR, zero-cost here
  jpeg_start_decompress(&cinfo);
  h = static_cast<int>(cinfo.output_height);
  w = static_cast<int>(cinfo.output_width);
  if (h <= 0 || w <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  pixels.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// cv2.resize INTER_LINEAR: half-pixel centers, edge clamp, no antialias.
void resize_bilinear(const uint8_t* src, int sh, int sw, float* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      const uint8_t* p00 = src + (static_cast<size_t>(y0c) * sw + x0c) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0c) * sw + x1c) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1c) * sw + x0c) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1c) * sw + x1c) * 3;
      float* out = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1.0f - wx) + p01[c] * wx;
        float bot = p10[c] * (1.0f - wx) + p11[c] * wx;
        out[c] = top * (1.0f - wy) + bot * wy;
      }
    }
  }
}

// Reference `rescale` (dataset.py:36-52): dst = s*src + t about the centre,
// bilinear, zero border (cv2.warpAffine defaults). Inverse-mapped.
void affine_rescale(const uint8_t* src, int sh, int sw, float* dst, int dh, int dw) {
  const float h_s = static_cast<float>(dh) / sh;
  const float w_s = static_cast<float>(dw) / sw;
  const float ty = dh / 2.0f - h_s * sh / 2.0f;
  const float tx = dw / 2.0f - w_s * sw / 2.0f;
  for (int y = 0; y < dh; ++y) {
    float fy = (y - ty) / h_s;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x - tx) / w_s;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      float* out = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int dy = 0; dy < 2; ++dy) {
          int yy = y0 + dy;
          if (yy < 0 || yy >= sh) continue;
          float wyy = dy ? wy : 1.0f - wy;
          for (int dx = 0; dx < 2; ++dx) {
            int xx = x0 + dx;
            if (xx < 0 || xx >= sw) continue;
            float wxx = dx ? wx : 1.0f - wx;
            acc += wyy * wxx * src[(static_cast<size_t>(yy) * sw + xx) * 3 + c];
          }
        }
        out[c] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode `n` JPEGs and resample each into out[i] (dh*dw*3 float32, BGR HWC).
// mode: 0 = bilinear resize (cv2.resize), 1 = centered affine rescale.
// ok[i] = 1 on success, 0 on decode failure (output left zeroed).
// Returns the number of successes. Thread count 0 = hardware concurrency.
int ast_decode_batch(const char** paths, int n, float* out, int dh, int dw,
                     int mode, unsigned char* ok, int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = n > 0 ? n : 1;

  std::atomic<int> next(0), successes(0);
  const size_t stride = static_cast<size_t>(dh) * dw * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    int h = 0, w = 0;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      float* dst = out + stride * i;
      std::memset(dst, 0, stride * sizeof(float));
      ok[i] = 0;
      if (!decode_jpeg(paths[i], pixels, h, w)) continue;
      if (mode == 0) {
        resize_bilinear(pixels.data(), h, w, dst, dh, dw);
      } else {
        affine_rescale(pixels.data(), h, w, dst, dh, dw);
      }
      ok[i] = 1;
      successes.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return successes.load();
}

// Resample an in-memory BGR uint8 HWC image (for parity tests / non-JPEG).
void ast_resample(const unsigned char* src, int sh, int sw, float* dst,
                  int dh, int dw, int mode) {
  if (mode == 0) {
    resize_bilinear(src, sh, sw, dst, dh, dw);
  } else {
    affine_rescale(src, sh, sw, dst, dh, dw);
  }
}

}  // extern "C"
