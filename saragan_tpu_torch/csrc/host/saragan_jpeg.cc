// Native JPEG decode + antialiased resize for the 2-D pipeline (the port's own
// copy of the JAX package's runtime/saragan_jpeg.cc).
//
// libjpeg decode + a PIL-compatible antialiased triangle ("BILINEAR")
// separable resize + [-1, 1] normalization + CHW layout, batched over a
// thread pool, entirely off the GIL.  saragan_tpu_torch/data/imagenet.py calls
// it through data/native.py; data/native.py::resize_triangle_plain is the
// plain PyTorch version of the resize.
//
// Compiled into the port's host library with -DSARAGAN_HAVE_JPEG -ljpeg when
// jpeglib.h is present (ops/_build.py probes); otherwise the stubs report
// that no libjpeg decoder was built and the pipeline decodes with PIL.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifdef SARAGAN_HAVE_JPEG

#include <csetjmp>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  // libjpeg's default error handler exit()s the process; longjmp back out
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG to uint8 (h, w, channels). Returns 0 on success.
int decode_jpeg_u8(const char* path, std::vector<uint8_t>& pixels, int* h,
                   int* w, int channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  // JCS_GRAYSCALE from YCbCr sources yields the Y (luma) channel, the same
  // ITU-R 601-2 weights PIL's convert('L') applies after an RGB decode.
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  const int row_bytes = cinfo.output_width * cinfo.output_components;
  if (cinfo.output_components != channels) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 3;
  }
  pixels.resize(static_cast<size_t>(row_bytes) * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// PIL-style antialiased triangle filter coefficients for one output index.
// (PIL Resample BILINEAR: support 1.0 scaled by max(in/out, 1).)
struct FilterRow {
  int xmin;
  std::vector<float> weights;
};

std::vector<FilterRow> build_filter(int in_size, int out_size) {
  std::vector<FilterRow> rows(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min<double>(in_size, std::ceil(center + support)));
    FilterRow& r = rows[i];
    r.xmin = xmin;
    r.weights.resize(xmax - xmin);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double t = std::abs((x + 0.5 - center) / filterscale);
      const double wgt = t < 1.0 ? 1.0 - t : 0.0;
      r.weights[x - xmin] = static_cast<float>(wgt);
      total += wgt;
    }
    if (total > 0.0)
      for (float& wgt : r.weights) wgt = static_cast<float>(wgt / total);
  }
  return rows;
}

// uint8 HWC -> normalized float CHW at (size, size).
void resize_normalize_chw(const std::vector<uint8_t>& src, int h, int w,
                          int channels, int size, float* out) {
  const auto fx = build_filter(w, size);
  const auto fy = build_filter(h, size);
  // horizontal pass: (h, size, channels) floats
  std::vector<float> tmp(static_cast<size_t>(h) * size * channels);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src.data() + static_cast<size_t>(y) * w * channels;
    for (int i = 0; i < size; ++i) {
      const FilterRow& fr = fx[i];
      for (int c = 0; c < channels; ++c) {
        float acc = 0.f;
        for (size_t k = 0; k < fr.weights.size(); ++k)
          acc += fr.weights[k] * row[(fr.xmin + k) * channels + c];
        tmp[(static_cast<size_t>(y) * size + i) * channels + c] = acc;
      }
    }
  }
  // vertical pass + normalize + CHW
  for (int j = 0; j < size; ++j) {
    const FilterRow& fr = fy[j];
    for (int i = 0; i < size; ++i) {
      for (int c = 0; c < channels; ++c) {
        float acc = 0.f;
        for (size_t k = 0; k < fr.weights.size(); ++k)
          acc += fr.weights[k] *
                 tmp[(static_cast<size_t>(fr.xmin + k) * size + i) * channels + c];
        out[(static_cast<size_t>(c) * size + j) * size + i] = acc / 127.5f - 1.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

int saragan_have_jpeg() { return 1; }

// Decode one JPEG to normalized CHW float32 at (channels, size, size).
int saragan_jpeg_decode(const char* path, float* out, int size, int channels) {
  if (channels != 1 && channels != 3) return 4;
  std::vector<uint8_t> pixels;
  int h = 0, w = 0;
  const int rc = decode_jpeg_u8(path, pixels, &h, &w, channels);
  if (rc) return rc;
  resize_normalize_chw(pixels, h, w, channels, size, out);
  return 0;
}

// Batched decode over a thread pool; out has n * channels * size * size
// floats. Returns 0 if every file decoded.
int saragan_jpeg_batch(const char** paths, int n, float* out, int size,
                       int channels, int num_threads) {
  if (n <= 0) return 0;
  const size_t item = static_cast<size_t>(channels) * size * size;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      if (saragan_jpeg_decode(paths[i], out + item * i, size, channels))
        failed.fetch_add(1);
    }
  };
  const int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load() ? 1 : 0;
}

}  // extern "C"

#else  // !SARAGAN_HAVE_JPEG

extern "C" {
int saragan_have_jpeg() { return 0; }
int saragan_jpeg_decode(const char*, float*, int, int) { return -1; }
int saragan_jpeg_batch(const char**, int, float*, int, int, int) { return -1; }
}

#endif
