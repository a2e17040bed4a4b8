// eventgrad-tpu-torch native data pipeline: the port's own copy of the JAX
// package's host library (native/dataio.cpp), the same code, so both
// packages read the same files into the same arrays, bit for bit.
//
// It stands in for the reference's C++ data layer: the OpenCV JPEG walker
// and label map of dcifar10/common/custom.hpp:26-122 and libtorch's MNIST
// reader (dmnist/cent/cent.cpp:53-56). The host's jobs are bulk IO,
// deterministic shard/shuffle planning and contiguous batch assembly;
// those are what this library does, exposed as a C ABI that
// eventgrad_tpu_torch/data/native.py binds with ctypes.
//
// Everything is deterministic: shuffling uses splitmix64 seeded by
// (seed, epoch), mirroring the reference's per-epoch reshuffle of its path
// list (custom.hpp:119-120) without the hidden global RNG.
//
// Build: eventgrad_tpu_torch/data/native.py builds it on first use with
// g++ (-O3 -march=native -fPIC -shared; -ljpeg -DEG_HAVE_LIBJPEG where
// <jpeglib.h> is found) into build/eventgrad_tpu_torch/<hash>/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#ifdef EG_HAVE_LIBJPEG
#include <setjmp.h>
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// deterministic RNG (splitmix64) — stable across platforms, unlike std::mt19937
// usage patterns that depend on distribution implementations.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// ---------------------------------------------------------------------------
// CIFAR-10 binary batches: each record is 1 label byte + 3072 CHW bytes.
// Returns number of samples written, or -1 on IO error.
// Output images are NHWC float32 in [0,1]; labels int32.
// ---------------------------------------------------------------------------
int64_t eg_load_cifar10_file(const char *path, float *images, int32_t *labels,
                             int64_t max_samples) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  const int64_t rec = 1 + 3 * 32 * 32;
  unsigned char buf[1 + 3 * 32 * 32];
  int64_t n = 0;
  const float inv = 1.0f / 255.0f;
  while (n < max_samples && fread(buf, 1, rec, f) == (size_t)rec) {
    labels[n] = (int32_t)buf[0];
    float *out = images + n * 32 * 32 * 3;
    // CHW uint8 -> HWC float
    for (int c = 0; c < 3; ++c) {
      const unsigned char *plane = buf + 1 + c * 32 * 32;
      for (int hw = 0; hw < 32 * 32; ++hw) {
        out[hw * 3 + c] = (float)plane[hw] * inv;
      }
    }
    ++n;
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// MNIST idx files (big-endian headers).
// images path + labels path -> NHWC float32 (normalized if mean/std given).
// Returns sample count or -1.
// ---------------------------------------------------------------------------
static uint32_t be32(const unsigned char *p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int64_t eg_load_mnist(const char *images_path, const char *labels_path,
                      float *images, int32_t *labels, int64_t max_samples,
                      float mean, float std) {
  FILE *fi = fopen(images_path, "rb");
  if (!fi) return -1;
  unsigned char hdr[16];
  if (fread(hdr, 1, 16, fi) != 16) { fclose(fi); return -1; }
  int64_t n = be32(hdr + 4), rows = be32(hdr + 8), cols = be32(hdr + 12);
  if (n > max_samples) n = max_samples;
  const int64_t px = rows * cols;
  unsigned char *row = new unsigned char[px];
  const float inv = 1.0f / 255.0f;
  const float s = (std > 0.0f) ? (1.0f / std) : 1.0f;
  for (int64_t i = 0; i < n; ++i) {
    if (fread(row, 1, px, fi) != (size_t)px) { n = i; break; }
    float *out = images + i * px;
    for (int64_t j = 0; j < px; ++j)
      out[j] = ((float)row[j] * inv - mean) * s;
  }
  delete[] row;
  fclose(fi);

  FILE *fl = fopen(labels_path, "rb");
  if (!fl) return -1;
  unsigned char lhdr[8];
  if (fread(lhdr, 1, 8, fl) != 8) { fclose(fl); return -1; }
  unsigned char *lab = new unsigned char[n];
  int64_t got = (int64_t)fread(lab, 1, n, fl);
  for (int64_t i = 0; i < got; ++i) labels[i] = (int32_t)lab[i];
  delete[] lab;
  fclose(fl);
  return (got < n) ? got : n;
}

// ---------------------------------------------------------------------------
// Distributed shard plan — the reference's samplers as one call
// (DistributedRandomSampler / DistributedSequentialSampler,
//  cent.cpp:59-60, decent.cpp:81-82): disjoint 1/N shards, optionally a
// global Fisher-Yates permutation reseeded per (seed, epoch).
// out_idx has space for n_ranks * (n / n_ranks) int64s.
// ---------------------------------------------------------------------------
void eg_shard_plan(int64_t n, int64_t n_ranks, uint64_t seed, uint64_t epoch,
                   int shuffle, int64_t *out_idx) {
  const int64_t per = n / n_ranks;
  const int64_t total = per * n_ranks;
  if (!shuffle) {
    for (int64_t i = 0; i < total; ++i) out_idx[i] = i;
    return;
  }
  int64_t *perm = new int64_t[n];
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  uint64_t st = seed * 0x9E3779B97F4A7C15ULL + epoch + 1;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(splitmix64(st) % (uint64_t)(i + 1));
    int64_t t = perm[i]; perm[i] = perm[j]; perm[j] = t;
  }
  memcpy(out_idx, perm, total * sizeof(int64_t));
  delete[] perm;
}

// ---------------------------------------------------------------------------
// Batch assembly: gather rows of a contiguous [n, elem] float array into
// [count, elem] following idx — the contiguous-marshalling role the reference
// performs per-tensor with flatten+memcpy (dcifar10/event/event.cpp:292-297),
// applied host-side to sample batches before one device_put.
// ---------------------------------------------------------------------------
void eg_gather(const float *src, int64_t elem, const int64_t *idx,
               int64_t count, float *dst) {
  const size_t bytes = (size_t)elem * sizeof(float);
  for (int64_t i = 0; i < count; ++i)
    memcpy(dst + i * elem, src + idx[i] * elem, bytes);
}

void eg_gather_i32(const int32_t *src, const int64_t *idx, int64_t count,
                   int32_t *dst) {
  for (int64_t i = 0; i < count; ++i) dst[i] = src[idx[i]];
}

// ---------------------------------------------------------------------------
// JPEG pipeline — the role OpenCV plays in the reference (cv::imread +
// cv::resize to image_size, custom.hpp:33-41), on libjpeg with a bilinear
// resampler (half-pixel centers, cv::INTER_LINEAR's mapping). Output is RGB
// interleaved; the reference reads BGR and reorders to RGB itself
// (custom.hpp:45-59) — same end state. The encoder exists for fixture
// generation and dataset export (no network egress in dev environments).
//
// Return codes: 0 ok; -1 io error; -2 image larger than caller capacity;
// -3 malformed stream; -9 built without libjpeg.
// ---------------------------------------------------------------------------
#ifdef EG_HAVE_LIBJPEG

struct EgJpegErr {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void eg_jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(((EgJpegErr *)cinfo->err)->jb, 1);  // default handler exit()s
}

int eg_jpeg_supported(void) { return 1; }

// header-only parse: dimensions without decoding (cheap — a few KB of IO)
int eg_jpeg_header(const char *path, int32_t *w, int32_t *h) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  struct jpeg_decompress_struct cinfo;
  EgJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = eg_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int32_t)cinfo.image_width;
  *h = (int32_t)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

int eg_jpeg_decode_file(const char *path, uint8_t *out, int32_t cap_w,
                        int32_t cap_h, int32_t *w, int32_t *h) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  struct jpeg_decompress_struct cinfo;
  EgJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = eg_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr all land as RGB
  jpeg_start_decompress(&cinfo);
  *w = (int32_t)cinfo.output_width;
  *h = (int32_t)cinfo.output_height;
  if (*w > cap_w || *h > cap_h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  const int stride = *w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

int eg_jpeg_encode_file(const char *path, const uint8_t *rgb, int32_t w,
                        int32_t h, int32_t quality) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  struct jpeg_compress_struct cinfo;
  EgJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = eg_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = (JDIMENSION)w;
  cinfo.image_height = (JDIMENSION)h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = w * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(rgb + (size_t)cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

#else  // !EG_HAVE_LIBJPEG

int eg_jpeg_supported(void) { return 0; }
int eg_jpeg_header(const char *, int32_t *, int32_t *) { return -9; }
int eg_jpeg_decode_file(const char *, uint8_t *, int32_t, int32_t, int32_t *,
                        int32_t *) { return -9; }
int eg_jpeg_encode_file(const char *, const uint8_t *, int32_t, int32_t,
                        int32_t) { return -9; }

#endif  // EG_HAVE_LIBJPEG

// Bilinear resample with half-pixel centers (cv::INTER_LINEAR's mapping),
// RGB interleaved. Identity sizes short-circuit to a memcpy.
void eg_resize_bilinear_rgb(const uint8_t *src, int32_t w, int32_t h,
                            uint8_t *dst, int32_t ow, int32_t oh) {
  if (w == ow && h == oh) {
    memcpy(dst, src, (size_t)w * h * 3);
    return;
  }
  const float sx = (float)w / (float)ow, sy = (float)h / (float)oh;
  for (int32_t y = 0; y < oh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > (float)(h - 1)) fy = (float)(h - 1);
    const int32_t y0 = (int32_t)fy;
    const int32_t y1 = (y0 + 1 < h) ? y0 + 1 : y0;
    const float ty = fy - (float)y0;
    for (int32_t x = 0; x < ow; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > (float)(w - 1)) fx = (float)(w - 1);
      const int32_t x0 = (int32_t)fx;
      const int32_t x1 = (x0 + 1 < w) ? x0 + 1 : x0;
      const float tx = fx - (float)x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[((size_t)y0 * w + x0) * 3 + c];
        const float v01 = src[((size_t)y0 * w + x1) * 3 + c];
        const float v10 = src[((size_t)y1 * w + x0) * 3 + c];
        const float v11 = src[((size_t)y1 * w + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * tx;
        const float bot = v10 + (v11 - v10) * tx;
        const float v = top + (bot - top) * ty;
        dst[((size_t)y * ow + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// One-shot loader: JPEG file -> image_size x image_size RGB float32 NHWC in
// [0,1] (the framework's input convention; the reference keeps raw 0..255
// CHW floats, custom.hpp:46-59 — a constant input scale, noted in PARITY).
// Returns 0 or the decoder's error code.
int eg_load_jpeg_image(const char *path, float *out, int32_t image_size) {
#ifdef EG_HAVE_LIBJPEG
  // single pass: one fopen + header parse, buffer sized from the header
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  struct jpeg_decompress_struct cinfo;
  EgJpegErr err;
  // volatile: assigned between setjmp and a potential longjmp, read after
  uint8_t *volatile raw = nullptr;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = eg_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(raw);
    fclose(f);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int32_t w = (int32_t)cinfo.output_width;
  const int32_t h = (int32_t)cinfo.output_height;
  raw = (uint8_t *)malloc((size_t)w * h * 3);
  if (!raw) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  const int stride = w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = raw + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  uint8_t *small = (uint8_t *)malloc((size_t)image_size * image_size * 3);
  if (!small) {
    free(raw);
    return -1;
  }
  eg_resize_bilinear_rgb(raw, w, h, small, image_size, image_size);
  const int64_t px = (int64_t)image_size * image_size * 3;
  const float inv = 1.0f / 255.0f;
  for (int64_t i = 0; i < px; ++i) out[i] = (float)small[i] * inv;
  free(small);
  free(raw);
  return 0;
#else
  (void)path;
  (void)out;
  (void)image_size;
  return -9;
#endif
}

int eg_version(void) { return 2; }

}  // extern "C"
