// Native image preprocessing ops for the data pipeline.
//
// The CPU-heavy post-decode work (bilinear resize, crop, normalize, HWC
// float conversion) as tight loops over uint8 buffers, plus a batched
// entry point processing many images across a thread pool.  Exposed via
// ctypes; the Python Loader uses these when libimageops.so is built,
// falling back to PIL otherwise.
//
// Build: make -C csrc

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Antialiased bilinear (triangle-filter) resize, PIL semantics: the filter
// support scales with the downsampling ratio, weights are normalized per
// output pixel, applied separably (horizontal then vertical) with float
// intermediates.  uint8 HWC -> uint8 HWC.
static inline float triangle(float x) {
  x = std::fabs(x);
  return x < 1.0f ? 1.0f - x : 0.0f;
}

static void resample_axis(const float* src, int slen, int other, int c,
                          float* dst, int dlen, int64_t src_stride_axis,
                          int64_t src_stride_other, int64_t dst_stride_axis,
                          int64_t dst_stride_other) {
  const float scale = (float)slen / dlen;
  const float fscale = std::max(scale, 1.0f);
  const float support = 1.0f * fscale;
  std::vector<float> wts;
  for (int i = 0; i < dlen; ++i) {
    const float center = (i + 0.5f) * scale;
    int lo = (int)std::floor(center - support);
    int hi = (int)std::ceil(center + support);
    lo = std::max(lo, 0);
    hi = std::min(hi, slen);
    wts.assign(hi - lo, 0.0f);
    float wsum = 0.0f;
    for (int j = lo; j < hi; ++j) {
      float w = triangle((j + 0.5f - center) / fscale);
      wts[j - lo] = w;
      wsum += w;
    }
    if (wsum <= 0) wsum = 1.0f;
    for (int o = 0; o < other; ++o) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int j = lo; j < hi; ++j)
          acc += wts[j - lo] *
                 src[(int64_t)j * src_stride_axis + (int64_t)o * src_stride_other + ch];
        dst[(int64_t)i * dst_stride_axis + (int64_t)o * dst_stride_other + ch] =
            acc / wsum;
      }
    }
  }
}

void resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw, int c) {
  std::vector<float> f0((int64_t)sh * sw * c);
  for (int64_t i = 0; i < (int64_t)sh * sw * c; ++i) f0[i] = src[i];
  // horizontal: sw -> dw
  std::vector<float> f1((int64_t)sh * dw * c);
  resample_axis(f0.data(), sw, sh, c, f1.data(), dw, c, (int64_t)sw * c, c,
                (int64_t)dw * c);
  // vertical: sh -> dh
  std::vector<float> f2((int64_t)dh * dw * c);
  resample_axis(f1.data(), sh, dw, c, f2.data(), dh, (int64_t)dw * c, c,
                (int64_t)dw * c, c);
  for (int64_t i = 0; i < (int64_t)dh * dw * c; ++i)
    dst[i] = (uint8_t)std::min(std::max((int)std::lround(f2[i]), 0), 255);
}

// crop + convert to float32 in [0,1], optionally normalizing with mean/std
void crop_normalize_f32(const uint8_t* src, int sh, int sw, int c, int y0,
                        int x0, int size, float* dst, const float* mean,
                        const float* std_, int do_norm) {
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float v = src[((int64_t)(y0 + y) * sw + (x0 + x)) * c + ch] / 255.0f;
        if (do_norm) v = (v - mean[ch]) / std_[ch];
        dst[((int64_t)y * size + x) * c + ch] = v;
      }
    }
  }
}

// eval pipeline for one image: resize shorter side to `resize`, center crop
void eval_preprocess_u8(const uint8_t* src, int sh, int sw, int c, int resize,
                        int size, float* dst, const float* mean,
                        const float* std_, int do_norm) {
  int nh, nw;
  if (sw < sh) {
    nw = resize;
    nh = std::max(1, (int)std::lround((double)sh * resize / sw));
  } else {
    nh = resize;
    nw = std::max(1, (int)std::lround((double)sw * resize / sh));
  }
  std::vector<uint8_t> tmp((int64_t)nh * nw * c);
  resize_bilinear_u8(src, sh, sw, tmp.data(), nh, nw, c);
  crop_normalize_f32(tmp.data(), nh, nw, c, (nh - size) / 2, (nw - size) / 2,
                     size, dst, mean, std_, do_norm);
}

// training preprocessing for one image: crop box (y0,x0,h,w) -> antialiased
// resize to size x size -> optional horizontal flip -> float [0,1] (+norm).
void train_preprocess_u8(const uint8_t* src, int sh, int sw, int c, int y0,
                         int x0, int ch_, int cw_, int flip, int size,
                         float* dst, const float* mean, const float* std_,
                         int do_norm) {
  // gather the crop into a contiguous buffer
  std::vector<uint8_t> crop((int64_t)ch_ * cw_ * c);
  for (int y = 0; y < ch_; ++y)
    std::memcpy(crop.data() + (int64_t)y * cw_ * c,
                src + ((int64_t)(y0 + y) * sw + x0) * c, (int64_t)cw_ * c);
  std::vector<uint8_t> rs((int64_t)size * size * c);
  resize_bilinear_u8(crop.data(), ch_, cw_, rs.data(), size, size, c);
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      const int sx = flip ? (size - 1 - x) : x;
      for (int ch2 = 0; ch2 < c; ++ch2) {
        float v = rs[((int64_t)y * size + sx) * c + ch2] / 255.0f;
        if (do_norm) v = (v - mean[ch2]) / std_[ch2];
        dst[((int64_t)y * size + x) * c + ch2] = v;
      }
    }
  }
}

// batched training preprocessing: boxes[n][4] = (y0, x0, h, w), flips[n]
void train_preprocess_batch(const uint8_t** srcs, const int* dims,
                            const int* boxes, const uint8_t* flips, int n,
                            int c, int size, float* dst, const float* mean,
                            const float* std_, int do_norm, int num_threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      train_preprocess_u8(srcs[i], dims[2 * i], dims[2 * i + 1], c,
                          boxes[4 * i], boxes[4 * i + 1], boxes[4 * i + 2],
                          boxes[4 * i + 3], flips[i], size,
                          dst + (int64_t)i * size * size * c, mean, std_,
                          do_norm);
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// batched eval preprocessing across a thread pool.  srcs: array of pointers,
// dims: [n][2] (h, w).  dst: n * size * size * c floats.
void eval_preprocess_batch(const uint8_t** srcs, const int* dims, int n,
                           int c, int resize, int size, float* dst,
                           const float* mean, const float* std_, int do_norm,
                           int num_threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      eval_preprocess_u8(srcs[i], dims[2 * i], dims[2 * i + 1], c, resize,
                         size, dst + (int64_t)i * size * size * c, mean, std_,
                         do_norm);
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg/-turbo).  The Python loader's decode was the pipeline
// bottleneck AND GIL-bound (worker threads did not scale: 247 img/s at 1, 4,
// or 8 workers on this 4-core host -- scripts/loader_bench.py).  These entry
// points decode whole batches across native threads with the GIL released;
// `denom` in {1,2,4,8} requests libjpeg's DCT-domain scaled decode (the
// fast_decode path; PIL's Image.draft uses the same mechanism).
// ---------------------------------------------------------------------------

#if !defined(F8NET_NO_JPEG) && __has_include(<jpeglib.h>)
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>

namespace {

struct JErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

void jerr_quiet(j_common_ptr, int) {}
void jerr_quiet_msg(j_common_ptr) {}

// Parse the header; with full_decode also decompress into out (RGB, 3ch).
// Returns 1 on success.  w/h receive the (scaled) output dimensions.
int decode_one(const uint8_t* data, long size, int denom, uint8_t* out,
               int* w, int* h, bool full_decode) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_quiet;
  jerr.pub.output_message = jerr_quiet_msg;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom < 1 ? 1 : denom;
  if (cinfo.jpeg_color_space == JCS_GRAYSCALE ||
      cinfo.jpeg_color_space == JCS_YCbCr ||
      cinfo.jpeg_color_space == JCS_RGB) {
    cinfo.out_color_space = JCS_RGB;
  } else {
    jpeg_destroy_decompress(&cinfo);  // CMYK etc.: caller falls back to PIL
    return 0;
  }
  jpeg_calc_output_dimensions(&cinfo);
  *w = (int)cinfo.output_width;
  *h = (int)cinfo.output_height;
  if (!full_decode) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_start_decompress(&cinfo);
  const int stride = (int)cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (int64_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

}  // namespace

extern "C" {

int jpeg_support(void) { return 1; }

// Header-only batched dim query (cheap, serial).  oks[i]=0 marks images the
// decoder cannot handle (caller falls back to PIL for those).
void jpeg_dims_batch(const uint8_t** datas, const long* sizes, int n,
                     const int* denoms, int* ws, int* hs, int* oks) {
  for (int i = 0; i < n; ++i)
    oks[i] = decode_one(datas[i], sizes[i], denoms[i], nullptr, ws + i,
                        hs + i, false);
}

// Batched decode into caller-allocated RGB buffers (ws[i]*hs[i]*3 bytes,
// from a prior jpeg_dims_batch with the same denoms).
void jpeg_decode_batch(const uint8_t** datas, const long* sizes, int n,
                       const int* denoms, uint8_t** outs, const int* ws,
                       const int* hs, int* oks, int num_threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      oks[i] =
          decode_one(datas[i], sizes[i], denoms[i], outs[i], &w, &h, true) &&
          w == ws[i] && h == hs[i];
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"

#else  // no usable libjpeg at build time

extern "C" {
int jpeg_support(void) { return 0; }
void jpeg_dims_batch(const uint8_t**, const long*, int, const int*, int*,
                     int*, int* oks) {}
void jpeg_decode_batch(const uint8_t**, const long*, int, const int*,
                       uint8_t**, const int*, const int*, int* oks, int) {}
}

#endif
