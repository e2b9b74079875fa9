// Host image work of the data loader and the server (datr_torch/native.py).
//
// The port's own copy of datr_tpu's native image kernels
// (datr_tpu/native/image_ops.cpp:31, :81, :129), every float operation in
// the same order, so that the results are bitwise equal to datr_tpu's:
//   resize_normalize_pad  bilinear resize (align_corners=False) + ImageNet
//                         normalization + zero pad into the f32 canvas, in
//                         one write per canvas value (data/transforms.py);
//   resize_bilinear_u8    the same resize kept in uint8 (the serving
//                         ingest, serve.py);
//   rgb_to_yuv420         RGB canvas -> planar I420, full-range BT.601
//                         (the yuv420 wire).
// Built with `g++ -O3 -ffp-contract=off -shared -fPIC` at first use and
// loaded with ctypes, which releases the GIL for each call: a contracted
// (fused) multiply-add would round differently from datr_tpu's build. The
// package builds it without OpenMP, one thread per call: the loader's
// threads and the server's submitting threads call it in parallel. The
// rows are independent, so a build with -fopenmp (the pragmas below)
// gives the same bytes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// src: uint8 [sh, sw, 3] row-major
// dst: float32 [canvas_h, canvas_w, 3], fully overwritten:
//   [0:dh, 0:dw]  = normalized bilinear resize of src
//   elsewhere     = 0
// mean/std: float[3]. Needs 0 < dh <= canvas_h, 0 < dw <= canvas_w.
void resize_normalize_pad(const uint8_t* src, int sh, int sw,
                          float* dst, int dh, int dw,
                          int canvas_h, int canvas_w,
                          const float* mean, const float* std_) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3], mean_[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.0f / std_[c];
    mean_[c] = mean[c];
  }

#pragma omp parallel for schedule(static)
  for (int y = 0; y < canvas_h; ++y) {
    float* row = dst + static_cast<int64_t>(y) * canvas_w * 3;
    if (y >= dh) {
      std::memset(row, 0, sizeof(float) * canvas_w * 3);
      continue;
    }
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    const int y0c = std::clamp(y0, 0, sh - 1);
    const int y1c = std::clamp(y0 + 1, 0, sh - 1);
    const uint8_t* r0 = src + static_cast<int64_t>(y0c) * sw * 3;
    const uint8_t* r1 = src + static_cast<int64_t>(y1c) * sw * 3;

    for (int x = 0; x < dw; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      const int x0c = std::clamp(x0, 0, sw - 1);
      const int x1c = std::clamp(x0 + 1, 0, sw - 1);
      const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
      const float w10 = (1 - wx) * wy, w11 = wx * wy;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * r0[x0c * 3 + c] + w01 * r0[x1c * 3 + c] +
                        w10 * r1[x0c * 3 + c] + w11 * r1[x1c * 3 + c];
        row[x * 3 + c] = (v * inv255 - mean_[c]) * inv_std[c];
      }
    }
    if (dw < canvas_w) {
      std::memset(row + dw * 3, 0, sizeof(float) * (canvas_w - dw) * 3);
    }
  }
}

// The same bilinear resize uint8 -> uint8 [dh, dw, 3]: u8 = trunc(v + 0.5),
// v a convex combination of u8 values, so already in [0, 255].
void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                        uint8_t* dst, int dh, int dw) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    const int y0c = std::clamp(y0, 0, sh - 1);
    const int y1c = std::clamp(y0 + 1, 0, sh - 1);
    const uint8_t* r0 = src + static_cast<int64_t>(y0c) * sw * 3;
    const uint8_t* r1 = src + static_cast<int64_t>(y1c) * sw * 3;
    uint8_t* out = dst + static_cast<int64_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      const int x0c = std::clamp(x0, 0, sw - 1);
      const int x1c = std::clamp(x0 + 1, 0, sw - 1);
      const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
      const float w10 = (1 - wx) * wy, w11 = wx * wy;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * r0[x0c * 3 + c] + w01 * r0[x1c * 3 + c] +
                        w10 * r1[x0c * 3 + c] + w11 * r1[x1c * 3 + c];
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// RGB canvas [H, W, 3] -> planar I420: Y [H*W], then U and V
// [(H/2)*(W/2)] each; H and W even. (real_h, real_w) is the unpadded
// extent: the chroma's 2x2 block averages clamp their sample coordinates to
// it, so the pad's zeros never bleed into the chroma of real boundary
// pixels (a block wholly in the pad repeats the edge's chroma; the card
// zeroes the pad again from the mask).
void rgb_to_yuv420(const uint8_t* src, int H, int W, int real_h, int real_w,
                   uint8_t* out) {
  uint8_t* Y = out;
  uint8_t* U = out + static_cast<int64_t>(H) * W;
  uint8_t* V = U + static_cast<int64_t>(H / 2) * (W / 2);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < H; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * W * 3;
    uint8_t* yrow = Y + static_cast<int64_t>(y) * W;
    for (int x = 0; x < W; ++x) {
      const float r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
      yrow[x] = static_cast<uint8_t>(
          0.299f * r + 0.587f * g + 0.114f * b + 0.5f);
    }
  }
  const int ch = H / 2, cw = W / 2;
  const int yh = real_h > 0 ? real_h : H;
  const int yw = real_w > 0 ? real_w : W;
#pragma omp parallel for schedule(static)
  for (int by = 0; by < ch; ++by) {
    uint8_t* urow = U + static_cast<int64_t>(by) * cw;
    uint8_t* vrow = V + static_cast<int64_t>(by) * cw;
    for (int bx = 0; bx < cw; ++bx) {
      float r = 0, g = 0, b = 0;
      for (int dy = 0; dy < 2; ++dy) {
        const int sy = std::min(2 * by + dy, yh - 1);
        const uint8_t* row = src + static_cast<int64_t>(sy) * W * 3;
        for (int dx = 0; dx < 2; ++dx) {
          const int sx = std::min(2 * bx + dx, yw - 1);
          r += row[sx * 3];
          g += row[sx * 3 + 1];
          b += row[sx * 3 + 2];
        }
      }
      r *= 0.25f; g *= 0.25f; b *= 0.25f;
      // pure blue / red reach 256.0 before the cast: clamp (a u8 cast of
      // an out-of-range float is undefined)
      urow[bx] = static_cast<uint8_t>(std::clamp(
          128.0f - 0.168736f * r - 0.331264f * g + 0.5f * b + 0.5f,
          0.0f, 255.0f));
      vrow[bx] = static_cast<uint8_t>(std::clamp(
          128.0f + 0.5f * r - 0.418688f * g - 0.081312f * b + 0.5f,
          0.0f, 255.0f));
    }
  }
}

}  // extern "C"
