// Shared by the MSDA forward (msda_fwd.cu) and backward (msda_bwd.cu)
// kernels: the level table and the sampling-point footing. The backward must
// pick exactly the corners the forward picked, so both call msda_sample.

#pragma once

#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// Fills `lv` from a host array of L (h, w) pairs; the level starts follow.
// Returns cudaErrorInvalidValue when L is out of range or the levels do not
// add up to S tokens.
static inline cudaError_t fill_levels(Levels* lv, const int* shapes, int L,
                                      int S) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return cudaErrorInvalidValue;
  lv->n = L;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S ? cudaSuccess : cudaErrorInvalidValue;
}

// One sampling point on a level of hl x wl pixels: its lower corner and the
// fractional offsets from it.
struct Sample {
  int x0, y0;
  float fx, fy;
};

// Pixel coordinates x = lx*W - 0.5, y = ly*H - 0.5 and the corner choice
// floor(x - (1e-4 + W*2^-20)), in f32 exactly as the plain version computes
// them (datr_tpu/ops/msda.py:_corner_gather_indices): __fmul_rn/__fsub_rn
// keep nvcc from contracting loc*W - 0.5 into an FMA, and the nudge keeps the
// corner choice stable even where two roundings would differ. At exact
// integer coordinates it takes (lower corner, frac ~ 1).
__device__ __forceinline__ Sample msda_sample(float lx, float ly, int hl,
                                              int wl) {
  const float fw = (float)wl, fh = (float)hl;
  const float eps_x = __fadd_rn(1e-4f, fw * 9.5367431640625e-07f);
  const float eps_y = __fadd_rn(1e-4f, fh * 9.5367431640625e-07f);
  const float x = __fsub_rn(__fmul_rn(lx, fw), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, fh), 0.5f);
  const float x0 = floorf(__fsub_rn(x, eps_x));
  const float y0 = floorf(__fsub_rn(y, eps_y));
  Sample s;
  s.fx = __fsub_rn(x, x0);
  s.fy = __fsub_rn(y, y0);
  // clamping keeps the int conversion defined (NaN, huge values) without
  // changing which corners are inside the level
  s.x0 = (int)fminf(fmaxf(x0, -2.f), fw + 1.f);
  s.y0 = (int)fminf(fmaxf(y0, -2.f), fh + 1.f);
  return s;
}
