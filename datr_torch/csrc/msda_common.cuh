// Shared by the MSDA forward (msda_fwd.cu) and backward (msda_bwd.cu)
// kernels: the level table, the sampling-point footing, the one-time sample
// set-up of a warp, the work order and the vector loads. The backward must
// pick exactly the corners the forward picked, so both go through
// msda_sample (by way of msda_setup).
//
// The compute type A of the sample set-up is float for f32 and bf16 value
// (loc and attn f32) and double for f64 value (loc and attn f64: the
// float64 debugging mode); the same code in each, through the overloads
// below, so the f64 instantiations repeat the f32 arithmetic step for step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_DEVICES 64                 // per-device caches below
#define MSDA_THREADS 128                    // 4 warps per block
#define MSDA_QPW 4                          // queries per warp, long launches
#define MSDA_WARPS (MSDA_THREADS / 32)
#define MSDA_FULL 0xffffffffu

// The value type a launch is asked for (the C entry points' `dtype`).
enum MsdaDtype { MSDA_F32 = 0, MSDA_BF16 = 1, MSDA_F64 = 2 };

// Round-to-nearest arithmetic that nvcc does not contract into an FMA, and
// floor / clamp, for either compute type.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float msda_floor(float x) { return floorf(x); }
__device__ __forceinline__ double msda_floor(double x) { return floor(x); }
__device__ __forceinline__ float msda_clamp(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double msda_clamp(double x, double lo,
                                             double hi) {
  return fmin(fmax(x, lo), hi);
}

// Work order of a launch: a block serves a run of consecutive queries of ONE
// (batch, head), its warps interleaved over the run, and block indices run
// along the queries of that head, so that a block and the blocks resident
// beside it gather from a few neighbouring image rows of one head's 128-byte
// lines, and the card as a whole works on one or two (batch, head) slices of
// value at a time, which L2 holds.

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
template <typename A>
struct Sample {
  int x0, y0;
  A fx, fy;
};

// Pixel coordinates x = lx*W - 0.5, y = ly*H - 0.5 and the corner choice
// floor(x - (1e-4 + W*2^-20)), in A exactly as the plain version computes
// them (datr_tpu/ops/msda.py:_corner_gather_indices): mul_rn/sub_rn keep
// nvcc from contracting loc*W - 0.5 into an FMA, and the nudge keeps the
// corner choice stable even where two roundings would differ. At exact
// integer coordinates it takes (lower corner, frac ~ 1).
template <typename A>
__device__ __forceinline__ Sample<A> msda_sample(A lx, A ly, int hl, int wl) {
  const A fw = (A)wl, fh = (A)hl;
  const A eps_x = add_rn((A)1e-4, fw * (A)9.5367431640625e-07);
  const A eps_y = add_rn((A)1e-4, fh * (A)9.5367431640625e-07);
  const A x = sub_rn(mul_rn(lx, fw), (A)0.5);
  const A y = sub_rn(mul_rn(ly, fh), (A)0.5);
  const A x0 = msda_floor(sub_rn(x, eps_x));
  const A y0 = msda_floor(sub_rn(y, eps_y));
  Sample<A> s;
  s.fx = sub_rn(x, x0);
  s.fy = sub_rn(y, y0);
  // clamping keeps the int conversion defined (NaN, huge values) without
  // changing which corners are inside the level
  s.x0 = (int)msda_clamp(x0, (A)-2, fw + (A)1);
  s.y0 = (int)msda_clamp(y0, (A)-2, fh + (A)1);
  return s;
}

// What one lane keeps of ONE sample of its warp's (b, q, h) after the set-up:
// the gather loops read these by __shfl_sync from the lane that owns the
// sample, so msda_sample runs once per sample and not once per lane.
template <typename A>
struct SampleSetup {
  int off[4];  // token of corner c = 2*dy + dx within the image's S tokens;
               // -1 outside the level (no weight, never loaded)
  A fx, fy;    // fractional offsets from the lower corner
  A a;         // attention weight
  int hl, wl;  // the sample's level (the backward scales grad_loc by them)
};

// Lane-parallel set-up: the calling lane takes sample k of the (b, q, h)
// whose loc / attn rows start at loc_w / attn_w (coalesced across the warp:
// 8 + 4 bytes per lane in f32). k >= LP gives a sample with every corner
// outside.
template <typename A>
__device__ __forceinline__ SampleSetup<A> msda_setup(const A* loc_w,
                                                     const A* attn_w, int k,
                                                     int LP, int P,
                                                     const Levels& lv) {
  SampleSetup<A> s;
  s.off[0] = s.off[1] = s.off[2] = s.off[3] = -1;
  s.fx = s.fy = s.a = (A)0;
  s.hl = s.wl = 1;
  if (k < LP) {
    const int l = k / P;
    s.hl = lv.h[l];
    s.wl = lv.w[l];
    const Sample<A> p =
        msda_sample(__ldg(loc_w + 2 * k), __ldg(loc_w + 2 * k + 1), s.hl, s.wl);
    s.fx = p.fx;
    s.fy = p.fy;
    s.a = __ldg(attn_w + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cx = p.x0 + (c & 1), cy = p.y0 + (c >> 1);
      if (cx >= 0 && cx < s.wl && cy >= 0 && cy < s.hl)
        s.off[c] = lv.start[l] + cy * s.wl + cx;
    }
  }
  return s;
}

// Bilinear weights of corner c = 2*dy + dx from the fractional offsets, in
// the plain version's arithmetic: wx, wy and w = wx*wy.
template <typename A>
__device__ __forceinline__ void msda_corner_weights(int c, A fx, A fy, A* wx,
                                                    A* wy, A* w) {
  *wx = (c & 1) ? fx : sub_rn((A)1, fx);
  *wy = (c >> 1) ? fy : sub_rn((A)1, fy);
  *w = mul_rn(*wx, *wy);
}

// The launch's geometry. A row of D channels is covered by a group of
// G = 2^lg lanes with VEC channels each (one 16-byte load per lane at VEC 4
// in f32), so one warp instruction gathers R = 32/G rows: one corner of R
// samples. D > G*VEC (G capped at 32) goes in channel chunks.
struct Work {
  int lg;         // log2 of the lanes per row
  int qpw;        // queries each warp serves, one after the other
  int n_runs;     // runs of MSDA_WARPS*qpw queries per (b, h)
  long long n;    // B*Lq*H, the (b, q, h) in all
};

static inline int msda_log2_lanes(int D, int vec) {
  const int need = (D + vec - 1) / vec;
  int lg = 0;
  while ((1 << lg) < need && lg < 5) ++lg;
  return lg;
}

// The card's SM count, asked of the CUDA runtime once per device.
static inline cudaError_t msda_sm_count(int device, int* sms) {
  static int known[MSDA_MAX_DEVICES];  // 0: not asked yet
  if (device < 0 || device >= MSDA_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!known[device]) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &known[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = known[device];
  return cudaSuccess;
}

// The kernels use no shared memory: asks, once per kernel and device, for the
// whole of the SM's array as L1. `asked` is the kernel's own static table.
template <typename Kernel>
static cudaError_t msda_prefer_l1(Kernel kernel, int device,
                                  bool (&asked)[MSDA_MAX_DEVICES]) {
  if (device < 0 || device >= MSDA_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (asked[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err == cudaSuccess) asked[device] = true;
  return err;
}

// Long launches give each warp MSDA_QPW queries of its head (a block's run is
// then MSDA_WARPS * MSDA_QPW consecutive queries whose sampling windows
// overlap, for L1); launches too short to fill the card twice that way keep
// one query per warp, so that every warp of the launch is in flight at once.
static inline cudaError_t msda_plan(Work* wk, int B, int Lq, int H, int D,
                                    int vec, int device, long long* blocks) {
  int sms = 0;
  cudaError_t err = msda_sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  wk->lg = msda_log2_lanes(D, vec);
  wk->n = (long long)B * Lq * H;
  const long long resident = (long long)sms * (2048 / MSDA_THREADS);
  wk->qpw = MSDA_QPW;
  if ((wk->n + MSDA_QPW * MSDA_WARPS - 1) / (MSDA_QPW * MSDA_WARPS) <
      2 * resident)
    wk->qpw = 1;
  const int run = MSDA_WARPS * wk->qpw;
  wk->n_runs = (Lq + run - 1) / run;
  *blocks = (long long)B * H * wk->n_runs;
  return *blocks <= 0x7fffffffLL ? cudaSuccess : cudaErrorInvalidValue;
}

// The `it`-th (b, q, h) of the calling warp, as its index into the
// [B, Lq, H] arrays and its (b, h); false when the warp has no such query.
// Warp-uniform.
__device__ __forceinline__ bool msda_work_item(const Work& wk, int it, int Lq,
                                               int H, long long* bqh, int* b,
                                               int* h) {
  const int wib = threadIdx.x >> 5;
  const int run = blockIdx.x % wk.n_runs;
  const int bh = blockIdx.x / wk.n_runs;
  const int q = (run * wk.qpw + it) * MSDA_WARPS + wib;
  if (q >= Lq) return false;
  *b = bh / H;
  *h = bh % H;
  *bqh = ((long long)*b * Lq + q) * H + *h;
  return true;
}

// VEC consecutive elements at p (aligned to their VEC*sizeof(T) bytes) through
// the read-only path, widened to f32.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(VEC == 1, "f32 vectors hold 4, 2 or 1 elements");
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ void unpack_bf16x2(unsigned int u, float* lo,
                                              float* hi) {
  // a bf16 is the upper half of the f32 of the same value
  *lo = __uint_as_float(u << 16);
  *hi = __uint_as_float(u & 0xffff0000u);
}

// Two floats rounded to bf16 (to nearest, ties to even, as PyTorch's
// conversion rounds), packed low then high.
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[VEC]) {
  if constexpr (VEC == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(VEC == 1, "f64 vectors hold 2 or 1 elements");
    v[0] = __ldg(p);
  }
}

// The lanes per row (log2) of the compile-time geometry at D = 32: 32 / VEC
// lanes with one 16-byte vector each (bf16 8, f32 4, f64 2 elements).
template <int VEC>
constexpr int msda_lg32() {
  return VEC == 8 ? 2 : VEC == 4 ? 3 : 4;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack_bf16x2(t.x, &v[0], &v[1]);
    unpack_bf16x2(t.y, &v[2], &v[3]);
    unpack_bf16x2(t.z, &v[4], &v[5]);
    unpack_bf16x2(t.w, &v[6], &v[7]);
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(t.x, &v[0], &v[1]);
    unpack_bf16x2(t.y, &v[2], &v[3]);
  } else if constexpr (VEC == 2) {
    unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)), &v[0],
                  &v[1]);
  } else {
    static_assert(VEC == 1, "bf16 vectors hold 8, 4, 2 or 1 elements");
    v[0] = __bfloat162float(*p);
  }
}

// The widest vector of at most `max_vec` elements of `elt` bytes that divides
// D and to which every pointer is aligned.
static inline int msda_vec_width(int D, int max_vec, int elt, const void* p0,
                                 const void* p1, const void* p2) {
  int vec = max_vec;
  while (vec > 1 &&
         (D % vec || ((size_t)p0 | (size_t)p1 | (size_t)p2) % (vec * elt)))
    vec >>= 1;
  return vec;
}
