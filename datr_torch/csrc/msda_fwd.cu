// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel datr_tpu/ops/msda_pallas.py:_kernel (:45),
// reached through ms_deform_attn_pallas_fwd (:97). It computes the same
// function: for every (batch b, query q, head h) and each of the L*P samples,
// pixel coordinates x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5; the corner
// choice floor(x - (1e-4 + W_l*2^-20)) (the FMA-proof nudge of
// datr_tpu/ops/msda.py:_corner_gather_indices); four bilinear corners, each
// weight zero outside the level; times the attention weight; summed in f32.
//
// Layouts (all contiguous):
//   value [B, S, H, D]   float or bfloat16; or double
//   loc   [B, Lq, H, L, P, 2] float (x, y normalized to [0, 1]); double
//   attn  [B, Lq, H, L, P]    float (softmaxed over L*P); double
//   out   [B, Lq, H, D]   value's type (the caller views it as [B, Lq, H*D])
// The double instantiations (the float64 debugging mode, amp_dtype=
// "float64") are the same kernel with A = double: f64 loc, attn, corner
// weights and sums, 16-byte loads of 2 doubles (16 lanes per row at D = 32).
//
// What bounds it on this card: the rate at which an SM's L1 delivers gathered
// rows, not arithmetic (2 flops per gathered element) and, with this design,
// not device memory either. The work is a data-dependent gather of up to
// 4*L*P rows of D elements per (b, q, h): 8 KB per (b, q, h) at L*P = 16 and
// D = 32 in f32, 6.6 GB per launch at the training encoder shape
// (B 2, Lq = S = 51,680, H 8), where value itself is 106 MB (46 MB at the
// serving encoder shape: under the card's 50 MB L2 there, over it in
// training). Tensor cores and bulk copies do not apply to addresses known
// only at run time.
// - The floor of the function is device memory: value, loc and attn read
//   once, out written once. Where the samples are local (the model's own: an
//   encoder query samples a few pixels around itself) neighbouring queries
//   re-read the same rows and a kernel can approach it only as far as the
//   caches serve the re-reads.
// - Where they are scattered (uniform-random locations, the decoder's
//   queries) every row is its own fetch, and the floor is the rate at which
//   the caches deliver gathered rows.
// What the design does about it (PERF.md has each step's times):
// 1. One-time set-up (msda_common.cuh:msda_setup): lane k of a warp computes
//    sample k once, its four corner rows and their weights times the
//    attention weight (coalesced loc/attn loads); the gather loop reads them
//    by shuffles. L*P above 32 goes in chunks of 32 samples. The level table
//    is a __grid_constant__ parameter, indexed where it lies: no stack frame.
// 2. 16-byte gathers: a group of G lanes covers one row with VEC elements per
//    lane (D = 32: 8 lanes x float4, or 4 lanes x 8 bf16), so one warp
//    instruction fetches one corner of 32/G samples; the four corners are
//    unrolled and independent, and at D = 32 the geometry is a compile-time
//    constant, so all 4*L*P/R loads of a (b, q, h) are in flight together.
//    The groups' partial sums meet in log2(32/G) shuffle steps. VEC falls to
//    2 or 1 where D or a pointer's alignment asks for it, so every D is taken.
// 3. Cache-local order (msda_common.cuh:msda_work_item): a block serves a
//    run of consecutive queries of one (b, h), and block indices run along
//    that head's queries, so the rows a block gathers lie in a few image rows
//    of one head's lines, L1 (asked for whole: no shared memory is used)
//    serves the re-reads through the read-only path, and the blocks resident
//    at one time work on one or two (b, h) slices of value, which fit L2 even
//    where value does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "msda_common.cuh"

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(double* p, const double (&v)[VEC]) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned int*>(p) = pack_bf16x2(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// LG >= 0 fixes the lanes per row (2^LG) at compile time, for the widths the
// models use (D = 32): the gather loop then unrolls whole. LG < 0 reads it
// from the launch's geometry. A is the compute type (module comment).
template <typename T, typename A, int VEC, int LG>
__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_kernel(
    const T* __restrict__ value, const A* __restrict__ loc,
    const A* __restrict__ attn, T* __restrict__ out, int S, int Lq, int H,
    int D, int P, const Work wk, const __grid_constant__ Levels lv) {
  const int lane = threadIdx.x & 31;
  const int lg = LG >= 0 ? LG : wk.lg;
  const int G = 1 << lg, R = 32 >> lg;
  const int r = lane >> lg;                 // which of the R rows of a gather
  const int ch0 = (lane & (G - 1)) * VEC;   // first channel within the chunk
  const int LP = lv.n * P;
  const int row_stride = H * D;  // one token of value

  for (int it = 0; it < wk.qpw; ++it) {
    long long bqh;
    int b, h;
    if (!msda_work_item(wk, it, Lq, H, &bqh, &b, &h)) return;
    const A* loc_w = loc + bqh * LP * 2;
    const A* attn_w = attn + bqh * LP;
    const T* val_bh = value + (long long)b * S * row_stride + (long long)h * D;

    for (int c0 = 0; c0 < D; c0 += G * VEC) {
      const int ch = c0 + ch0;
      const bool live = ch < D;
      const T* val_ch = val_bh + ch;
      A acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = (A)0;

      for (int k0 = 0; k0 < LP; k0 += 32) {
        // this lane's own sample: corner rows, and weights times attention
        const SampleSetup<A> s =
            msda_setup(loc_w, attn_w, k0 + lane, LP, P, lv);
        A wgt[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          A wx, wy, w;
          msda_corner_weights(c, s.fx, s.fy, &wx, &wy, &w);
          wgt[c] = mul_rn(w, s.a);
        }
        const int n = min(LP - k0, 32);
#pragma unroll 4
        for (int s0 = 0; s0 < n; s0 += R) {
          const int src = s0 + r;  // the lane that set up this group's sample
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int off = __shfl_sync(MSDA_FULL, s.off[c], src);
            const A w = __shfl_sync(MSDA_FULL, wgt[c], src);
            if (off >= 0 && live) {
              A v[VEC];
              load_vec<VEC>(val_ch + (long long)off * row_stride, v);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[e] += w * v[e];
            }
          }
        }
      }
      // the R groups hold partial sums of the same channels
      for (int o = G; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] += __shfl_xor_sync(MSDA_FULL, acc[e], o);
      }
      if (r == 0 && live) store_vec<VEC>(out + bqh * D + ch, acc);
    }
  }
}

template <typename T, typename A, int VEC, int LG>
static cudaError_t launch_fwd_as(const void* value, const void* loc,
                                 const void* attn, void* out, int S, int Lq,
                                 int H, int D, int P, const Work& wk,
                                 long long blocks, const Levels& lv,
                                 int device, cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  cudaError_t err =
      msda_prefer_l1(msda_fwd_kernel<T, A, VEC, LG>, device, asked);
  if (err != cudaSuccess) return err;
  msda_fwd_kernel<T, A, VEC, LG>
      <<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
          (const T*)value, (const A*)loc, (const A*)attn, (T*)out, S, Lq, H,
          D, P, wk, lv);
  return cudaGetLastError();
}

template <typename T, typename A, int VEC>
static cudaError_t launch_fwd(const void* value, const void* loc,
                              const void* attn, void* out, int B, int S,
                              int Lq, int H, int D, int P, const Levels& lv,
                              int device, cudaStream_t stream) {
  Work wk;
  long long blocks;
  cudaError_t err = msda_plan(&wk, B, Lq, H, D, VEC, device, &blocks);
  if (err != cudaSuccess) return err;
  // D = 32 in 16-byte vectors: the compile-time geometry
  if constexpr (VEC * sizeof(T) == 16) {
    if (D == 32)  // 32 / VEC lanes per row
      return launch_fwd_as<T, A, VEC, msda_lg32<VEC>()>(
          value, loc, attn, out, S, Lq, H, D, P, wk, blocks, lv, device,
          stream);
  }
  return launch_fwd_as<T, A, VEC, -1>(value, loc, attn, out, S, Lq, H, D, P,
                                      wk, blocks, lv, device, stream);
}

extern "C" {

// Returns the cudaError_t of the launch (0 = success). `shapes` is a host
// array of L (h, w) pairs; the level starts follow from it. `dtype` is a
// MsdaDtype: value float, bfloat16 (loc and attn float) or double (loc and
// attn double).
int msda_fwd(const void* value, const void* loc, const void* attn, void* out,
             int B, int S, int Lq, int H, int D, int L, int P,
             const int* shapes, int dtype, int device, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, shapes, L, S);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * Lq * H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define MSDA_FWD(T, A, VEC)                                      \
  return (int)launch_fwd<T, A, VEC>(value, loc, attn, out, B, S, Lq, H, D, \
                                    P, lv, device, s)
  if (dtype == MSDA_BF16) {
    switch (msda_vec_width(D, 8, 2, value, out, out)) {
      case 8: MSDA_FWD(__nv_bfloat16, float, 8);
      case 4: MSDA_FWD(__nv_bfloat16, float, 4);
      case 2: MSDA_FWD(__nv_bfloat16, float, 2);
      default: MSDA_FWD(__nv_bfloat16, float, 1);
    }
  }
  if (dtype == MSDA_F64) {
    switch (msda_vec_width(D, 2, 8, value, out, out)) {
      case 2: MSDA_FWD(double, double, 2);
      default: MSDA_FWD(double, double, 1);
    }
  }
  if (dtype != MSDA_F32) return (int)cudaErrorInvalidValue;
  switch (msda_vec_width(D, 4, 4, value, out, out)) {
    case 4: MSDA_FWD(float, float, 4);
    case 2: MSDA_FWD(float, float, 2);
    default: MSDA_FWD(float, float, 1);
  }
#undef MSDA_FWD
}

const char* datr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
