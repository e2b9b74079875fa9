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
// Which launches take which kernel (launch_fwd; the launcher counts each
// kernel's launches: datr_msda_fwd_routes, msda.msda_fwd_routes()):
// - msda_fwd_bf16_run_kernel: bf16 value at D = 32, value and out on
//   16-byte boundaries, a long launch (msda_plan gives each warp several
//   queries: every encoder launch of the repo's models, a tp rank's 4
//   heads and an sp rank's half of the queries included), S * H * D
//   within an int;
// - msda_fwd_kernel: every other launch: f32 and f64 value, the decoders'
//   short launches, D != 32, misaligned views.
//
// What bounds them on this card (PERF.md §6; copies of the sources
// with a part taken out, timed at the C2F training encoder's shape, B 2,
// Lq = S = 51,680, H 8, the seeded model's locations). The floor of the
// function is device memory: the value rows the samples touch, loc and
// attn read once, out written once (0.0789 ms in bf16). The kernels are
// far from it, and not for want of bytes:
// - msda_fwd_kernel in bf16 (0.59 ms): without its gathers it kept 75% of
//   its time, without the cross-group sum 94%; with 8 lanes x 4 bf16 a row
//   (twice the loads, half the sum's shuffles) it took 14% longer, with
//   loc / attn computed in place of loaded (more instructions, no load)
//   16-20% longer. Instructions issued set its pace: ~360 warp
//   instructions per (b, q, h): a set-up on 16 of 32 lanes, two shuffles
//   per gather, 24 shuffles for the cross-group sum, an unpack per bf16
//   element. Half the bytes of f32 bought it 5%.
// - msda_fwd_kernel in f32: F32_PROBE.
// - msda_fwd_bf16_run_kernel (0.31 ms): without its gathers 65% of its
//   time; the unpacks and multiply-adds every design needs (128 warp
//   instructions per (b, q, h)) are most of what is left. At
//   uniform-random locations (every corner row its own line) it takes
//   0.40 ms: there the rows' trips from L2 weigh.
//
// msda_fwd_kernel's design (PERF.md has each step's times):
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
//
// msda_fwd_bf16_run_kernel's design cuts the instructions per
// (b, q, h) to about half (~175):
// 1. Lanes per query, not per sample: a warp serves 8 consecutive queries
//    of one (b, h) at once, 4 lanes a query, 8 channels a lane (one 16-byte
//    load a corner row). A lane sums its channels over all the query's
//    corners: no cross-lane sum. One gather instruction fetches the same
//    corner of 8 neighbouring queries, which at an encoder's locations
//    often share lines.
// 2. The set-up on all 32 lanes, 4 samples a round (one a lane), handed to
//    the 4 lanes of its query through shared memory: 4 row offsets and 4
//    weights a sample, read back as two broadcast 16-byte loads (where the
//    first kernel took 8 shuffles a sample). A round's 16 rows and weights
//    are read before its gathers, so that the 16 loads can be in flight
//    together; the next round's loc / attn are loaded before them.
// 3. No branch in the gather loop: a corner outside its level carries
//    weight 0 and reads the nearest row inside the level (a finite row
//    times 0 adds nothing; a non-finite value there makes the sum NaN, as
//    the plain version's index-0 row does).
// 4. Shared memory: 4 KB a block; the carve-out asks for 25% of the SM's
//    most (the smallest setting that holds the blocks the registers allow;
//    at 0 the card gave each SM one block: 5-6x slower, PERF.md).
// Sums stay f32, in one fixed order (no atomics: the same inputs give the
// same bits), rounded once to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// The forward's kernels (datr_msda_fwd_routes reads their launches).
enum MsdaFwdRoute {
  MSDA_FWD_KERNEL_F32 = 0,  // msda_fwd_kernel, by value's type
  MSDA_FWD_KERNEL_BF16 = 1,
  MSDA_FWD_KERNEL_F64 = 2,
  MSDA_FWD_BF16_RUN = 3,  // msda_fwd_bf16_run_kernel
  MSDA_FWD_ROUTES = 4
};
static std::atomic<long long> g_fwd_routes[MSDA_FWD_ROUTES];

// ------------------------------------------------------------ bf16 runs
// msda_fwd_bf16_run_kernel (the header's design): a warp serves
// MSDA_FWD_RUN_Q consecutive queries of one (batch, head), a block's warps
// side by side on MSDA_WARPS * MSDA_FWD_RUN_Q of them; lane i of group j
// owns channels 8i..8i+7 of query j and, each round, sets up sample k0 + i
// of query j.
#define MSDA_FWD_RUN_Q 8
// shared memory a block asks L1 to leave it, in percent of the SM's most
// (228 KB): room for the blocks its registers allow on an SM, 4 KB each
// (+ 1 KB each the card reserves)
#define MSDA_FWD_RUN_CARVEOUT 25

struct RunSlot {
  int4 off;   // the four corner rows, as element offsets from the head's
              // row 0 (token * H * D)
  float4 w;   // their weights times the attention weight; 0 outside
};

__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_bf16_run_kernel(
    const __nv_bfloat16* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, __nv_bfloat16* __restrict__ out, int S,
    int Lq, int H, int P, int n_runs, const __grid_constant__ Levels lv) {
  constexpr int D = 32, VEC = 8, R = 4;  // R: samples set up a round
  __shared__ RunSlot slots[MSDA_WARPS][R][MSDA_FWD_RUN_Q];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane >> 2;  // this group's query
  const int i = lane & 3;   // the lane within it: channels, and its set-up
  const int LP = lv.n * P;
  const int run = blockIdx.x % n_runs, bh = blockIdx.x / n_runs;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;  // a token of value (the route asks that
                                 // S * H * D fits an int)
  const __nv_bfloat16* val =
      value + (long long)b * S * row_stride + h * D + VEC * i;
  RunSlot(&mine)[MSDA_FWD_RUN_Q] = slots[warp][i];

  const int q0 = (run * MSDA_WARPS + warp) * MSDA_FWD_RUN_Q;
  if (q0 >= Lq) return;  // warp-uniform
  const bool live = q0 + j < Lq;
  const long long bqh = ((long long)b * Lq + (live ? q0 + j : q0)) * H + h;
  const float* loc_q = loc + bqh * LP * 2;
  const float* attn_q = attn + bqh * LP;

  // this lane's sample of the first round, its level and point
  int k = i, l = 0, p = i;
  while (p >= P) p -= P, ++l;
  float lx = 0.f, ly = 0.f, a = 0.f;
  if (live && k < LP)
    lx = __ldg(loc_q + 2 * k), ly = __ldg(loc_q + 2 * k + 1),
    a = __ldg(attn_q + k);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < LP; k0 += R) {
    RunSlot sl;
    sl.off = make_int4(0, 0, 0, 0);
    sl.w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && k < LP) {
      const int hl = lv.h[l], wl = lv.w[l];
      const Sample<float> sp = msda_sample(lx, ly, hl, wl);
      int offs[4];
      float ws[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = sp.x0 + (c & 1), cy = sp.y0 + (c >> 1);
        const bool in = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
        float wx, wy, w;
        msda_corner_weights(c, sp.fx, sp.fy, &wx, &wy, &w);
        ws[c] = in ? __fmul_rn(w, a) : 0.f;
        offs[c] = (lv.start[l] + min(max(cy, 0), hl - 1) * wl +
                   min(max(cx, 0), wl - 1)) * row_stride;
      }
      sl.off = make_int4(offs[0], offs[1], offs[2], offs[3]);
      sl.w = make_float4(ws[0], ws[1], ws[2], ws[3]);
    }
    // the next round's sample: its loc and attn in flight during the
    // gathers below
    k += R, p += R;
    while (p >= P) p -= P, ++l;
    if (live && k < LP)
      lx = __ldg(loc_q + 2 * k), ly = __ldg(loc_q + 2 * k + 1),
      a = __ldg(attn_q + k);
    __syncwarp();  // the previous round's slots are read
    mine[j] = sl;
    __syncwarp();
    // the round's rows and weights first, so that its 16 gathers can
    // all be in flight; a slot past the last sample reads row 0 at
    // weight 0
    const int n = min(R, LP - k0);
    int os[R][4];
    float wc[R][4];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int4 o = s < n ? slots[warp][s][j].off : make_int4(0, 0, 0, 0);
      const float4 w =
          s < n ? slots[warp][s][j].w : make_float4(0.f, 0.f, 0.f, 0.f);
      os[s][0] = o.x, os[s][1] = o.y, os[s][2] = o.z, os[s][3] = o.w;
      wc[s][0] = w.x, wc[s][1] = w.y, wc[s][2] = w.z, wc[s][3] = w.w;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[VEC];
        load_vec<VEC>(val + os[s][c], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += wc[s][c] * v[e];
      }
    }
  }
  if (live) store_vec<VEC>(out + bqh * D + VEC * i, acc);
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
  // by value's type: MSDA_FWD_KERNEL_F32 / _BF16 / _F64
  return msda_counted(g_fwd_routes,
                      std::is_same<T, float>::value    ? MSDA_FWD_KERNEL_F32
                      : std::is_same<T, double>::value ? MSDA_FWD_KERNEL_F64
                                                       : MSDA_FWD_KERNEL_BF16);
}

static cudaError_t launch_fwd_bf16_run(const void* value, const void* loc,
                                       const void* attn, void* out, int B,
                                       int S, int Lq, int H, int P,
                                       const Levels& lv, int device,
                                       cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  const cudaError_t err = msda_prefer_l1(msda_fwd_bf16_run_kernel, device,
                                         asked, MSDA_FWD_RUN_CARVEOUT);
  if (err != cudaSuccess) return err;
  const int run = MSDA_WARPS * MSDA_FWD_RUN_Q;
  const int n_runs = (Lq + run - 1) / run;
  const long long blocks = (long long)B * H * n_runs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_bf16_run_kernel<<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
      (__nv_bfloat16*)out, S, Lq, H, P, n_runs, lv);
  return msda_counted(g_fwd_routes, MSDA_FWD_BF16_RUN);
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
  if constexpr (VEC * sizeof(T) == 16) {
    // bf16 at D = 32 in 16-byte vectors, a long launch: runs of queries
    // a warp, a group of lanes a query
    if constexpr (sizeof(T) == 2) {
      if (D == 32 && P > 0 && wk.qpw > 1 &&
          (long long)S * H * D <= 0x7fffffffLL)
        return launch_fwd_bf16_run(value, loc, attn, out, B, S, Lq, H, P,
                                   lv, device, stream);
    }
    // D = 32 in 16-byte vectors: the compile-time geometry
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

// out[r] = the launches of route r (MsdaFwdRoute) since the library was
// loaded, counted on the host where each kernel is enqueued without error.
void datr_msda_fwd_routes(long long* out) {
  for (int r = 0; r < MSDA_FWD_ROUTES; ++r)
    out[r] = g_fwd_routes[r].load(std::memory_order_relaxed);
}

const char* datr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
