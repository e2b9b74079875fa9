// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel datr_tpu/ops/msda_pallas.py:_kernel (:45),
// reached through ms_deform_attn_pallas_fwd (:97). It computes the same
// function: for every (batch b, query q, head h) and each of the L*P samples,
// pixel coordinates x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5; the corner
// choice floor(x - (1e-4 + W_l*2^-20)) (the FMA-proof nudge of
// datr_tpu/ops/msda.py:_corner_gather_indices); four bilinear corners, each
// weight zero outside the level; times the attention weight; summed in f32
// (f64 for f64 value).
//
// Layouts (all contiguous):
//   value [B, S, H, D]   float or bfloat16; or double
//   loc   [B, Lq, H, L, P, 2] float (x, y normalized to [0, 1]); double
//   attn  [B, Lq, H, L, P]    float (softmaxed over L*P); double
//   out   [B, Lq, H, D]   value's type (the caller views it as [B, Lq, H*D])
// The double instantiations (the float64 debugging mode, amp_dtype=
// "float64") are the same kernels with A = double: f64 loc, attn, corner
// weights and sums, 16-byte loads of 2 doubles.
//
// Which launches take which kernel (launch_fwd; the launcher counts each
// kernel's launches: datr_msda_fwd_routes, msda.msda_fwd_routes()):
// - msda_fwd_run_kernel: bf16 or f64 value at D = 32, value and out on
//   16-byte boundaries, a long launch (msda_plan gives each warp several
//   queries: every encoder launch of the repo's models, a tp rank's 4
//   heads and an sp rank's half of the queries included), S * H * D
//   within an int (routes "msda_fwd_bf16_run_kernel" and
//   "msda_fwd_run_kernel f64");
// - msda_fwd_kernel: every other launch: f32 value, the decoders' short
//   launches, D != 32, misaligned views.
//
// What bounds them on this card (PERF.md §6; copies of the sources with a
// part taken out, timed in turns; bf16 / f32 at the C2F training encoder's
// shape, B 2, Lq = S = 51,680, H 8; f64 at the serving encoder's, Lq = S =
// 22,323; the seeded models' locations). The floor of the function is
// device memory: the value rows the samples touch, loc and attn read once,
// out written once (0.0789 ms in bf16, 0.0954 ms in f64). The kernels are
// far from it, and not for want of bytes:
// - msda_fwd_kernel in bf16 (0.59 ms): without its gathers it kept 75% of
//   its time, without the cross-group sum 94%; with 8 lanes x 4 bf16 a row
//   (twice the loads, half the sum's shuffles) it took 14% longer, with
//   loc / attn computed in place of loaded (more instructions, no load)
//   16-20% longer. Instructions issued set its pace: ~360 warp
//   instructions per (b, q, h): a set-up on 16 of 32 lanes, two shuffles
//   per gather, 24 shuffles for the cross-group sum, an unpack per bf16
//   element. Half the bytes of f32 bought it 5%.
// - msda_fwd_kernel in f32 (0.61 ms): without its gathers it kept 69% of
//   its time (62% at uniform-random locations): instructions, as in bf16.
// - msda_fwd_kernel in f64 (0.44 ms): without its gathers (the row
//   offset's bits in place of the load: no load, no conversion) it kept
//   61% of its time; without the cross-group sum 99%; the weights read
//   from shared memory in place of two of the three shuffles a gather
//   94.5%; a set-up on all 32 lanes (two queries a round, gathered one
//   after the other) 24% longer.
// - msda_fwd_run_kernel in bf16 (0.31 ms): without its gathers 65% of its
//   time; the unpacks and multiply-adds every design needs (128 warp
//   instructions per (b, q, h)) are most of what is left. At
//   uniform-random locations (every corner row its own line) it takes
//   0.40 ms: there the rows' trips from L2 weigh.
// - msda_fwd_run_kernel in f64 (0.32 ms): without its gathers 58% of its
//   time: the set-up, the slots' shared-memory reads and the 64 DFMAs a
//   (b, q, h) that every design issues; an f64 row fills two 128-byte
//   lines, so 128 lines of L1 a (b, q, h). 8 lanes a query (4 queries a
//   warp, two 16-byte loads a row, each instruction one line a query) was
//   2.5-4% faster at the model's and random locations and 4-6% slower at
//   locations moved by 4-16 px; the weights recomputed from (fx, fy,
//   attention) in each lane (a 32-byte slot in place of 48) 9% slower; the
//   loads of outside corners skipped 3-4% slower (bf16: 8%); a 50%
//   carve-out 1-7% slower. At uniform-random locations it takes 0.52 ms.
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
// msda_fwd_run_kernel's design (one body for bf16 and f64) cuts the
// instructions per (b, q, h) to about half (bf16 ~175, f64 ~200):
// 1. Lanes per query, not per sample: a warp serves several consecutive
//    queries of one (b, h) at once, a group of lanes a query, one 16-byte
//    load a corner row a lane (bf16: 8 queries, 4 lanes x 8 channels; f64:
//    2 queries, 16 lanes x 2 channels). A lane sums its channels over all
//    the query's corners: no cross-lane sum. One gather instruction fetches
//    the same corner of neighbouring queries, which at an encoder's
//    locations often share lines.
// 2. The set-up on all 32 lanes, one sample a lane a round (bf16: 4 a
//    query; f64: 16, so L x P = 16 takes one round), handed to the lanes of
//    its query through shared memory: 4 row offsets and 4 weights a sample,
//    read back as broadcast 16-byte loads (two in bf16, three in f64; the
//    first kernel took 8 or 12 shuffles a sample). NB samples' rows and
//    weights are read before their gathers (bf16 the round's 4, f64 2), so
//    that those 4 * NB loads can be in flight together; the next round's
//    loc / attn are loaded before them.
// 3. No branch in the gather loop: a corner outside its level carries
//    weight 0 and reads the nearest row inside the level (a finite row
//    times 0 adds nothing; a non-finite value there makes the sum NaN, as
//    the plain version's index-0 row does).
// 4. Shared memory: 4 KB (bf16) or 6 KB (f64) a block; the carve-out asks
//    for 25% of the SM's most (the smallest setting that holds the blocks
//    the registers allow; at 0 the card gave each SM one block: 5-6x
//    slower, PERF.md).
// Sums stay in A (f32 for bf16, rounded once to bf16; f64), in one fixed
// order (no atomics: the same inputs give the same bits).

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
  MSDA_FWD_BF16_RUN = 3,  // msda_fwd_run_kernel, by value's type
  MSDA_FWD_F64_RUN = 4,
  MSDA_FWD_ROUTES = 5
};
static std::atomic<long long> g_fwd_routes[MSDA_FWD_ROUTES];

// ------------------------------------------------------------ runs
// msda_fwd_run_kernel (the header's design): a warp serves Q = 32 / LPQ
// consecutive queries of one (batch, head), a block's warps side by side on
// MSDA_WARPS * Q of them; lane i of group j owns channels VEC*i ..
// VEC*i + VEC - 1 of query j (one 16-byte load a corner row) and, each
// round, sets up sample k0 + i of query j. The gathers go NB samples (4*NB
// rows) at a time. bf16: 4 lanes a query (8 queries a warp), the round's 4
// samples at once; f64: 16 lanes a query (2 queries a warp), 2 samples at
// a time.
// shared memory a block asks L1 to leave it, in percent of the SM's most
// (228 KB): room for the blocks its registers allow on an SM, 4 KB (bf16) or
// 6 KB (f64) each (+ 1 KB each the card reserves)
#define MSDA_FWD_RUN_CARVEOUT 25

template <typename A>
struct RunSlot {
  int4 off;  // the four corner rows, as element offsets from the head's
             // row 0 (token * H * D)
  A w[4];    // their weights times the attention weight; 0 outside
};

// A slot's four weights as 16-byte shared-memory loads (a broadcast to the
// lanes of its query).
__device__ __forceinline__ void slot_weights(const RunSlot<float>& s,
                                             float (&w)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s.w);
  w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
}

__device__ __forceinline__ void slot_weights(const RunSlot<double>& s,
                                             double (&w)[4]) {
  const double2 t = reinterpret_cast<const double2*>(s.w)[0];
  const double2 u = reinterpret_cast<const double2*>(s.w)[1];
  w[0] = t.x, w[1] = t.y, w[2] = u.x, w[3] = u.y;
}

template <typename T, typename A, int LPQ, int NB>
__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_run_kernel(
    const T* __restrict__ value, const A* __restrict__ loc,
    const A* __restrict__ attn, T* __restrict__ out, int S, int Lq, int H,
    int P, int n_runs, const __grid_constant__ Levels lv) {
  constexpr int D = 32, Q = 32 / LPQ, VEC = D / LPQ;
  constexpr int R = LPQ;  // samples set up a round, one a lane
  static_assert(VEC * sizeof(T) == 16 && R % NB == 0, "run geometry");
  __shared__ RunSlot<A> slots[MSDA_WARPS][R][Q];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane / LPQ;  // this group's query
  const int i = lane % LPQ;  // the lane within it: channels, and its set-up
  const int LP = lv.n * P;
  const int run = blockIdx.x % n_runs, bh = blockIdx.x / n_runs;
  const int b = bh / H, h = bh % H;
  const int row_stride = H * D;  // a token of value (the route asks that
                                 // S * H * D fits an int)
  const T* val = value + (long long)b * S * row_stride + h * D + VEC * i;
  RunSlot<A>(&mine)[Q] = slots[warp][i];

  const int q0 = (run * MSDA_WARPS + warp) * Q;
  if (q0 >= Lq) return;  // warp-uniform
  const bool live = q0 + j < Lq;
  const long long bqh = ((long long)b * Lq + (live ? q0 + j : q0)) * H + h;
  const A* loc_q = loc + bqh * LP * 2;
  const A* attn_q = attn + bqh * LP;

  // this lane's sample of the first round, its level and point
  int k = i, l = 0, p = i;
  while (p >= P) p -= P, ++l;
  A lx = (A)0, ly = (A)0, a = (A)0;
  if (live && k < LP)
    lx = __ldg(loc_q + 2 * k), ly = __ldg(loc_q + 2 * k + 1),
    a = __ldg(attn_q + k);
  A acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = (A)0;

  for (int k0 = 0; k0 < LP; k0 += R) {
    RunSlot<A> sl;
    sl.off = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) sl.w[c] = (A)0;
    if (live && k < LP) {
      const int hl = lv.h[l], wl = lv.w[l];
      const Sample<A> sp = msda_sample(lx, ly, hl, wl);
      int offs[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = sp.x0 + (c & 1), cy = sp.y0 + (c >> 1);
        const bool in = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
        A wx, wy, w;
        msda_corner_weights(c, sp.fx, sp.fy, &wx, &wy, &w);
        sl.w[c] = in ? mul_rn(w, a) : (A)0;
        offs[c] = (lv.start[l] + min(max(cy, 0), hl - 1) * wl +
                   min(max(cx, 0), wl - 1)) * row_stride;
      }
      sl.off = make_int4(offs[0], offs[1], offs[2], offs[3]);
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
    const int n = min(R, LP - k0);
#pragma unroll
    for (int s0 = 0; s0 < R; s0 += NB) {
      if (s0 >= n) break;  // warp-uniform
      // NB samples' rows and weights first, so that their 4*NB gathers
      // can all be in flight; a slot past the last sample reads row 0 at
      // weight 0
      int os[NB][4];
      A wc[NB][4];
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        int4 o = make_int4(0, 0, 0, 0);
        A w[4] = {(A)0, (A)0, (A)0, (A)0};
        if (s0 + s < n) {
          o = slots[warp][s0 + s][j].off;
          slot_weights(slots[warp][s0 + s][j], w);
        }
        os[s][0] = o.x, os[s][1] = o.y, os[s][2] = o.z, os[s][3] = o.w;
#pragma unroll
        for (int c = 0; c < 4; ++c) wc[s][c] = w[c];
      }
#pragma unroll
      for (int s = 0; s < NB; ++s) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          A v[VEC];
          load_vec<VEC>(val + os[s][c], v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += wc[s][c] * v[e];
        }
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

template <typename T, typename A, int LPQ, int NB>
static cudaError_t launch_fwd_run(const void* value, const void* loc,
                                  const void* attn, void* out, int B, int S,
                                  int Lq, int H, int P, const Levels& lv,
                                  int device, cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  const cudaError_t err =
      msda_prefer_l1(msda_fwd_run_kernel<T, A, LPQ, NB>, device, asked,
                     MSDA_FWD_RUN_CARVEOUT);
  if (err != cudaSuccess) return err;
  const int run = MSDA_WARPS * (32 / LPQ);
  const int n_runs = (Lq + run - 1) / run;
  const long long blocks = (long long)B * H * n_runs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_run_kernel<T, A, LPQ, NB>
      <<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
          (const T*)value, (const A*)loc, (const A*)attn, (T*)out, S, Lq, H,
          P, n_runs, lv);
  return msda_counted(g_fwd_routes, std::is_same<T, double>::value
                                        ? MSDA_FWD_F64_RUN
                                        : MSDA_FWD_BF16_RUN);
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
    // bf16 or f64 at D = 32 in 16-byte vectors, a long launch: runs of
    // queries a warp, a group of lanes a query
    if constexpr (sizeof(T) != 4) {
      constexpr int lpq = sizeof(T) == 2 ? 4 : 16;  // lanes a query
      constexpr int nb = sizeof(T) == 2 ? 4 : 2;    // samples a gather batch
      if (D == 32 && P > 0 && wk.qpw > 1 &&
          (long long)S * H * D <= 0x7fffffffLL)
        return launch_fwd_run<T, A, lpq, nb>(value, loc, attn, out, B, S, Lq,
                                             H, P, lv, device, stream);
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
