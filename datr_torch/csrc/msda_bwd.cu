// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the backward of the Pallas TPU kernel's custom VJP,
// datr_tpu/ops/msda_pallas.py:_bwd (:154-161), which is XLA's autodiff of
// ms_deform_attn_xla (and, at D=32, of the quad formulation the default
// msda_impl="xla" differentiates, datr_tpu/ops/msda.py:149-319). For every
// (batch b, query q, head h) and each of its L*P samples, with g = grad_out
// [b, q, h, :], the four bilinear corners c the forward used (weights w_c,
// rows v_c, attention weight a):
//   grad_value[b, row_c, h, :] += a * w_c * g          (scatter-add)
//   grad_attn[b, q, h, l, p]    = sum_c w_c * <g, v_c>
//   grad_loc[..., 0]            = a * sum_c <g, v_c> * dw_c/dfx * W_l
//   grad_loc[..., 1]            = a * sum_c <g, v_c> * dw_c/dfy * H_l
// Corners outside the level carry no weight and no gradient, as in the plain
// version's where(valid, w, 0).
//
// Layouts (all contiguous):
//   value [B, S, H, D], grad_out [B, Lq, H, D]   float, or both bfloat16;
//                                                or both double
//   work  [B, S, H, D]  float (double for double value): grad_value's sum,
//                       zeroed by the wrapper (f32, f64: it is grad_value)
//                       or by the entry point itself (bf16)
//   grad_value          value's type
//   loc, grad_loc     [B, Lq, H, L, P, 2]  float (double for double value)
//   attn, grad_attn   [B, Lq, H, L, P]     float (double for double value)
// f32 and f64 (the float64 debugging mode): msda_bwd_run_kernel on the long
// launches at D = 32 with 16-byte aligned rows (an encoder's),
// msda_bwd_kernel otherwise; atomics straight into grad_value (f64: scalar
// ones, the card has no vector f64 reduction; step 9).
//
// What bounds them on this card. The floor of the function is device
// memory: the value rows the samples touch read once and grad_value written
// once (plus grad_out/loc/attn read, grad_loc/grad_attn written). The
// kernels instead gather up to 4*L*P rows per (b, q, h) through L1 (as the
// forward, msda_fwd.cu) and send one read-modify-write of a row to L2 per
// corner or per merged run of corners. At the model's own locations neither
// stream alone sets the pace of the bf16 encoder launch: taking out its
// reductions saved less than taking out its gathers (PERF.md has the run),
// so the instructions and the latency of the gather loop do. At
// uniform-random locations the reductions weigh more (every row its own
// line in L2).
// What the design does about it (steps 1-3 are the forward's):
// 1. the same one-time set-up per warp (msda_common.cuh:msda_setup), so
//    grad_loc takes the slope of the cell the forward sampled;
// 2. 16-byte gathers by groups of G lanes with VEC channels each (f32);
//    grad_out's row is read once per (b, q, h) into registers;
// 3. the same cache-local work order: the card works on one or two (b, h)
//    slices of value and grad_value at a time, so the reductions meet their
//    rows in L2 instead of device memory (the largest gain at scattered
//    locations);
// 4. vector reductions: a*w*g goes out as one 16-byte atomicAdd per lane and
//    corner (red.global.add.v4.f32, compute capability 9.x), a quarter of the
//    scalar atomics, each lane's 16 bytes beside its neighbours' so that a
//    warp's reduction fills whole 32-byte sectors; a corner whose weight is
//    exactly zero (half of them at integer pixel coordinates, where the
//    model's initial offsets put the samples of a query's own level) adds
//    nothing and is not sent. A group serves the four corners of one sample
//    in turn, so the three dot products per sample are summed in the lane
//    first and cross only the group's G lanes (3 x log2 G shuffles per
//    sample instead of 3 x 5); the sample's owner lane gets them back by
//    shuffle and writes grad_attn and grad_loc coalesced.
// 5. merging before scattering, in registers (the run kernels, the long
//    launches): a warp serves 8 consecutive queries of its head and keeps,
//    per corner pixel parity, the row it last added to and the sum not yet
//    sent; the next query's same sample on the same row (2, 4 or 8
//    neighbouring pixels share a cell on each coarser level), or on the
//    neighbouring cell's shared corner, joins the sum, and one reduction
//    goes out for the run of them. Each lane owns its channels of those
//    rows, so no atomics are needed before the one reduction.
//    Not in shared memory: cuobjdump -sass shows atomicAdd(float*) and
//    red.shared.add.f32 there as an ATOMS.CAST.SPIN compare-and-swap loop;
//    and lane-owned sums kept in shared memory instead of registers
//    measured slower (a variant not kept).
// bf16 (the entry point's bwd_bf16): value and grad_out read as bf16 and
// widened to f32, every product and sum f32, grad_loc / grad_attn in f32,
// grad_value summed in an f32 workspace of value's shape and rounded once
// to bf16 (msda_round_bf16_kernel) -- more exact than datr_tpu's bf16
// scatter-add through XLA, a documented difference. The one C call zeroes
// the workspace (cudaMemsetAsync), scatters and rounds: no torch.zeros, and
// only the outputs and the workspace are allocated by the wrapper.
// 6. 8-byte bf16 loads, 8 lanes x 4 channels a row (msda_bwd_kernel at
//    VEC = 4), so each lane's 16-byte f32 reduction sits beside its
//    neighbours' (16-byte loads, 4 lanes x 8 channels, sent two reductions
//    32 bytes apart per lane: half-filled sectors, most of the decoder
//    launch's time; PERF.md has the run).
// 7. the split kernel (msda_bwd_bf16_split_kernel, the long launches at
//    D = 32 with 16-byte aligned rows, the encoder's): the round of samples
//    a warp sets up is served twice. First each lane takes its own sample
//    alone, whole rows of 32 channels (four 16-byte loads a corner) against
//    its query's whole grad_out row: the dot products, grad_attn and
//    grad_loc need no shuffle and no cross-lane sum. Then the merged
//    scatter of step 5, the corner rows and weights taken by shuffle from
//    the sample's lane. That removes the dot products' shuffles and
//    cross-lane sums (PERF.md has the times). Tensor cores for its
//    dot products (the 128 corner rows of a round against the run's 8
//    grad_out rows, mma.sync through shared memory) measured slower (a
//    variant not kept).
// 8. the workspace: zeroed and rounded in the same call. A ring of
//    per-(b, h) slots rounded by later blocks of the same launch (an atomic
//    ticket order, release / acquire counts) was tried and dropped (a
//    variant not kept): its counting and waiting cost more than the
//    separate passes it saved.
// 9. f64: every reduction is a scalar REDG.E.ADD.F64 (cuobjdump -sass; in
//    shared memory an ATOMS.CAST.SPIN.64 compare-and-swap loop), so the
//    reductions, not the gathers, set the pace: taking them out of the
//    first f64 route (msda_bwd_kernel<double> alone, 16 lanes x 2 doubles
//    a row, nothing merged) left a fifth of its time, taking out its gathers
//    nothing (PERF.md has the run). So the f64 kernels send as few
//    reductions as they can, each filling whole 32-byte sectors:
//    msda_bwd_run_kernel<double> merges runs of queries as step 5 does
//    (its slots keyed by pixel parity came from f64: the corner two
//    neighbouring cells share is one sum and not two, since the corner
//    index c differs between the cells and the parities do not); its
//    merged sums are laid out channel i + 8e on lane i, so each of a
//    flush's four scalar reductions is 8 lanes on 8 consecutive doubles
//    (16-byte vectors of 2 doubles would half fill twice as many sectors;
//    RunRow<double>). The short launches
//    (msda_bwd_kernel, D = 32) read and reduce lane i's channels i and
//    i + 16 as scalars for the same reason. An atomic-free owner-computes
//    backward (a counting sort of the contributions by value row) was not
//    written: by estimate, not measured, its sort and its second gather
//    pass would cost about what the merged reductions cost.
// Atomics make grad_value's sum order (and its last bits) vary from run to
// run.

#include <cuda_runtime.h>

#include <type_traits>

#include "msda_common.cuh"

// The backward's kernels (datr_msda_bwd_routes reads their launches).
enum MsdaBwdRoute {
  MSDA_BWD_KERNEL_F32 = 0,  // msda_bwd_kernel, by value's type
  MSDA_BWD_KERNEL_BF16 = 1,
  MSDA_BWD_KERNEL_F64 = 2,
  MSDA_BWD_RUN_F32 = 3,  // msda_bwd_run_kernel<float>
  MSDA_BWD_RUN_F64 = 4,  // msda_bwd_run_kernel<double>
  MSDA_BWD_BF16_SPLIT = 5,  // msda_bwd_bf16_split_kernel
  MSDA_BWD_ROUTES = 6
};
static std::atomic<long long> g_bwd_routes[MSDA_BWD_ROUTES];

// p[0..VEC) += v, as one reduction of VEC*4 bytes (p aligned to them).
template <int VEC>
__device__ __forceinline__ void red_add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// p[0..VEC) += v in f64: one scalar reduction per element.
template <int VEC>
__device__ __forceinline__ void red_add_vec(double* p,
                                            const double (&v)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) atomicAdd(p + e, v[e]);
}

// VEC elements of p: consecutive (ES = 1, one vector load), or ES apart
// (scalar loads).
template <int VEC, int ES, typename T, typename V>
__device__ __forceinline__ void load_elems(const T* p, V (&v)[VEC]) {
  if constexpr (ES == 1) {
    load_vec<VEC>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __ldg(p + e * ES);
  }
}

// LG as in the forward: the lanes per row fixed at compile time (D = 32), or
// read from the launch's geometry where LG < 0. T is value's and grad_out's
// type, A the compute type (float, or double for double value); grad_value
// is the sum in A.
template <typename T, typename A, int VEC, int LG>
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_kernel(
    const T* __restrict__ value, const A* __restrict__ loc,
    const A* __restrict__ attn, const T* __restrict__ grad_out,
    A* __restrict__ grad_value, A* __restrict__ grad_loc,
    A* __restrict__ grad_attn, int S, int Lq, int H, int D, int P,
    const Work wk, const __grid_constant__ Levels lv) {
  // f64 at D = 32 (16 lanes a row, 2 doubles each): lane i takes channels
  // i and i + 16 as scalars, so that each f64 reduction instruction of a
  // row covers 16 consecutive doubles (4 whole 32-byte sectors; 2-double
  // vectors would half fill 8)
  constexpr bool STRIDED = std::is_same<A, double>::value && LG == 4;
  constexpr int ES = STRIDED ? 16 : 1;  // the stride between a lane's elements
  const int lane = threadIdx.x & 31;
  const int lg = LG >= 0 ? LG : wk.lg;
  const int G = 1 << lg, R = 32 >> lg;
  const int r = lane >> lg;                 // which of the R rows of a gather
  const int ch0 = (lane & (G - 1)) * (STRIDED ? 1 : VEC);  // first channel
  const int LP = lv.n * P;
  const int row_stride = H * D;  // one token of value

  for (int it = 0; it < wk.qpw; ++it) {
    long long bqh;
    int b, h;
    if (!msda_work_item(wk, it, Lq, H, &bqh, &b, &h)) return;
    const A* loc_w = loc + bqh * LP * 2;
    const A* attn_w = attn + bqh * LP;
    A* gloc_w = grad_loc + bqh * LP * 2;
    A* gattn_w = grad_attn + bqh * LP;
    const long long bh = (long long)b * S * row_stride + (long long)h * D;

    for (int c0 = 0; c0 < D; c0 += G * VEC) {
      const int ch = c0 + ch0;
      const bool live = ch < D;
      A g[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = (A)0;
      if (live) load_elems<VEC, ES>(grad_out + bqh * D + ch, g);

      for (int k0 = 0; k0 < LP; k0 += 32) {
        const SampleSetup<A> s =
            msda_setup(loc_w, attn_w, k0 + lane, LP, P, lv);
        const int n = min(LP - k0, 32);
        A ga = 0, gx = 0, gy = 0;  // of this lane's own sample
#pragma unroll 2
        for (int s0 = 0; s0 < n; s0 += R) {
          const int src = s0 + r;  // the lane that set up this group's sample
          const A fx = __shfl_sync(MSDA_FULL, s.fx, src);
          const A fy = __shfl_sync(MSDA_FULL, s.fy, src);
          const A a = __shfl_sync(MSDA_FULL, s.a, src);
          A pa = 0, px = 0, py = 0;  // lane partials of the sample
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int off = __shfl_sync(MSDA_FULL, s.off[c], src);
            if (off >= 0 && live) {
              A wx, wy, w, v[VEC];
              msda_corner_weights(c, fx, fy, &wx, &wy, &w);
              const A wa = mul_rn(w, a);  // the forward's weight
              const long long at = bh + (long long)off * row_stride + ch;
              load_elems<VEC, ES>(value + at, v);
              A dot = 0;
#pragma unroll
              for (int e = 0; e < VEC; ++e) dot += g[e] * v[e];
              if (wa != (A)0) {
                A add[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e) add[e] = wa * g[e];
                if constexpr (STRIDED) {
#pragma unroll
                  for (int e = 0; e < VEC; ++e)
                    atomicAdd(grad_value + at + e * ES, add[e]);
                } else {
                  red_add_vec<VEC>(grad_value + at, add);
                }
              }
              pa += w * dot;
              px += ((c & 1) ? wy : -wy) * dot;   // dw/dfx
              py += ((c >> 1) ? wx : -wx) * dot;  // dw/dfy
            }
          }
          // over the channels: the G lanes of the group
          for (int o = 1; o < G; o <<= 1) {
            pa += __shfl_xor_sync(MSDA_FULL, pa, o);
            px += __shfl_xor_sync(MSDA_FULL, px, o);
            py += __shfl_xor_sync(MSDA_FULL, py, o);
          }
          // back to the lane that owns the sample: lane s0 + j reads group j
          const int from = ((lane - s0) & (R - 1)) << lg;
          const A ta = __shfl_sync(MSDA_FULL, pa, from);
          const A tx = __shfl_sync(MSDA_FULL, px, from);
          const A ty = __shfl_sync(MSDA_FULL, py, from);
          if (lane >= s0 && lane < s0 + R) ga = ta, gx = tx, gy = ty;
        }
        const int k = k0 + lane;
        if (k < LP) {
          const A lx = s.a * gx * (A)s.wl;
          const A ly = s.a * gy * (A)s.hl;
          if (c0 == 0) {
            gattn_w[k] = ga;
            gloc_w[2 * k] = lx;
            gloc_w[2 * k + 1] = ly;
          } else {  // a further channel chunk of the same sample
            gattn_w[k] += ga;
            gloc_w[2 * k] += lx;
            gloc_w[2 * k + 1] += ly;
          }
        }
      }
    }
  }
}

// v[c] with a corner c known only at run time, without indexing registers.
template <typename V>
__device__ __forceinline__ V pick4(const V (&v)[4], int c) {
  return (c & 2) ? ((c & 1) ? v[3] : v[2]) : ((c & 1) ? v[1] : v[0]);
}

// How the run kernel (below) lays out a row of D = 32 channels over the 8
// lanes of a group, lane i of 8: grad_out's row for the dot products and
// for the merged sums, the gathered corner rows, and the sums' reduction.
template <typename A>
struct RunRow;

// f32: lane i holds channels 4i..4i+3 everywhere: one 16-byte load a corner
// (a warp instruction: 4 rows x 128 bytes), the merged sums sent as one
// 16-byte red.global.add.v4.f32, beside its neighbours' (whole sectors).
template <>
struct RunRow<float> {
  static constexpr int MIN_BLOCKS = 1;  // no register cap
  // lane i's first channel: GATHER * i of a gathered row, SUM * i of a sum
  static constexpr int GATHER = 4, SUM = 4;
  float g[4];
  __device__ __forceinline__ void load(const float* go, int i) {
    load_vec<4>(go + 4 * i, g);
  }
  // row: a corner row at lane i's first gathered channel
  __device__ __forceinline__ float dot(const float* row) const {
    float v[4];
    load_vec<4>(row, v);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) d += g[e] * v[e];
    return d;
  }
  __device__ __forceinline__ float sum_g(int e) const { return g[e]; }
  // row: a grad_value row at lane i's first summed channel
  static __device__ __forceinline__ void send(float* row,
                                              const float (&v)[4]) {
    red_add_vec<4>(row, v);
  }
};

// f64: the gathers read channels {2i, 2i+1, 16+2i, 17+2i} as two 16-byte
// loads (a warp instruction: 4 rows x 128 bytes, one line each); the
// merged sums hold channels {i, i+8, i+16, i+24} (grad_out's row read
// again in that layout, scalar loads of the one row every group shares),
// so that each of a flush's four scalar f64 reductions (the card has no
// vector one; sm_90a: REDG.E.ADD.F64.RN each) is 8 lanes on 8 consecutive
// doubles: 2 whole 32-byte sectors a row, where 16-byte vectors of 2
// doubles would half fill 4. At most 128 registers a thread (4 blocks an
// SM): unbounded, nvcc takes 138 and the card holds 3 blocks an SM, which
// measured slower; at 96 or 80 it spills and is slower still (PERF.md has
// the run).
template <>
struct RunRow<double> {
  static constexpr int MIN_BLOCKS = 4;
  static constexpr int GATHER = 2, SUM = 1;
  double gd[2][2], gs[4];  // the gathers' layout, the sums' layout
  __device__ __forceinline__ void load(const double* go, int i) {
    load_vec<2>(go + 2 * i, gd[0]);
    load_vec<2>(go + 16 + 2 * i, gd[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) gs[e] = __ldg(go + i + 8 * e);
  }
  __device__ __forceinline__ double dot(const double* row) const {
    double v[2][2];
    load_vec<2>(row, v[0]);
    load_vec<2>(row + 16, v[1]);
    return gd[0][0] * v[0][0] + gd[0][1] * v[0][1] + gd[1][0] * v[1][0] +
           gd[1][1] * v[1][1];
  }
  __device__ __forceinline__ double sum_g(int e) const { return gs[e]; }
  static __device__ __forceinline__ void send(double* row,
                                              const double (&v)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) atomicAdd(row + 8 * e, v[e]);
  }
};

// The long launches at D = 32 with 16-byte aligned rows (the encoder's), f32
// or f64 (A: value's, grad_out's and the sums' type): 8 lanes a row, 4 rows
// a gather (RunRow<A> lays out a row). A warp serves MSDA_RUN_Q
// CONSECUTIVE queries of its (batch, head), one group of 4 samples at a
// time: lane j sets up sample k0 + j % 4 of query q0 + j / 4, then the
// queries go by in order, and each lane holds, per slot, the row and the sum
// of what it has not yet sent. Slot t takes the sample's corner at pixel
// parities t, so where the next query's same sample falls on the same row
// (neighbouring pixels do on every coarser level: 2, 4 or 8 queries to a
// cell), or a neighbouring cell shares the corner (the corner index differs
// between the cells, the parities do not), the contribution joins the sum in
// registers and one reduction goes out for the run of them. bf16's long
// launches take the split kernel (below).
#define MSDA_RUN_Q 8
template <typename A>
__global__ void __launch_bounds__(MSDA_THREADS, RunRow<A>::MIN_BLOCKS)
    msda_bwd_run_kernel(const A* __restrict__ value, const A* __restrict__ loc,
                        const A* __restrict__ attn,
                        const A* __restrict__ grad_out,
                        A* __restrict__ grad_value, A* __restrict__ grad_loc,
                        A* __restrict__ grad_attn, int S, int Lq, int H, int P,
                        int n_runs, const __grid_constant__ Levels lv) {
  constexpr int D = 32, R = 4;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 3;  // the gather's row group
  const int i = lane & 7;   // the lane within its group
  const int jq = lane >> 2, js = lane & 3;  // the set-up this lane does
  const int LP = lv.n * P;
  const int run = blockIdx.x % n_runs, bh = blockIdx.x / n_runs;
  const int b = bh / H, h = bh % H;
  const int q0 = (run * MSDA_WARPS + (threadIdx.x >> 5)) * MSDA_RUN_Q;
  if (q0 >= Lq) return;  // warp-uniform
  const int nq = min(MSDA_RUN_Q, Lq - q0);
  // index of (b, q0, h) into the [B, Lq, H] arrays; a query further is + H
  const long long bqh0 = ((long long)b * Lq + q0) * H + h;
  const long long mine = bqh0 + (long long)jq * H;
  const long long row_stride = (long long)H * D;  // a token of value
  const long long bh_off = (long long)b * S * row_stride + (long long)h * D;
  // (b, h)'s rows at this lane's first channel: of a gather, of a sum
  const A* val_ln = value + bh_off + RunRow<A>::GATHER * i;
  A* gval_ln = grad_value + bh_off + RunRow<A>::SUM * i;

  for (int k0 = 0; k0 < LP; k0 += R) {
    const int k = k0 + js;
    const SampleSetup<A> s = msda_setup(
        loc + mine * LP * 2, attn + mine * LP, jq < nq ? k : LP, LP, P, lv);
    int pend_off[4] = {-1, -1, -1, -1};  // per slot: the row owed
    A pend[4][4];                        // and its sum (RunRow's layout)
    A ga = 0, gx = 0, gy = 0;            // of this lane's own sample
#pragma unroll
    for (int j = 0; j < MSDA_RUN_Q; ++j) {
      if (j >= nq) break;  // warp-uniform
      const int src = j * R + r;  // the lane that set up this sample
      const A fx = __shfl_sync(MSDA_FULL, s.fx, src);
      const A fy = __shfl_sync(MSDA_FULL, s.fy, src);
      const A a = __shfl_sync(MSDA_FULL, s.a, src);
      RunRow<A> g;
      g.load(grad_out + (bqh0 + (long long)j * H) * D, i);
      A pa = 0, px = 0, py = 0;  // lane partials of the sample
      int offs[4];
      A was[4];  // the forward's weights
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        offs[c] = __shfl_sync(MSDA_FULL, s.off[c], src);
        was[c] = 0;
        if (offs[c] >= 0) {
          A wx, wy, w;
          msda_corner_weights(c, fx, fy, &wx, &wy, &w);
          was[c] = mul_rn(w, a);
          const A dot = g.dot(val_ln + (long long)offs[c] * row_stride);
          pa += w * dot;
          px += ((c & 1) ? wy : -wy) * dot;   // dw/dfx
          py += ((c >> 1) ? wx : -wx) * dot;  // dw/dfy
        }
      }
      // the scatter: slot t takes the corner at pixel parities t
      const int par = __shfl_sync(MSDA_FULL, s.par, src);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = t ^ par;
        const int off = pick4(offs, c);
        const A wa = pick4(was, c);
        if (off < 0 || wa == (A)0) continue;  // a zero weight adds nothing
        if (off == pend_off[t]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pend[t][e] += wa * g.sum_g(e);
        } else {
          if (pend_off[t] >= 0)
            RunRow<A>::send(gval_ln + (long long)pend_off[t] * row_stride,
                            pend[t]);
          pend_off[t] = off;
#pragma unroll
          for (int e = 0; e < 4; ++e) pend[t][e] = wa * g.sum_g(e);
        }
      }
      // over the channels: the 8 lanes of the group
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        pa += __shfl_xor_sync(MSDA_FULL, pa, o);
        px += __shfl_xor_sync(MSDA_FULL, px, o);
        py += __shfl_xor_sync(MSDA_FULL, py, o);
      }
      // back to the lane that owns the sample: lane j*4 + i reads group i
      const A ta = __shfl_sync(MSDA_FULL, pa, js << 3);
      const A tx = __shfl_sync(MSDA_FULL, px, js << 3);
      const A ty = __shfl_sync(MSDA_FULL, py, js << 3);
      if (jq == j) ga = ta, gx = tx, gy = ty;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (pend_off[t] >= 0)
        RunRow<A>::send(gval_ln + (long long)pend_off[t] * row_stride,
                        pend[t]);
    if (jq < nq && k < LP) {
      grad_attn[mine * LP + k] = ga;
      grad_loc[(mine * LP + k) * 2] = s.a * gx * (A)s.wl;
      grad_loc[(mine * LP + k) * 2 + 1] = s.a * gy * (A)s.hl;
    }
  }
}

template <typename T, typename A, int VEC, int LG>
static cudaError_t launch_bwd_as(const void* value, const void* loc,
                                 const void* attn, const void* grad_out,
                                 A* work, void* grad_loc, void* grad_attn,
                                 int S, int Lq, int H, int D, int P,
                                 const Work& wk, long long blocks,
                                 const Levels& lv, int device,
                                 cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  cudaError_t err =
      msda_prefer_l1(msda_bwd_kernel<T, A, VEC, LG>, device, asked);
  if (err != cudaSuccess) return err;
  msda_bwd_kernel<T, A, VEC, LG>
      <<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
          (const T*)value, (const A*)loc, (const A*)attn, (const T*)grad_out,
          work, (A*)grad_loc, (A*)grad_attn, S, Lq, H, D, P, wk, lv);
  // by value's type: MSDA_BWD_KERNEL_F32 / _BF16 / _F64
  return msda_counted(g_bwd_routes,
                      std::is_same<T, float>::value    ? MSDA_BWD_KERNEL_F32
                      : std::is_same<T, double>::value ? MSDA_BWD_KERNEL_F64
                                                       : MSDA_BWD_KERNEL_BF16);
}

template <typename T, typename A, int VEC>
static cudaError_t launch_bwd(const void* value, const void* loc,
                              const void* attn, const void* grad_out,
                              A* work, void* grad_loc, void* grad_attn,
                              int B, int S, int Lq, int H, int D, int P,
                              const Levels& lv, int device,
                              cudaStream_t stream) {
  Work wk;
  long long blocks;
  cudaError_t err = msda_plan(&wk, B, Lq, H, D, VEC, device, &blocks);
  if (err != cudaSuccess) return err;
  // f32 / f64 at D = 32 in 16-byte vectors, a long launch: runs of
  // queries per warp
  if constexpr (std::is_same<T, A>::value && VEC * sizeof(T) == 16) {
    if (D == 32 && wk.qpw > 1) {
      const int n_runs = (Lq + MSDA_WARPS * MSDA_RUN_Q - 1) /
                         (MSDA_WARPS * MSDA_RUN_Q);
      static bool asked[MSDA_MAX_DEVICES];
      err = msda_prefer_l1(msda_bwd_run_kernel<A>, device, asked);
      if (err != cudaSuccess) return err;
      msda_bwd_run_kernel<A><<<(unsigned)((long long)B * H * n_runs),
                               MSDA_THREADS, 0, stream>>>(
          (const A*)value, (const A*)loc, (const A*)attn, (const A*)grad_out,
          work, (A*)grad_loc, (A*)grad_attn, S, Lq, H, P, n_runs, lv);
      return msda_counted(g_bwd_routes, std::is_same<A, double>::value
                                            ? MSDA_BWD_RUN_F64
                                            : MSDA_BWD_RUN_F32);
    }
  }
  // D = 32 in 16-byte vectors, or in bf16's 8-byte ones: 32 / VEC lanes
  if constexpr (VEC * sizeof(T) == 16 || (sizeof(T) == 2 && VEC == 4)) {
    if (D == 32)
      return launch_bwd_as<T, A, VEC, msda_lg32<VEC>()>(
          value, loc, attn, grad_out, work, grad_loc, grad_attn, S, Lq, H, D,
          P, wk, blocks, lv, device, stream);
  }
  return launch_bwd_as<T, A, VEC, -1>(value, loc, attn, grad_out, work,
                                      grad_loc, grad_attn, S, Lq, H, D, P, wk,
                                      blocks, lv, device, stream);
}

// ------------------------------------------------------------------ bf16
// bf16 grad_value: the f32 sum rounded once, 4 elements a thread per step
// (16-byte loads, 8-byte stores) where both pointers allow it.
__global__ void __launch_bounds__(256) msda_round_bf16_kernel(
    const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
    long long n, int vec4) {
  const long long n4 = vec4 ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < n4; i += stride) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(in) + i);
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
  for (long long i = 4 * n4 + t; i < n; i += stride)
    out[i] = __float2bfloat16(in[i]);
}

// A bf16 row of 32 channels, widened: four 16-byte loads through the
// read-only path.
__device__ __forceinline__ void load_row32(const __nv_bfloat16* p,
                                           float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + i);
    unpack_bf16x2(t.x, &v[8 * i + 0], &v[8 * i + 1]);
    unpack_bf16x2(t.y, &v[8 * i + 2], &v[8 * i + 3]);
    unpack_bf16x2(t.z, &v[8 * i + 4], &v[8 * i + 5]);
    unpack_bf16x2(t.w, &v[8 * i + 6], &v[8 * i + 7]);
  }
}

// <g, row> over the 32 channels of a bf16 row: four 16-byte loads through
// the read-only path, widened, summed in f32.
__device__ __forceinline__ float dot_row32(const __nv_bfloat16* p,
                                           const float (&g)[32]) {
  uint4 t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    t[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u[4] = {t[i].x, t[i].y, t[i].z, t[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lo, hi;
      unpack_bf16x2(u[e], &lo, &hi);
      dot += g[8 * i + 2 * e] * lo;
      dot += g[8 * i + 2 * e + 1] * hi;
    }
  }
  return dot;
}

// The long launches at D = 32 with 16-byte aligned rows (the encoder's):
// msda_bwd_run_kernel's geometry (8 lanes x 4 channels a row, a warp's run
// of MSDA_RUN_Q = 8 consecutive queries, one set-up of 8 queries x 4
// samples a round) with each round split in two. First every lane serves
// the sample it set up, alone: its query's whole grad_out row and its four
// corners' whole rows (4 x 16 bytes each), the four dot products,
// grad_attn and grad_loc, all in the lane: no shuffles, no cross-lane
// sums. Then the scatter, the queries in order: group r takes the corner
// rows and the forward's weights of its sample from the lane that set it
// up (two shuffles a corner), and merges and sends as msda_bwd_run_kernel
// does, into the f32 workspace.
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_bf16_split_kernel(
    const __nv_bfloat16* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const __nv_bfloat16* __restrict__ grad_out,
    float* __restrict__ work, float* __restrict__ grad_loc,
    float* __restrict__ grad_attn, int S, int Lq, int H, int P, int n_runs,
    const __grid_constant__ Levels lv) {
  constexpr int D = 32, VEC = 4, G = 8, R = 4;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 3;                   // the gather's row group
  const int ch = (lane & (G - 1)) * VEC;     // this lane's channels
  const int jq = lane >> 2, js = lane & (R - 1);  // the set-up
  const int LP = lv.n * P;
  const int run = blockIdx.x % n_runs, bh = blockIdx.x / n_runs;
  const int b = bh / H, h = bh % H;
  const int q0 = (run * MSDA_WARPS + (threadIdx.x >> 5)) * G;
  if (q0 >= Lq) return;  // warp-uniform
  const int nq = min(G, Lq - q0);
  const long long bqh0 = ((long long)b * Lq + q0) * H + h;
  const long long mine = bqh0 + (long long)jq * H;
  const long long row_stride = (long long)H * D;  // a token of value
  const long long bh_off = (long long)b * S * row_stride + (long long)h * D;
  const __nv_bfloat16* val_bh = value + bh_off;
  float* work_bh = work + bh_off;

  for (int k0 = 0; k0 < LP; k0 += R) {
    const int k = k0 + js;
    const bool own = jq < nq && k < LP;
    const SampleSetup<float> s = msda_setup(loc + mine * LP * 2,
                                            attn + mine * LP, own ? k : LP,
                                            LP, P, lv);
    float wa[4] = {0.f, 0.f, 0.f, 0.f};  // the forward's weights
    if (own) {
      float g[32];
      load_row32(grad_out + mine * D, g);
      float ga = 0.f, gx = 0.f, gy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (s.off[c] >= 0) {
          float wx, wy, w;
          msda_corner_weights(c, s.fx, s.fy, &wx, &wy, &w);
          wa[c] = __fmul_rn(w, s.a);
          const float dot =
              dot_row32(val_bh + (long long)s.off[c] * row_stride, g);
          ga += w * dot;
          gx += ((c & 1) ? wy : -wy) * dot;   // dw/dfx
          gy += ((c >> 1) ? wx : -wx) * dot;  // dw/dfy
        }
      }
      const long long at = mine * LP + k;
      grad_attn[at] = ga;
      grad_loc[2 * at] = s.a * gx * (float)s.wl;
      grad_loc[2 * at + 1] = s.a * gy * (float)s.hl;
    }
    int pend_off[4] = {-1, -1, -1, -1};  // per corner: the row owed
    float pend[4][VEC];                  // and its sum
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= nq) break;  // warp-uniform
      const int src = j * R + r;  // the lane that set up this sample
      float g[VEC];
      load_vec<VEC>(grad_out + (bqh0 + (long long)j * H) * D + ch, g);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int off = __shfl_sync(MSDA_FULL, s.off[c], src);
        const float w_a = __shfl_sync(MSDA_FULL, wa[c], src);
        if (off < 0 || w_a == 0.f) continue;
        if (off == pend_off[c]) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) pend[c][e] += w_a * g[e];
        } else {
          if (pend_off[c] >= 0)
            red_add_vec<VEC>(work_bh + (long long)pend_off[c] * row_stride +
                             ch, pend[c]);
          pend_off[c] = off;
#pragma unroll
          for (int e = 0; e < VEC; ++e) pend[c][e] = w_a * g[e];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (pend_off[c] >= 0)
        red_add_vec<VEC>(work_bh + (long long)pend_off[c] * row_stride + ch,
                         pend[c]);
  }
}

static cudaError_t launch_bwd_bf16_split(
    const void* value, const void* loc, const void* attn,
    const void* grad_out, float* work, void* grad_loc, void* grad_attn,
    int S, int Lq, int H, int P, int n_runs, long long blocks,
    const Levels& lv, int device, cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  cudaError_t err =
      msda_prefer_l1(msda_bwd_bf16_split_kernel, device, asked);
  if (err != cudaSuccess) return err;
  msda_bwd_bf16_split_kernel<<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
      (const __nv_bfloat16*)grad_out, work, (float*)grad_loc,
      (float*)grad_attn, S, Lq, H, P, n_runs, lv);
  return msda_counted(g_bwd_routes, MSDA_BWD_BF16_SPLIT);
}

static cudaError_t launch_round_bf16(const float* work, void* grad_value,
                                     long long n, int device,
                                     cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = msda_sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int vec4 = (((size_t)work | (size_t)grad_value) % 16) == 0;
  const long long want = ((vec4 ? n / 4 : n) + 255) / 256;
  const long long blocks = want < 1 ? 1 : (want < 8LL * sms ? want : 8LL * sms);
  msda_round_bf16_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      work, (__nv_bfloat16*)grad_value, n, vec4);
  return cudaGetLastError();
}

// The bf16 route: `work` (f32, value's shape, 16-byte aligned; its
// contents on entry do not matter) is zeroed here, takes the sum, and is
// rounded once into grad_value: three launches on `stream`. Rows are read
// in at most 8-byte vectors (8 lanes x 4 channels a row at D = 32, so that
// each lane's 16-byte f32 reduction sits beside its neighbours'); the long
// launches at D = 32 with 16-byte aligned rows take the split kernel, every
// other launch msda_bwd_kernel.
static cudaError_t bwd_bf16(const void* value, const void* loc,
                            const void* attn, const void* grad_out,
                            float* work, void* grad_value, void* grad_loc,
                            void* grad_attn, int B, int S, int Lq, int H,
                            int D, int P, const Levels& lv, int device,
                            cudaStream_t s) {
  const long long n = (long long)B * S * H * D;
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)n * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if ((long long)B * Lq * H > 0) {
    const int vb = msda_vec_width(D, 4, 2, value, grad_out, grad_out);
    const int vw = msda_vec_width(D, 4, 4, work, work, work);
    const int vec = vb < vw ? vb : vw;
    Work wk;
    long long blocks;
    err = msda_plan(&wk, B, Lq, H, D, vec, device, &blocks);
    if (err != cudaSuccess) return err;
    const bool rows16 = (((size_t)value | (size_t)grad_out) % 16) == 0;
    if (D == 32 && vec == 4 && rows16 && wk.qpw > 1) {
      const int n_runs = (Lq + MSDA_WARPS * MSDA_RUN_Q - 1) /
                         (MSDA_WARPS * MSDA_RUN_Q);
      blocks = (long long)B * H * n_runs;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      err = launch_bwd_bf16_split(value, loc, attn, grad_out, work, grad_loc,
                                  grad_attn, S, Lq, H, P, n_runs, blocks, lv,
                                  device, s);
    } else {
#define MSDA_BWD_BF16(VEC)                                                    \
  err = launch_bwd<__nv_bfloat16, float, VEC>(value, loc, attn, grad_out,     \
                                              work, grad_loc, grad_attn, B, S, \
                                              Lq, H, D, P, lv, device, s);    \
  break
      switch (vec) {
        case 4: MSDA_BWD_BF16(4);
        case 2: MSDA_BWD_BF16(2);
        default: MSDA_BWD_BF16(1);
      }
#undef MSDA_BWD_BF16
    }
    if (err != cudaSuccess) return err;
  }
  return launch_round_bf16(work, grad_value, n, device, s);
}

extern "C" {

// Returns the cudaError_t of the launches (0 = success). `dtype` is a
// MsdaDtype. f32 and f64 value: `work` is grad_value itself, of value's
// shape and type, holding zeros on entry, and receives the sum. bf16 value
// (MSDA_BF16, grad_out bf16 too, loc / attn f32): `work` is an f32 buffer
// of value's shape whose contents do not matter (bwd_bf16 above), and
// grad_value the bf16 result. grad_loc and grad_attn are overwritten.
int msda_bwd(const void* value, const void* loc, const void* attn,
             const void* grad_out, void* work, void* grad_value,
             void* grad_loc, void* grad_attn, int B, int S, int Lq, int H,
             int D, int L, int P, const int* shapes, int dtype, int device,
             void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, shapes, L, S);
  if (err != cudaSuccess) return (int)err;
  if (dtype != MSDA_F32 && dtype != MSDA_BF16 && dtype != MSDA_F64)
    return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MSDA_BF16)
    return (int)bwd_bf16(value, loc, attn, grad_out, (float*)work, grad_value,
                         grad_loc, grad_attn, B, S, Lq, H, D, P, lv, device,
                         s);
  if ((long long)B * Lq * H == 0) return (int)cudaSuccess;
#define MSDA_BWD(T, A, VEC, W)                                               \
  err = launch_bwd<T, A, VEC>(value, loc, attn, grad_out, W, grad_loc,       \
                              grad_attn, B, S, Lq, H, D, P, lv, device, s); \
  break
  if (dtype == MSDA_F64) {
    double* wd = (double*)work;
    switch (msda_vec_width(D, 2, 8, value, grad_out, work)) {
      case 2: MSDA_BWD(double, double, 2, wd);
      default: MSDA_BWD(double, double, 1, wd);
    }
    return (int)err;
  }
  float* w = (float*)work;
  switch (msda_vec_width(D, 4, 4, value, grad_out, work)) {
    case 4: MSDA_BWD(float, float, 4, w);
    case 2: MSDA_BWD(float, float, 2, w);
    default: MSDA_BWD(float, float, 1, w);
  }
#undef MSDA_BWD
  return (int)err;
}

// out[r] = the launches of route r (MsdaBwdRoute) since the library was
// loaded, counted on the host where each kernel is enqueued without error.
void datr_msda_bwd_routes(long long* out) {
  for (int r = 0; r < MSDA_BWD_ROUTES; ++r)
    out[r] = g_bwd_routes[r].load(std::memory_order_relaxed);
}

}  // extern "C"
