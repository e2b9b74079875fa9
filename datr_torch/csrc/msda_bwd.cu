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
// Layouts (all contiguous, f32):
//   value, grad_value [B, S, H, D]   (grad_value zeroed by the wrapper)
//   loc, grad_loc     [B, Lq, H, L, P, 2]
//   attn, grad_attn   [B, Lq, H, L, P]
//   grad_out          [B, Lq, H, D]
//
// What bounds it on this card: the rate at which L2 takes the reductions into
// grad_value, then L1's gather rate as in the forward (msda_fwd.cu); about 4
// flops per gathered element against them. The floor of the function is
// device memory: the value rows the samples touch read once and grad_value
// written once (plus grad_out/loc/attn read, grad_loc/grad_attn written).
// The scatter-add instead sends one read-modify-write of a row to L2 per
// corner, up to 4*L*P per (b, q, h): 6.6 GB of reductions per launch at the
// training encoder shape on top of as many gathered bytes, where value and
// grad_value are 106 MB each (over the 50 MB L2 together or alone).
// What the design does about it (steps 1-3 are the forward's):
// 1. the same one-time set-up per warp (msda_common.cuh:msda_setup), so
//    grad_loc takes the slope of the cell the forward sampled;
// 2. 16-byte gathers by groups of G lanes with VEC channels each; grad_out's
//    row is read once per (b, q, h) into registers;
// 3. the same cache-local work order: the card works on one or two (b, h)
//    slices of value and grad_value at a time, so the reductions meet their
//    rows in L2 instead of device memory (the largest gain at scattered
//    locations);
// 4. vector reductions: a*w*g goes out as one 16-byte atomicAdd per lane and
//    corner (red.global.add.v4.f32, compute capability 9.x), a quarter of the
//    scalar atomics; a corner whose weight is exactly zero (half of them at
//    integer pixel coordinates, where the model's initial offsets put the
//    samples of a query's own level) adds nothing and is not sent. A group
//    serves the four corners of one sample in turn, so the three dot products
//    per sample are summed in the lane first and cross only the group's G
//    lanes (3 x log2 G shuffles per sample instead of 3 x 5); the sample's
//    owner lane gets them back by shuffle and writes grad_attn and grad_loc
//    coalesced.
// 5. merging before scattering, in registers (msda_bwd_run_kernel, the long
//    launches at D = 32): a warp serves 8 consecutive queries of its head and
//    keeps, per corner, the row it last added to and the sum not yet sent;
//    the next query's same sample on the same row (2, 4 or 8 neighbouring
//    pixels share a cell on each coarser level) joins the sum, and one
//    reduction goes out for the run of them. Shared memory is not used for
//    it: a float atomicAdd there is a compare-and-swap loop on this card.
// Atomics make grad_value's sum order (and its last bits) vary from run to
// run.

#include <cuda_runtime.h>

#include "msda_common.cuh"

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

// LG as in the forward: the lanes per row fixed at compile time (D = 32), or
// read from the launch's geometry where LG < 0.
template <int VEC, int LG>
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc,
    float* __restrict__ grad_attn, int S, int Lq, int H, int D, int P,
    const Work wk, const __grid_constant__ Levels lv) {
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
    const float* loc_w = loc + bqh * LP * 2;
    const float* attn_w = attn + bqh * LP;
    float* gloc_w = grad_loc + bqh * LP * 2;
    float* gattn_w = grad_attn + bqh * LP;
    const long long bh = (long long)b * S * row_stride + (long long)h * D;

    for (int c0 = 0; c0 < D; c0 += G * VEC) {
      const int ch = c0 + ch0;
      const bool live = ch < D;
      float g[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = 0.f;
      if (live) load_vec<VEC>(grad_out + bqh * D + ch, g);

      for (int k0 = 0; k0 < LP; k0 += 32) {
        const SampleSetup s = msda_setup(loc_w, attn_w, k0 + lane, LP, P, lv);
        const int n = min(LP - k0, 32);
        float ga = 0.f, gx = 0.f, gy = 0.f;  // of this lane's own sample
#pragma unroll 2
        for (int s0 = 0; s0 < n; s0 += R) {
          const int src = s0 + r;  // the lane that set up this group's sample
          const float fx = __shfl_sync(MSDA_FULL, s.fx, src);
          const float fy = __shfl_sync(MSDA_FULL, s.fy, src);
          const float a = __shfl_sync(MSDA_FULL, s.a, src);
          float pa = 0.f, px = 0.f, py = 0.f;  // lane partials of the sample
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int off = __shfl_sync(MSDA_FULL, s.off[c], src);
            if (off >= 0 && live) {
              float wx, wy, w, v[VEC];
              msda_corner_weights(c, fx, fy, &wx, &wy, &w);
              const float wa = __fmul_rn(w, a);  // the forward's weight
              const long long at = bh + (long long)off * row_stride + ch;
              load_vec<VEC>(value + at, v);
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < VEC; ++e) dot += g[e] * v[e];
              if (wa != 0.f) {
                float add[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e) add[e] = wa * g[e];
                red_add_vec<VEC>(grad_value + at, add);
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
          const float ta = __shfl_sync(MSDA_FULL, pa, from);
          const float tx = __shfl_sync(MSDA_FULL, px, from);
          const float ty = __shfl_sync(MSDA_FULL, py, from);
          if (lane >= s0 && lane < s0 + R) ga = ta, gx = tx, gy = ty;
        }
        const int k = k0 + lane;
        if (k < LP) {
          const float lx = s.a * gx * (float)s.wl;
          const float ly = s.a * gy * (float)s.hl;
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

// The long launches at D = 32 (the encoder's): 8 lanes x float4 per row, 4
// rows per gather. A warp serves MSDA_RUN_Q CONSECUTIVE queries of its
// (batch, head), one group of 4 samples at a time: lane j sets up sample
// k0 + j % 4 of query q0 + j / 4, then the queries go by in order, and each
// lane holds, per corner, the row and the sum of what it has not yet sent.
// Where the next query's same sample falls on the same row (neighbouring
// pixels do on every coarser level: 2, 4 or 8 queries to a cell), the
// contribution joins the sum in registers and one reduction goes out for the
// run of them.
#define MSDA_RUN_Q 8
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_run_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc,
    float* __restrict__ grad_attn, int S, int Lq, int H, int P, int n_runs,
    const __grid_constant__ Levels lv) {
  constexpr int D = 32, VEC = 4, R = 4;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 3;         // which of the 4 rows of a gather
  const int ch = (lane & 7) * VEC;  // this lane's channels
  const int jq = lane >> 2, js = lane & 3;  // the set-up this lane does
  const int LP = lv.n * P;
  const int row_stride = H * D;  // one token of value
  const int run = blockIdx.x % n_runs, bh = blockIdx.x / n_runs;
  const int b = bh / H, h = bh % H;
  const int q0 = (run * MSDA_WARPS + (threadIdx.x >> 5)) * MSDA_RUN_Q;
  if (q0 >= Lq) return;  // warp-uniform
  const int nq = min(MSDA_RUN_Q, Lq - q0);
  // index of (b, q0, h) into the [B, Lq, H] arrays; a query further is + H
  const long long bqh0 = ((long long)b * Lq + q0) * H + h;
  const long long bh_off = (long long)b * S * row_stride + (long long)h * D;
  const float* val_ch = value + bh_off + ch;
  float* gval_ch = grad_value + bh_off + ch;
  const long long mine = bqh0 + (long long)jq * H;

  for (int k0 = 0; k0 < LP; k0 += R) {
    const int k = k0 + js;
    const SampleSetup s = msda_setup(loc + mine * LP * 2, attn + mine * LP,
                                     jq < nq ? k : LP, LP, P, lv);
    int pend_off[4] = {-1, -1, -1, -1};  // per corner: the row not yet sent
    float pend[4][VEC];                  // and its sum
    float ga = 0.f, gx = 0.f, gy = 0.f;  // of this lane's own sample
#pragma unroll
    for (int j = 0; j < MSDA_RUN_Q; ++j) {
      if (j >= nq) break;  // warp-uniform
      const int src = j * R + r;  // the lane that set up this group's sample
      const float fx = __shfl_sync(MSDA_FULL, s.fx, src);
      const float fy = __shfl_sync(MSDA_FULL, s.fy, src);
      const float a = __shfl_sync(MSDA_FULL, s.a, src);
      float g[VEC];
      load_vec<VEC>(grad_out + (bqh0 + (long long)j * H) * D + ch, g);
      float pa = 0.f, px = 0.f, py = 0.f;  // lane partials of the sample
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int off = __shfl_sync(MSDA_FULL, s.off[c], src);
        if (off >= 0) {
          float wx, wy, w, v[VEC];
          msda_corner_weights(c, fx, fy, &wx, &wy, &w);
          const float wa = __fmul_rn(w, a);  // the forward's weight
          load_vec<VEC>(val_ch + (long long)off * row_stride, v);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += g[e] * v[e];
          if (wa != 0.f) {
            if (off == pend_off[c]) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) pend[c][e] += wa * g[e];
            } else {
              if (pend_off[c] >= 0)
                red_add_vec<VEC>(
                    gval_ch + (long long)pend_off[c] * row_stride, pend[c]);
              pend_off[c] = off;
#pragma unroll
              for (int e = 0; e < VEC; ++e) pend[c][e] = wa * g[e];
            }
          }
          pa += w * dot;
          px += ((c & 1) ? wy : -wy) * dot;   // dw/dfx
          py += ((c >> 1) ? wx : -wx) * dot;  // dw/dfy
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
      const float ta = __shfl_sync(MSDA_FULL, pa, js << 3);
      const float tx = __shfl_sync(MSDA_FULL, px, js << 3);
      const float ty = __shfl_sync(MSDA_FULL, py, js << 3);
      if (jq == j) ga = ta, gx = tx, gy = ty;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (pend_off[c] >= 0)
        red_add_vec<VEC>(gval_ch + (long long)pend_off[c] * row_stride,
                         pend[c]);
    if (jq < nq && k < LP) {
      grad_attn[mine * LP + k] = ga;
      grad_loc[(mine * LP + k) * 2] = s.a * gx * (float)s.wl;
      grad_loc[(mine * LP + k) * 2 + 1] = s.a * gy * (float)s.hl;
    }
  }
}

template <int VEC, int LG>
static cudaError_t launch_bwd_as(const void* value, const void* loc,
                                 const void* attn, const void* grad_out,
                                 void* grad_value, void* grad_loc,
                                 void* grad_attn, int S, int Lq, int H, int D,
                                 int P, const Work& wk, long long blocks,
                                 const Levels& lv, int device,
                                 cudaStream_t stream) {
  static bool asked[MSDA_MAX_DEVICES];
  cudaError_t err = msda_prefer_l1(msda_bwd_kernel<VEC, LG>, device, asked);
  if (err != cudaSuccess) return err;
  msda_bwd_kernel<VEC, LG><<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
      (const float*)value, (const float*)loc, (const float*)attn,
      (const float*)grad_out, (float*)grad_value, (float*)grad_loc,
      (float*)grad_attn, S, Lq, H, D, P, wk, lv);
  return cudaGetLastError();
}

template <int VEC>
static cudaError_t launch_bwd(const void* value, const void* loc,
                              const void* attn, const void* grad_out,
                              void* grad_value, void* grad_loc,
                              void* grad_attn, int B, int S, int Lq, int H,
                              int D, int P, const Levels& lv, int device,
                              cudaStream_t stream) {
  Work wk;
  long long blocks;
  cudaError_t err = msda_plan(&wk, B, Lq, H, D, VEC, device, &blocks);
  if (err != cudaSuccess) return err;
  // D = 32 in 16-byte vectors: the compile-time geometry
  if constexpr (VEC == 4) {
    if (D == 32 && wk.qpw > 1) {  // a long launch: runs of queries per warp
      const int n_runs = (Lq + MSDA_WARPS * MSDA_RUN_Q - 1) /
                         (MSDA_WARPS * MSDA_RUN_Q);
      static bool asked[MSDA_MAX_DEVICES];
      err = msda_prefer_l1(msda_bwd_run_kernel, device, asked);
      if (err != cudaSuccess) return err;
      msda_bwd_run_kernel<<<(unsigned)((long long)B * H * n_runs),
                            MSDA_THREADS, 0, stream>>>(
          (const float*)value, (const float*)loc, (const float*)attn,
          (const float*)grad_out, (float*)grad_value, (float*)grad_loc,
          (float*)grad_attn, S, Lq, H, P, n_runs, lv);
      return cudaGetLastError();
    }
    if (D == 32)  // 8 lanes per row
      return launch_bwd_as<VEC, 3>(value, loc, attn, grad_out, grad_value,
                                   grad_loc, grad_attn, S, Lq, H, D, P, wk,
                                   blocks, lv, device, stream);
  }
  return launch_bwd_as<VEC, -1>(value, loc, attn, grad_out, grad_value,
                                grad_loc, grad_attn, S, Lq, H, D, P, wk,
                                blocks, lv, device, stream);
}

extern "C" {

// Returns the cudaError_t of the launch (0 = success). grad_value must hold
// zeros on entry; grad_loc and grad_attn are overwritten.
int msda_bwd(const void* value, const void* loc, const void* attn,
             const void* grad_out, void* grad_value, void* grad_loc,
             void* grad_attn, int B, int S, int Lq, int H, int D, int L,
             int P, const int* shapes, int device, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, shapes, L, S);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * Lq * H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define MSDA_BWD(VEC)                                                        \
  return (int)launch_bwd<VEC>(value, loc, attn, grad_out, grad_value,       \
                              grad_loc, grad_attn, B, S, Lq, H, D, P, lv,   \
                              device, s)
  switch (msda_vec_width(D, 4, 4, value, grad_out, grad_value)) {
    case 4: MSDA_BWD(4);
    case 2: MSDA_BWD(2);
    default: MSDA_BWD(1);
  }
#undef MSDA_BWD
}

}  // extern "C"
