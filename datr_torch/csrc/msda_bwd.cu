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
// What bounds it: memory traffic — the value rows the samples touch (read),
// the same rows of grad_value (f32 read-modify-write through atomics), the
// zero-fill of grad_value, grad_out/loc/attn read once and grad_loc/grad_attn
// written once; about 4 flops per gathered element, far below the card's f32
// rate. Design, first version, mirroring msda_fwd: one warp per (b, q, h),
// lanes over channels; each lane reads its g[c] once per sample from L1, the
// corner choice comes from the same msda_sample as the forward (so grad_loc
// takes the slope of the cell the forward sampled), each corner row is one
// coalesced atomicAdd per lane, and the three per-sample dot products are
// reduced across the warp with shuffles. Atomics make grad_value's sum order
// (and its last bits) vary from run to run; at the encoder shape each
// grad_value element takes about 64 adds, which contend. Making it fast
// (sorting samples by row, shared-memory accumulation) is later work.

#include <cuda_runtime.h>

#include "msda_common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256) msda_bwd_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad_out,
    float* __restrict__ grad_value, float* __restrict__ grad_loc,
    float* __restrict__ grad_attn, int S, int Lq, int H, int D, int P,
    long long n_warps, Levels lv) {
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // warp-uniform: the shuffles below see 32 lanes
  const int lane = threadIdx.x & 31;
  const int h = (int)(warp % H);
  const int b = (int)(warp / ((long long)H * Lq));
  const int LP = lv.n * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const float* g_w = grad_out + warp * D;
  float* gloc_w = grad_loc + warp * LP * 2;
  float* gattn_w = grad_attn + warp * LP;
  const long long row_stride = (long long)H * D;  // one token of value
  const long long bh = (long long)b * S * row_stride + (long long)h * D;

  for (int l = 0; l < lv.n; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float* val_l = value + bh + (long long)lv.start[l] * row_stride;
    float* gval_l = grad_value + bh + (long long)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const Sample s =
          msda_sample(__ldg(loc_w + 2 * k), __ldg(loc_w + 2 * k + 1), hl, wl);
      const float a = __ldg(attn_w + k);
      float ga = 0.f, gx = 0.f, gy = 0.f;  // lane partials
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = s.y0 + dy;
        if (cy < 0 || cy >= hl) continue;
        const float wy = dy ? s.fy : __fsub_rn(1.f, s.fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = s.x0 + dx;
          if (cx < 0 || cx >= wl) continue;
          const float wx = dx ? s.fx : __fsub_rn(1.f, s.fx);
          const float w = __fmul_rn(wx, wy);
          const float wa = __fmul_rn(w, a);  // the forward's weight
          const long long off = ((long long)cy * wl + cx) * row_stride;
          float dot = 0.f;
          for (int c = lane; c < D; c += 32) {
            const float gc = __ldg(g_w + c);
            dot += gc * __ldg(val_l + off + c);
            atomicAdd(gval_l + off + c, wa * gc);
          }
          ga += w * dot;
          gx += (dx ? wy : -wy) * dot;  // dw/dfx
          gy += (dy ? wx : -wx) * dot;  // dw/dfy
        }
      }
      ga = warp_sum(ga);
      gx = warp_sum(gx);
      gy = warp_sum(gy);
      if (lane == 0) {
        gattn_w[k] = ga;
        gloc_w[2 * k] = a * gx * (float)wl;
        gloc_w[2 * k + 1] = a * gy * (float)hl;
      }
    }
  }
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
  const long long n_warps = (long long)B * Lq * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_warps + (threads / 32) - 1) / (threads / 32);
  msda_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)loc, (const float*)attn,
      (const float*)grad_out, (float*)grad_value, (float*)grad_loc,
      (float*)grad_attn, S, Lq, H, D, P, n_warps, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
