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
//   value [B, S, H, D]   float or bfloat16
//   loc   [B, Lq, H, L, P, 2] float (x, y normalized to [0, 1])
//   attn  [B, Lq, H, L, P]    float (softmaxed over L*P)
//   out   [B, Lq, H, D]   value's type (the caller views it as [B, Lq, H*D])
//
// What bounds it: memory traffic. Per (b, q, h) it reads 16 samples' loc and
// attn and gathers up to 64 value rows of D elements; it does 2 flops per
// gathered element, far below the card's compute rate. The least traffic is
// value + loc + attn read once and out written once; the gathered rows are
// re-read from L2 (value is 46 MB in f32 at the flagship encoder shape, under
// the 50 MB L2). Design, first version: one warp per (b, q, h), lanes over
// channels, so each corner's row is one coalesced 128-byte read at D = 32 in
// f32; every lane computes the sample coordinates itself (the loc/attn loads
// are warp-uniform broadcasts). No shared memory, no tensor cores: the work is
// a data-dependent gather. Making it fast (sample-parallel lanes, bf16x2
// loads, L2-aware query ordering) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "msda_common.cuh"

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(256) msda_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, T* __restrict__ out, int S, int Lq, int H,
    int D, int P, long long n_warps, Levels lv) {
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(warp % H);
  const int b = (int)(warp / ((long long)H * Lq));
  const int LP = lv.n * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const long long row_stride = (long long)H * D;  // one token of value
  const T* val_bh = value + (long long)b * S * row_stride + (long long)h * D;
  T* out_w = out + warp * D;

  for (int c = lane; c - lane < D; c += 32) {
    const bool live = c < D;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const T* val_l = val_bh + (long long)lv.start[l] * row_stride;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const Sample s =
            msda_sample(__ldg(loc_w + 2 * k), __ldg(loc_w + 2 * k + 1), hl, wl);
        const float a = __ldg(attn_w + k);
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
            const float wgt = __fmul_rn(__fmul_rn(wx, wy), a);
            if (live)
              acc += wgt * load_f32(val_l + ((long long)cy * wl + cx) *
                                                row_stride + c);
          }
        }
      }
    }
    if (live) store_val(out_w + c, acc);
  }
}

extern "C" {

// Returns the cudaError_t of the launch (0 = success). `shapes` is a host
// array of L (h, w) pairs; the level starts follow from it.
int msda_fwd(const void* value, const void* loc, const void* attn, void* out,
             int B, int S, int Lq, int H, int D, int L, int P,
             const int* shapes, int value_is_bf16, int device, void* stream) {
  Levels lv;
  cudaError_t err = fill_levels(&lv, shapes, L, S);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_warps = (long long)B * Lq * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_warps + (threads / 32) - 1) / (threads / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (value_is_bf16) {
    msda_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
        (__nv_bfloat16*)out, S, Lq, H, D, P, n_warps, lv);
  } else {
    msda_fwd_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, S, Lq, H, D, P, n_warps, lv);
  }
  return (int)cudaGetLastError();
}

const char* datr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
