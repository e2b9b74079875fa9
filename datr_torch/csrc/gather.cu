// Row-gather microbenchmark kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of the gather microbenchmarks:
//   row_gather  <- tools/msda_pallas_bench.py:copy_kernel (:57, via run_copy
//                  :65) and tools/mosaic_probe.py's three probes
//                  (probe_vectorized_gather :55, probe_dynamic_sublane_load
//                  :71 with its +1 row offset, probe_partial_unroll :96):
//                  out[i] = table[idx[i] + offset]
//   gather_fma  <- tools/msda_pallas_bench.py:fma_kernel (:79, via run_fma
//                  :96), MSDA's inner operation:
//                  out[q] = sum_{k<K} w[K*q + k] * f32(table[idx[K*q + k]]),
//                  accumulated in f32 and stored as bf16 (the bench's
//                  table type; the only one it takes).
// They compute the functions the tools document over every index (the TPU
// copy_kernel and fma_kernel read idx with the in-block row only, so each grid
// step re-gathers the first block; that quirk is not carried over).
//
// What bounds them: memory traffic — the rows gathered (read) and the output
// written; no arithmetic to speak of. The TPU's scalar prefetch of the
// indices has no counterpart: each thread loads its own index (L1-broadcast
// within a row). Design: one thread per 16-byte vector of a row, so
// neighbouring lanes read neighbouring bytes of one row (a 128-wide f32 row is
// one warp, a 128-wide bf16 row half a warp). Rows outside the table read as
// zeros. Row bytes must be a multiple of 16 and the pointers 16-byte aligned
// (the wrappers check).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) row_gather_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx,
    uint4* __restrict__ out, int n_table, long long n_vec, int vpr,
    int offset) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const long long row = t / vpr;
  const int v = (int)(t - row * vpr);
  const int src = __ldg(idx + row) + offset;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (src >= 0 && src < n_table) val = __ldg(table + (long long)src * vpr + v);
  out[t] = val;
}

// The eight bf16 elements of one 16-byte vector, widened to f32, and back.
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// bf16 table and output, one thread per 8-element vector of an output row.
__global__ void __launch_bounds__(256) gather_fma_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, uint4* __restrict__ out, int n_table,
    long long n_vec, int vpr, int K) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const long long q = t / vpr;
  const int v = (int)(t - q * vpr);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long s = q * K + k;
    const int src = __ldg(idx + s);
    if (src < 0 || src >= n_table) continue;
    const float ws = __ldg(w + s);
    float f[8];
    widen(__ldg(table + (long long)src * vpr + v), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __fmul_rn(f[e], ws);
  }
  out[t] = narrow(acc);
}

extern "C" {

// out[i] = table[idx[i] + offset] for i < n_rows; rows of row_bytes bytes.
int row_gather(const void* table, const void* idx, void* out, int n_table,
               long long n_rows, int row_bytes, int offset, int device,
               void* stream) {
  if (row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vpr = row_bytes / 16;
  const long long n_vec = n_rows * vpr;
  if (n_vec == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_vec + threads - 1) / threads;
  row_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, n_table, n_vec, vpr,
      offset);
  return (int)cudaGetLastError();
}

// out[q] = sum_{k<K} w[K*q+k] * table[idx[K*q+k]] for q < n_out, bf16 rows
// of `width` elements, accumulated in f32.
int gather_fma(const void* table, const void* idx, const void* w, void* out,
               int n_table, long long n_out, int width, int K, int device,
               void* stream) {
  if (width <= 0 || width % 8 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vpr = width / 8;
  const long long n_vec = n_out * vpr;
  if (n_vec == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_vec + threads - 1) / threads;
  gather_fma_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (const float*)w, (uint4*)out,
      n_table, n_vec, vpr, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
