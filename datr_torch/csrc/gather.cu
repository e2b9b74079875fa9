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
// row_gather: bound by memory traffic, the rows gathered (read) and the
// output written. The TPU's scalar prefetch of the indices has no
// counterpart: each thread loads its own index (L1-broadcast within a row).
// One thread per 16-byte vector of a row, so neighbouring lanes read
// neighbouring bytes of one row (a 128-wide f32 row is one warp, a 128-wide
// bf16 row half a warp). At the bench's sizes (a few us) the launch's own
// fixed cost, about 1.3 us on an H100 for a launch that gathers one row, is
// a third to all of its time.
//
// gather_fma: past that fixed cost, latency bounds it, not bytes (the table
// is L2-resident): each output waits on its indices, then on K rows from
// L2, then on its sum. The design keeps that chain two loads deep. A
// thread (again one per 16-byte vector of an output row) first loads the
// row's K indices and weights, as 16-byte vectors where K = 16 and the
// pointers allow; then it issues all of a chunk's row loads before the
// first multiply, an index outside the table being a predicated zero row
// (and weight), not a branch; then it sums in f32 in ascending k (fused
// multiply-adds). K = 16 is one fully unrolled chunk (64 registers of rows
// in flight); any other K goes through chunks of 8. 256-thread blocks: the
// bench's 2,048 outputs give 128 blocks of 8 warps, at most one per SM;
// more, smaller blocks carry the same work per SM and measured slower
// (PERF.md). Rows outside the table read as zeros in both kernels. Row
// bytes must be a multiple of 16 and the table 16-byte aligned (the
// wrappers check).

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

constexpr int kFmaThreads = 256;

// bf16 table and output, one thread per 8-element vector of an output row,
// the K terms of a row in chunks of C. KT = K known at compile time (then
// C == KT, one chunk, and idx / w rows are read as 16-byte vectors: they
// must be 16-byte aligned), or 0: K at run time, read one by one.
template <int C, int KT>
__global__ void __launch_bounds__(kFmaThreads) gather_fma_kernel(
    const uint4* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, uint4* __restrict__ out, int n_table,
    long long n_vec, int vpr, int k_run) {
  static_assert(KT == 0 || (KT == C && KT % 4 == 0), "KT is one 16-byte chunk");
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const int K = KT ? KT : k_run;
  const long long q = t / vpr;
  const int v = (int)(t - q * vpr);
  const int* iq = idx + q * K;
  const float* wq = w + q * K;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += C) {
    int src[C];
    float ws[C];
    if constexpr (KT != 0) {
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(iq) + j);
        const float4 b = __ldg(reinterpret_cast<const float4*>(wq) + j);
        src[4 * j] = a.x, src[4 * j + 1] = a.y, src[4 * j + 2] = a.z,
        src[4 * j + 3] = a.w;
        ws[4 * j] = b.x, ws[4 * j + 1] = b.y, ws[4 * j + 2] = b.z,
        ws[4 * j + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const bool live = k0 + j < K;
        src[j] = live ? __ldg(iq + k0 + j) : -1;
        ws[j] = live ? __ldg(wq + k0 + j) : 0.f;
      }
    }
    // every row load of the chunk in flight before the first multiply
    uint4 row[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool inside = src[j] >= 0 && src[j] < n_table;
      row[j] = inside ? __ldg(table + (long long)src[j] * vpr + v)
                      : make_uint4(0u, 0u, 0u, 0u);
      if (!inside) ws[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (KT == 0 && k0 + j >= K) break;  // a short last chunk: no dead work
      float f[8];
      widen(row[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(f[e], ws[j], acc[e]);
    }
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
  const unsigned blocks = (unsigned)((n_vec + kFmaThreads - 1) / kFmaThreads);
  const bool aligned = ((size_t)idx | (size_t)w) % 16 == 0;
  if (K == 16 && aligned)
    gather_fma_kernel<16, 16><<<blocks, kFmaThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)idx, (const float*)w, (uint4*)out,
        n_table, n_vec, vpr, K);
  else
    gather_fma_kernel<8, 0><<<blocks, kFmaThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)idx, (const float*)w, (uint4*)out,
        n_table, n_vec, vpr, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
