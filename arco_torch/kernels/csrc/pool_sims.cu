// Few-vs-few similarity over a huge feature axis, for Hopper (sm_90a):
//   sims[b, k] = sum_f queries[b, f] * pool[k, f],   f32 accumulation.
// Plain C interface, loaded with ctypes by arco_torch/kernels/pool_sims.py.
//
// Replaces the TPU kernel arco_tpu/ops/pallas/pool_sims.py:
// pool_similarities / _pool_sims_kernel, the contraction behind the
// revisiting loss (B = 2 * B_u queries: the student and teacher reps of the
// unlabeled images; K = 36 pool rows; F = 496*256*256 = 32.5M in 2D,
// 16*112*112*80 = 16.1M in 3D; bf16).
//
// What bounds it on this card: bytes. The operands are (B + K) * F * 2 B =
// 2.6 GB in 2D at B = 4, read once; the arithmetic is 2*B*K flops per pool
// element pair, about 9 GFLOP, nothing for the card. As a matrix product
// the shape [4, 32.5M] x [32.5M, 36] leaves the tensor cores idle and needs
// a split over F anyway. So the design is a streaming split-F reduction:
//   stage 1: block i owns an F-chunk. It stages the query slices of that
//            chunk in shared memory (bf16), then each warp takes pool rows
//            k = warp, warp + 8, ... and streams the row's chunk once with
//            16-byte loads, accumulating one dot product per query in f32
//            registers; a warp shuffle sum writes partial[i, b, k]. Up to
//            kGroup = 16 query rows ride on one pass of the pool, so every
//            input byte is read from memory once. The chunk is 4096
//            elements for up to 8 rows and 2048 for 9 to 16, which keeps the
//            staged queries at 64 KB. Beyond 16 rows the rows go in groups of
//            16, one pass of the pool each.
//   stage 2: one block per (b, k) sums the n_chunks partials in a fixed
//            order. No float atomics: the result is bit-for-bit the same on
//            every run, which matters because the revisiting loss takes
//            top-k of these similarities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using arco::unpack8;
using arco::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;              // query rows on one pass of the pool

// F elements per stage-1 block for a launch of B query rows
int chunk_for(int B) { return B <= 8 ? 4096 : 2048; }

// MB: the register accumulators a thread keeps, one per query row (>= G);
// CHUNK: F elements per block. Both compile-time, so the staged rows sit
// at constant offsets.
template <int MB, int CHUNK>
__global__ void __launch_bounds__(kThreads)
pool_sims_partial_kernel(const __nv_bfloat16* __restrict__ queries,  // [G,F]
                         const __nv_bfloat16* __restrict__ pool,     // [K,F]
                         float* __restrict__ partial,     // [n, B_total, K]
                         int G, int b0, int B_total, int K, long long F) {
  constexpr int chunk8 = CHUNK / 8;
  extern __shared__ uint4 qs[];         // [G, chunk8]
  const long long base = (long long)blockIdx.x * CHUNK;
  const long long rest = F - base;
  const int len8 = (int)((rest < CHUNK ? rest : CHUNK) >> 3);
  for (int b = 0; b < G; ++b) {
    const uint4* src =
        reinterpret_cast<const uint4*>(queries + (long long)b * F + base);
    for (int j = threadIdx.x; j < len8; j += kThreads)
      qs[b * chunk8 + j] = __ldg(src + j);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < K; k += kWarps) {
    const uint4* prow =
        reinterpret_cast<const uint4*>(pool + (long long)k * F + base);
    float acc[MB];
#pragma unroll
    for (int b = 0; b < MB; ++b) acc[b] = 0.f;
    for (int j = lane; j < len8; j += 32) {
      float p[8];
      unpack8(__ldcs(prow + j), p);     // streamed once: evict-first
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        if (b < G) {
          float q[8];
          unpack8(qs[b * chunk8 + j], q);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[b] = fmaf(p[e], q[e], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      if (b < G) {
        const float s = warp_sum(acc[b]);
        if (lane == 0)
          partial[((long long)blockIdx.x * B_total + b0 + b) * K + k] = s;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pool_sims_reduce_kernel(const float* __restrict__ partial,  // [n, BK]
                        float* __restrict__ out,            // [BK]
                        int n_chunks, int BK) {
  __shared__ float red[kWarps];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads)
    s += partial[(long long)c * BK + o];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    out[o] = t;
  }
}

template <int MB, int CHUNK>
cudaError_t launch_partial(const __nv_bfloat16* queries,
                           const __nv_bfloat16* pool, float* partial, int G,
                           int b0, int B, int K, long long F, int n_chunks,
                           cudaStream_t stream) {
  const size_t smem = (size_t)G * (CHUNK / 8) * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      pool_sims_partial_kernel<MB, CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pool_sims_partial_kernel<MB, CHUNK><<<n_chunks, kThreads, smem, stream>>>(
      queries, pool, partial, G, b0, B, K, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int arco_pool_sims_chunk(int B) { return chunk_for(B); }

// partial must hold ceil(F / arco_pool_sims_chunk(B)) * B * K floats.
int arco_pool_sims(const void* queries, const void* pool, void* partial,
                   void* out, int B, int K, long long F, void* stream) {
  const int chunk = chunk_for(B);
  const int n_chunks = (int)((F + chunk - 1) / chunk);
  const cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* q = (const __nv_bfloat16*)queries;
  const __nv_bfloat16* p = (const __nv_bfloat16*)pool;
  float* part = (float*)partial;
  for (int b0 = 0; b0 < B; b0 += kGroup) {
    const int G = B - b0 < kGroup ? B - b0 : kGroup;
    const __nv_bfloat16* qg = q + (long long)b0 * F;
    cudaError_t err;
    if (B <= 8)
      err = launch_partial<8, 4096>(qg, p, part, G, b0, B, K, F, n_chunks, s);
    else if (G <= 8)      // the last group of more than 16 rows
      err = launch_partial<8, 2048>(qg, p, part, G, b0, B, K, F, n_chunks, s);
    else
      err = launch_partial<kGroup, 2048>(qg, p, part, G, b0, B, K, F,
                                         n_chunks, s);
    if (err != cudaSuccess) return (int)err;
  }
  pool_sims_reduce_kernel<<<B * K, kThreads, 0, s>>>(
      (const float*)partial, (float*)out, n_chunks, B * K);
  return (int)cudaGetLastError();
}

}  // extern "C"
