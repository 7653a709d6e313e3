// Few-vs-few similarity over a huge feature axis, for Hopper (sm_90a):
//   sims[b, k] = sum_f queries[b, f] * pool[k, f],   f32 accumulation.
// Plain C interface, loaded with ctypes by arco_torch/kernels/pool_sims.py.
//
// Replaces the TPU kernel arco_tpu/ops/pallas/pool_sims.py:
// pool_similarities / _pool_sims_kernel, the contraction behind the
// revisiting loss (B = 2 * B_u queries: the student and teacher reps of the
// unlabeled images, 4 in 2D and 3D, 8 on the natural path; K = 36 pool
// rows; F = 496*256*256 = 32.5M in 2D, 16*112*112*80 = 16.1M in 3D,
// 112,896 to 50.8M on the natural path; bf16).
//
// What bounds it on this card: bytes. The operands, (B + K) * F * 2 bytes,
// are read once; the arithmetic, 2 * B * K flops per feature, is far below
// the tensor cores' rate. So the design spends as few instructions per byte
// as it can and keeps enough loads in flight to cover the memory latency:
//
// - Tensor cores. The contraction runs through
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with f32
//   accumulators in registers: M is the pool rows (48 rows, three m16 tiles,
//   a block row group; rows >= K are zero and never read), N the query rows
//   (one n8 tile for 1-8 rows, two sharing the A fragments for 9-16; more
//   rows go in groups of 16 along the grid's z), and the contraction runs
//   along F. bf16 x bf16 products are exact in f32, so against a plain f32
//   loop only the order of the sum changes.
// - No shared memory and no ldmatrix for the operands. The sum over F does
//   not change under a permutation of F applied to both operands, so each
//   lane fills its fragments with one 16-byte load per row straight from
//   device memory. In m16n8k16, lane (g = lane >> 2, t = lane & 3) holds
//   the k-slots {2t, 2t+1, 2t+8, 2t+9} of A rows g and g+8 and of B column
//   g. Within a step of 32 features, lane t loads elements 8t..8t+7 of its
//   rows (the four lanes of a row read 64 contiguous bytes) and feeds two
//   mmas: in the first, slot 2t+j is element 8t+j and slot 2t+8+j element
//   8t+2+j; in the second, the same plus 4. The 32 elements of the step go
//   to the 32 slots of the two mmas one to one, in A and B alike.
// - Enough loads in flight. A warp walks a contiguous range of steps, U
//   steps an iteration with all their loads issued before the mmas: 4 x 7
//   16-byte loads a lane for up to 8 query rows, 3 x 8 for 9 to 16. The
//   pool rows are read with ld.global.nc.L2::256B: the hint has L2 fetch
//   the 256 bytes of a row that the warp's U = 4 steps read, in one go.
// - Enough blocks at every F. The grid is sized from F and the SM count:
//   one resident block of 12 warps per SM, its warps on adjacent F-ranges
//   (measured faster on the H100 than three blocks of 4 warps, which give
//   the same warps per SM), each warp at least one iteration, fewer blocks
//   when F is small. The ragged tail (F a multiple of 8, not of 32) is
//   masked per lane.
// - One launch, deterministic. Each block sums its warps' tiles in shared
//   memory in a fixed order and writes its partial [B, K]; the last block
//   to finish (an integer ticket after __threadfence, no float atomics)
//   sums the blocks' partials in block order and resets the ticket. The
//   result is bit-for-bit the same on every run, which matters because the
//   revisiting loss takes top-k of these similarities.
//
// The f32 route (pool_sims_f32_kernel; the stage-2 step at
// --compute_dtype float32): f32 queries against a pool in bf16 (the CLIs'
// default) or f32, each pool element widened in registers (bf16 -> f32 is
// exact), f32 FMAs in the order of F within a lane: what
// _pool_sims_kernel computes, with no rounding of the operands. Still
// bound by bytes: at the 2D shapes 36 bf16 pool rows and 4 f32 query rows
// of 32.5M are ~2.86 GB, ~0.85 ms, against 9.4 GFLOP, ~0.14 ms at f32's
// rate.
// - The block's 12 warps walk the same F-range and split the pool rows:
//   warp w takes rows k0 + w + 12 i (i < 4, a group of 48 rows along the
//   grid's y), so a lane holds 4 x QB accumulators for QB query rows (4 or
//   8, more in groups along z). Lane l reads features 4l..4l+3 of each
//   half of a 256-feature step: 8 (bf16) or 16 bytes a pool row, 16 a
//   query row, so each load instruction of the warp reads one contiguous
//   run; the warps after the first find the queries in L1.
// - Two steps' loads in flight before their FMAs at QB = 4, one at 8.
// - Each warp sums its accumulators over its lanes (a fixed butterfly) and
//   writes its rows of the block's partial [B, K]; the last block sums the
//   partials as the bf16 route does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using arco::warp_sum;

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 1;
constexpr int kTilesM = 3;                 // m16 tiles of pool rows a block
constexpr int kRowsM = 16 * kTilesM;       // pool rows a block
constexpr int kReduceUnroll = 16;          // float4 loads in flight, final sum

// steps of 32 features an iteration: 7 loads a step for one n8 tile, 8 for
// two, about 24-28 loads a lane in flight
template <int NB>
__host__ __device__ constexpr int unroll() { return NB == 1 ? 4 : 3; }

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A pool load: read once, not through L1, and a hint that L2 fetch the 256
// bytes around the address (the row's next steps)
__device__ __forceinline__ uint4 ld_pool(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One 32-feature step of tile (i, j): A rows g / g+8 in lo / hi, B column g
// in q, two mmas (the lane's elements 8t..8t+3, then 8t+4..8t+7).
__device__ __forceinline__ void mma_step(float (&d)[4], const uint4& lo,
                                         const uint4& hi, const uint4& q) {
  mma16816(d, lo.x, hi.x, lo.y, hi.y, q.x, q.y);
  mma16816(d, lo.z, hi.z, lo.w, hi.w, q.z, q.w);
}

// After a block wrote its partials: the last block to finish sums the
// partials [gridDim.x, BKp] of all F-blocks in block order into out [B, K]
// and resets the ticket.
__device__ __forceinline__ void finish(const float* partial,
                                       unsigned int* ticket, float* out,
                                       int BK) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y * gridDim.z;
    last = atomicAdd(ticket, 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int BKp = (BK + 3) & ~3;
  const int cols = BKp / 4, n_blocks = gridDim.x;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float4* p = reinterpret_cast<const float4*>(partial) + c;
    float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
    int x = 0;
    for (; x + kReduceUnroll <= n_blocks; x += kReduceUnroll) {
      float4 v[kReduceUnroll];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u)
        v[u] = __ldcg(p + (long long)(x + u) * cols);
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        acc4.x += v[u].x;
        acc4.y += v[u].y;
        acc4.z += v[u].z;
        acc4.w += v[u].w;
      }
    }
    for (; x < n_blocks; ++x) {
      const float4 v = __ldcg(p + (long long)x * cols);
      acc4.x += v.x;
      acc4.y += v.y;
      acc4.z += v.z;
      acc4.w += v.w;
    }
    const float r[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * c + e < BK) out[4 * c + e] = r[e];
  }
  if (threadIdx.x == 0) *ticket = 0u;      // ready for the next launch
}

// grid: x = F-blocks, y = groups of kRowsM pool rows, z = groups of 8 * NB
// query rows. steps_per_warp: 32-feature steps a warp, a multiple of U.
// partial: [gridDim.x, BKp] floats, BKp = B * K rounded up to 4.
template <int NB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pool_sims_kernel(const __nv_bfloat16* __restrict__ queries,   // [B, F]
                 const __nv_bfloat16* __restrict__ pool,      // [K, F]
                 float* __restrict__ partial, unsigned int* ticket,
                 float* __restrict__ out,                     // [B, K]
                 int B, int K, long long F, long long steps_per_warp) {
  constexpr int U = unroll<NB>();
  constexpr int kRowsA = 2 * kTilesM;      // A rows a lane loads a step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * kRowsM, b0 = blockIdx.z * 8 * NB;
  const long long n_steps = (F + 31) >> 5, full_steps = F >> 5;
  const long long s_begin =
      ((long long)blockIdx.x * kWarps + warp) * steps_per_warp;
  const long long s_end = min(s_begin + steps_per_warp, n_steps);

  // row pointers at the lane's first 16 bytes of step s_begin; a step is
  // 4 uint4 of a row
  const uint4* prow[kRowsA];
  bool pok[kRowsA];
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
    const int k = k0 + 16 * (r >> 1) + g + 8 * (r & 1);
    pok[r] = k < K;
    const long long row = pok[r] ? k : 0;
    prow[r] = reinterpret_cast<const uint4*>(pool + row * F) + t +
              4 * s_begin;
  }
  const uint4* qrow[NB];
  bool qok[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int b = b0 + 8 * j + g;
    qok[j] = b < B;
    const long long row = qok[j] ? b : 0;
    qrow[j] = reinterpret_cast<const uint4*>(queries + row * F) + t +
              4 * s_begin;
  }
  float acc[kTilesM][NB][4];
#pragma unroll
  for (int i = 0; i < kTilesM; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  long long s = s_begin;
  const long long main_end = min(s_end, full_steps);
  for (; s + U <= main_end; s += U) {
    uint4 pa[U][kRowsA], qb[U][NB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        pa[u][r] = pok[r] ? ld_pool(prow[r] + 4 * u) : zero;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        qb[u][j] = qok[j] ? __ldg(qrow[j] + 4 * u) : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < kTilesM; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_step(acc[i][j], pa[u][2 * i], pa[u][2 * i + 1], qb[u][j]);
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) prow[r] += 4 * U;
#pragma unroll
    for (int j = 0; j < NB; ++j) qrow[j] += 4 * U;
  }
  // the rest of the range one step at a time; in the last step of a ragged
  // F a lane whose 8 elements lie past F reads nothing
  for (; s < s_end; ++s) {
    const bool in = s < full_steps || s * 32 + 8 * t < F;
    uint4 pa[kRowsA], qb[NB];
#pragma unroll
    for (int r = 0; r < kRowsA; ++r)
      pa[r] = in && pok[r] ? ld_pool(prow[r]) : zero;
#pragma unroll
    for (int j = 0; j < NB; ++j) qb[j] = in && qok[j] ? __ldg(qrow[j]) : zero;
#pragma unroll
    for (int i = 0; i < kTilesM; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mma_step(acc[i][j], pa[2 * i], pa[2 * i + 1], qb[j]);
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) prow[r] += 4;
#pragma unroll
    for (int j = 0; j < NB; ++j) qrow[j] += 4;
  }

  // the warps' tiles, summed in warp order: D rows are pool rows, columns
  // query rows; lane (g, t) holds D[g][2t..2t+1] and D[g+8][2t..2t+1]
  __shared__ float red[kWarps][kRowsM][8 * NB];
#pragma unroll
  for (int i = 0; i < kTilesM; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int m = 16 * i + g, n = 8 * j + 2 * t;
      red[warp][m][n] = acc[i][j][0];
      red[warp][m][n + 1] = acc[i][j][1];
      red[warp][m + 8][n] = acc[i][j][2];
      red[warp][m + 8][n + 1] = acc[i][j][3];
    }
  __syncthreads();
  const int BK = B * K, BKp = (BK + 3) & ~3;
  float* mine = partial + (long long)blockIdx.x * BKp;
  for (int idx = threadIdx.x; idx < kRowsM * 8 * NB; idx += kThreads) {
    const int m = idx / (8 * NB), n = idx % (8 * NB);
    const int k = k0 + m, b = b0 + n;
    if (k < K && b < B) {
      float v = red[0][m][n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][m][n];
      mine[b * K + k] = v;
    }
  }

  finish(partial, ticket, out, BK);
}

// The f32 route. kWarpRows: pool rows a warp (the block's 48 over its 12
// warps); a step is 256 features, 8 a lane: features 4l..4l+3 of each
// 128-feature half, so every load of the warp reads one contiguous run
// (256 or 512 bytes).
constexpr int kWarpRows = kRowsM / kWarps;
constexpr int kStepF32 = 256, kHalfF32 = kStepF32 / 2;
template <int QB>
__host__ __device__ constexpr int unroll_f32() { return QB <= 4 ? 2 : 1; }

// A pool load of 8 bytes: read once, not through L1, the L2 hint as ld_pool
__device__ __forceinline__ uint2 ld_pool2(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// A lane's 8 features of a pool row, 4 in each half, kept as loaded (bf16
// is widened at use).
template <typename P>
struct Pool8;
template <>
struct Pool8<__nv_bfloat16> {
  uint2 v[2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, bool in0,
                                       bool in1) {
    const uint2 zero = make_uint2(0u, 0u);
    v[0] = in0 ? ld_pool2(reinterpret_cast<const uint2*>(p)) : zero;
    v[1] = in1 ? ld_pool2(reinterpret_cast<const uint2*>(p + kHalfF32))
               : zero;
  }
  // feature e (0..7) as f32 (bf16 -> f32 is exact)
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = (&v[e >> 2].x)[(e & 3) >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <>
struct Pool8<float> {
  uint4 v[2];
  __device__ __forceinline__ void load(const float* p, bool in0, bool in1) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    v[0] = in0 ? ld_pool(reinterpret_cast<const uint4*>(p)) : zero;
    v[1] = in1 ? ld_pool(reinterpret_cast<const uint4*>(p + kHalfF32))
               : zero;
  }
  __device__ __forceinline__ float at(int e) const {
    return __uint_as_float((&v[e >> 2].x)[e & 3]);
  }
};

// grid: x = F-blocks, y = groups of kRowsM pool rows, z = groups of QB
// query rows. steps_per_block: 256-feature steps a block, a multiple of U;
// every warp of the block walks them all, for its own pool rows.
// partial: [gridDim.x, BKp] floats, as pool_sims_kernel's.
template <int QB, typename P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pool_sims_f32_kernel(const float* __restrict__ queries,       // [B, F]
                     const P* __restrict__ pool,              // [K, F]
                     float* __restrict__ partial, unsigned int* ticket,
                     float* __restrict__ out,                 // [B, K]
                     int B, int K, long long F,
                     long long steps_per_block) {
  constexpr int U = unroll_f32<QB>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.y * kRowsM + warp, b0 = blockIdx.z * QB;
  const long long n_steps = (F + kStepF32 - 1) / kStepF32;
  const long long s_begin = (long long)blockIdx.x * steps_per_block;
  const long long s_end = min(s_begin + steps_per_block, n_steps);
  const long long f0 = s_begin * kStepF32 + 4 * lane;

  const P* prow[kWarpRows];
  bool pok[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int k = k0 + kWarps * r;
    pok[r] = k < K;
    prow[r] = pool + (pok[r] ? k : 0) * F + f0;
  }
  const float* qrow[QB];
  bool qok[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const int b = b0 + j;
    qok[j] = b < B;
    qrow[j] = queries + (qok[j] ? b : 0) * F + f0;
  }
  float acc[QB][kWarpRows];
#pragma unroll
  for (int j = 0; j < QB; ++j)
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) acc[j][r] = 0.f;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long s = s_begin; s < s_end; s += U) {
    Pool8<P> pv[U][kWarpRows];
    float4 qv[U][QB][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // F is a multiple of 8: a lane's 4 features of a half lie all in or
      // all out
      const long long off = (s - s_begin + u) * kStepF32;
      const bool live = s + u < s_end;
      const bool in0 = live && f0 + off < F;
      const bool in1 = live && f0 + off + kHalfF32 < F;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
        pv[u][r].load(prow[r] + off, in0 && pok[r], in1 && pok[r]);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float* q = qrow[j] + off;
        qv[u][j][0] = in0 && qok[j]
                          ? __ldg(reinterpret_cast<const float4*>(q))
                          : zero4;
        qv[u][j][1] = in1 && qok[j]
                          ? __ldg(reinterpret_cast<const float4*>(
                                q + kHalfF32))
                          : zero4;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = pv[u][r].at(e);
#pragma unroll
          for (int j = 0; j < QB; ++j)
            acc[j][r] = fmaf((&qv[u][j][e >> 2].x)[e & 3], x, acc[j][r]);
        }
  }

  // each warp's rows of the block's partial, summed over its lanes
  const int BK = B * K, BKp = (BK + 3) & ~3;
  float* mine = partial + (long long)blockIdx.x * BKp;
#pragma unroll
  for (int j = 0; j < QB; ++j)
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const float v = warp_sum(acc[j][r]);
      const int k = k0 + kWarps * r, b = b0 + j;
      if (lane == 0 && k < K && b < B) mine[b * K + k] = v;
    }
  finish(partial, ticket, out, BK);
}

template <int QB, typename P>
cudaError_t launch_f32(const float* q, const P* p, void* workspace,
                       float* out, int B, int K, long long F, int max_blocks,
                       cudaStream_t stream) {
  constexpr int U = unroll_f32<QB>();
  const int groups_k = (K + kRowsM - 1) / kRowsM;
  const int groups_b = (B + QB - 1) / QB;
  const long long n_steps = (F + kStepF32 - 1) / kStepF32;
  long long cap = max_blocks / (groups_k * groups_b);
  if (cap < 1) cap = 1;
  const long long iters = (n_steps + U - 1) / U;
  const long long steps_per_block = U * ((iters + cap - 1) / cap);
  const long long n_blocks = (n_steps + steps_per_block - 1) / steps_per_block;
  unsigned int* ticket = static_cast<unsigned int*>(workspace);
  float* partial =
      reinterpret_cast<float*>(static_cast<char*>(workspace) + 16);
  pool_sims_f32_kernel<QB, P><<<dim3((unsigned)n_blocks, groups_k, groups_b),
                                kThreads, 0, stream>>>(
      q, p, partial, ticket, out, B, K, F, steps_per_block);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* p,
                   void* workspace, float* out, int B, int K, long long F,
                   int max_blocks, cudaStream_t stream) {
  constexpr int U = unroll<NB>();
  const int groups_k = (K + kRowsM - 1) / kRowsM;
  const int groups_b = (B + 8 * NB - 1) / (8 * NB);
  const long long n_steps = (F + 31) / 32;
  long long cap = max_blocks / (groups_k * groups_b);
  if (cap < 1) cap = 1;
  // iterations a warp: enough that cap blocks cover F (at least one)
  const long long iters = (n_steps + U - 1) / U;
  const long long steps_per_warp =
      U * ((iters + cap * kWarps - 1) / (cap * kWarps));
  const long long n_blocks =
      (n_steps + steps_per_warp * kWarps - 1) / (steps_per_warp * kWarps);
  unsigned int* ticket = static_cast<unsigned int*>(workspace);
  float* partial =
      reinterpret_cast<float*>(static_cast<char*>(workspace) + 16);
  pool_sims_kernel<NB><<<dim3((unsigned)n_blocks, groups_k, groups_b),
                         kThreads, 0, stream>>>(
      q, p, partial, ticket, out, B, K, F, steps_per_warp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident blocks an SM: the wrapper sizes the workspace from it.
int arco_pool_sims_blocks_per_sm() { return kBlocksPerSM; }

// workspace: 16 bytes of ticket (zero before the first launch; the kernel
// leaves it zero) + max_blocks * round_up(B * K, 4) floats, 16-byte aligned.
// max_blocks: the F-blocks a launch may use, at most kBlocksPerSM * SMs.
int arco_pool_sims(const void* queries, const void* pool, void* workspace,
                   void* out, int B, int K, long long F, int max_blocks,
                   void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(queries);
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(pool);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      B <= 8 ? launch<1>(q, p, workspace, o, B, K, F, max_blocks, s)
             : launch<2>(q, p, workspace, o, B, K, F, max_blocks, s);
  return (int)err;
}

// The f32 route: f32 queries against a bf16 (pool_f32 == 0) or f32 pool;
// the same workspace, max_blocks and F (a multiple of 8) as above.
int arco_pool_sims_f32(const void* queries, const void* pool, int pool_f32,
                       void* workspace, void* out, int B, int K, long long F,
                       int max_blocks, void* stream) {
  const float* q = static_cast<const float*>(queries);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (pool_f32) {
    const float* p = static_cast<const float*>(pool);
    err = B <= 4 ? launch_f32<4>(q, p, workspace, o, B, K, F, max_blocks, s)
                 : launch_f32<8>(q, p, workspace, o, B, K, F, max_blocks, s);
  } else {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(pool);
    err = B <= 4 ? launch_f32<4>(q, p, workspace, o, B, K, F, max_blocks, s)
                 : launch_f32<8>(q, p, workspace, o, B, K, F, max_blocks, s);
  }
  return (int)err;
}

}  // extern "C"
