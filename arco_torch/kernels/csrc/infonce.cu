// Sampled memory-bank InfoNCE, forward (denominator) and backward (weighted
// key sum), for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// arco_torch/kernels/infonce.py.
//
// Replaces the TPU kernels in arco_tpu/ops/pallas/infonce.py:
//   infonce_fwd_kernel <- _stream_denom / _infonce_tile_kernel
//   infonce_bwd_kernel <- _stream_grad  / _infonce_grad_kernel
//
//   fwd: e[k,q,n] = exp(<a[k,q], bank[k, idx[k,q,n]]> / T - 1 / T)   (f32)
//        denom[k,q] = sum_n e[k,q,n]
//   bwd: ga[k,q,:] = invtot[k,q] * sum_n e[k,q,n] * bank[k, idx[k,q,n], :]
//
// The TPU kernels stream the WHOLE bank against all anchors and weight each
// similarity by a dense multiplicity matrix counts[cap, Q], which exists
// only for Mosaic's tiling rules. Here the kernels read the sampled indices
// and touch only the sampled rows: the same cross entropy over the sampled
// multiset (a row drawn twice adds twice, as counts = 2 does). Cosine
// similarities lie in [-1, 1], so exp(s/T - 1/T) <= 1 needs no running max
// (the TPU kernel's shift). The forward writes e, so the backward needs no
// anchors and makes one pass: it reads e, the indices and each staged row
// once.
//
// What bounds them: bytes. A row is C = 496 bf16 (992 B) and costs 2*C
// flops, ~1 flop per byte against the ~295 of the tensor-core ridge, so the
// design moves fewer rows and does its dot products in f32 FMAs: tensor
// cores are not used. The main path's sampler gives the locality:
// neg_idx[k,q,n] = rank[k, n*Q + q] with stratified ranks non-decreasing in
// the draw index (losses/contrastive.py), so at a fixed n neighbouring
// queries draw from neighbouring strata of the bank and often the same row.
//
// Grid: (ceil(Q/G) query groups, S chunks of the samples, K classes), 256
// threads, with G = 16 queries and S = 4 chunks. A block loads its
// [G, N/S] indices and plans its stages: a (query, n) pair whose row equals
// query q - 1's at the same n reads that query's copy, so only run heads
// are staged, R = 40 rows to a stage, and a stage covers as many pairs as
// its R rows serve. cp.async copies a stage's rows (16-byte chunks) into
// one slot of a 2-slot ring while the other slot's stage is computed. At
// the main path's shapes (banks of 50000/30000 rows, K=4, Q=256, N=512)
// the staging copies 163,953 of the 524,288 sampled rows at 'smc' draws
// (the main path's; 140,000 distinct), 290,198 at 'asmc', and all of them
// at uniform draws. The tiling is the fastest fwd + bwd at 'smc' of those
// timed on the H100 (PERF.md).
//   fwd: a group of 16 lanes computes one (query, n) dot product, each lane
//        4 chunks of 8 channels against its part of the query's anchor,
//        held in registers; two samples per pass share one butterfly sum.
//        e goes out coalesced over n, and each block writes the partial
//        denominators of its chunk of samples.
//   bwd: each thread owns fixed (query, 16-byte chunk) pairs of the group's
//        [G, C] output and accumulates e * invtot * row in registers; each
//        block writes a [G, C] partial for its chunk of samples.
// A second grid sums the S partials in a fixed order: the results are
// bit-identical from run to run, and no float atomics are used.
// On the H100 the f32 FMA work, not the bytes, holds both kernels above the
// bound (PERF.md): each pair still reads its row's 992 bytes from shared
// memory and widens 496 bf16 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using arco::unpack8;
using arco::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks per SM that the register budget must allow: at the main path's
// N = 512 a block takes ~106 KB of shared memory, so two fit an SM.
constexpr int kMinBlocks = 2;
constexpr int kG = 16;                       // queries per block
constexpr int kS = 4;                        // chunks of the samples
constexpr int kR = 40;                       // staged rows per stage
constexpr int kLanes = kThreads / kG;        // fwd: lanes per dot product
constexpr int kMaxJ = 4;                     // fwd: 16-byte chunks per lane
constexpr int kMaxOwn = 4;                   // bwd: output chunks per thread
constexpr size_t kSmemMax = 232448;          // Hopper's 227 KB per block
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Dynamic shared memory of one block, in bytes from its start (the ring of
// staged rows first, 16-byte aligned). The P = G * chunk (query, sample)
// pairs of a tile are ordered o = nl * G + g, sample-major.
struct Layout {
  int c8, chunk, P;
  size_t ring, pk, idx, ostart, scan, heads, bytes;
  __host__ __device__ Layout(int N, int C) {
    c8 = C / 8;
    chunk = (N + kS - 1) / kS;
    P = kG * chunk;
    size_t off = 0;
    ring = off;
    off += (size_t)2 * kR * c8 * sizeof(uint4);
    pk = off;                             // int2 [P]
    off += (size_t)P * 8;
    idx = off;                            // int32 [P]
    off += (size_t)P * 4;
    ostart = off;                         // int32 [stages + 1]
    off += (size_t)((P + kR - 1) / kR + 1) * 4;
    scan = off;                           // int32 [kWarps]
    off += kWarps * 4;
    heads = off;                          // int16 [P]
    off += (size_t)P * 2;
    bytes = off;
  }
};

// One block's tile: queries q0 .. q0 + gq - 1 and samples n0 .. n0 + nn - 1
// of class k; `heads` rows to stage in `stages` stages.
struct Tile {
  int k, s, q0, gq, n0, nn, heads, stages;
};

// Shared-memory views of one block.
struct Smem {
  uint4* ring;
  // pair o: .x = the run head h whose staged row it reads, .y = the bits
  // of its value (fwd: e; bwd: e * invtot), one 8-byte load for both
  int2* pk;
  int32_t* idx;     // neg_idx of pair o, -1 outside the tile
  int32_t* ostart;  // stage st covers the pairs [ostart[st], ostart[st+1])
  int32_t* scan;
  int16_t* heads;   // pair o of run head h
  __device__ Smem(unsigned char* base, const Layout& L) {
    ring = reinterpret_cast<uint4*>(base + L.ring);
    pk = reinterpret_cast<int2*>(base + L.pk);
    idx = reinterpret_cast<int32_t*>(base + L.idx);
    ostart = reinterpret_cast<int32_t*>(base + L.ostart);
    scan = reinterpret_cast<int32_t*>(base + L.scan);
    heads = reinterpret_cast<int16_t*>(base + L.heads);
  }
};

__device__ __forceinline__ Tile tile_of(int Q, int N, const Layout& L) {
  Tile t;
  t.k = blockIdx.z;
  t.s = blockIdx.y;
  t.q0 = blockIdx.x * kG;
  t.gq = min(kG, Q - t.q0);
  t.n0 = t.s * L.chunk;
  t.nn = max(0, min(L.chunk, N - t.n0));
  t.heads = t.stages = 0;
  return t;
}

// Load the tile's indices and plan its stages. A valid pair is a run head
// when g == 0 or its index differs from query g - 1's at the same n; only
// run heads are staged. Head h gets slot h % R of stage h / R, and every
// pair reads its run head's row, so a stage covers a contiguous range of
// pairs: at the sampler's stratified draws a stage of R rows serves several
// times R pairs.
__device__ void plan_tile(const int32_t* neg_idx, int Q, int N,
                          const Layout& L, const Smem& sm, Tile& t) {
  constexpr int G = kG;
  const int P = L.P, chunk = L.chunk;
  const int32_t* base = neg_idx + ((long long)t.k * Q + t.q0) * N + t.n0;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int g = i / chunk, nl = i - g * chunk;    // coalesced over n
    sm.idx[nl * G + g] =
        (g < t.gq && nl < t.nn) ? base[(long long)g * N + nl] : -1;
  }
  __syncthreads();
  auto is_head = [&](int o) {
    const int v = sm.idx[o];
    return v >= 0 && (o % G == 0 || sm.idx[o - 1] != v);
  };
  // each thread numbers the heads of a contiguous run of pairs, after an
  // exclusive scan of the runs' head counts
  const int per = (P + kThreads - 1) / kThreads;
  const int lo = min(P, (int)threadIdx.x * per), hi = min(P, lo + per);
  int cnt = 0;
  for (int o = lo; o < hi; ++o) cnt += is_head(o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sm.scan[warp] = x;
  __syncthreads();
  int h = x - cnt, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) h += sm.scan[w];
    total += sm.scan[w];
  }
  for (int o = lo; o < hi; ++o) {
    if (is_head(o)) {
      sm.heads[h] = (int16_t)o;
      if (h % kR == 0) sm.ostart[h / kR] = o;
      ++h;
    }
    sm.pk[o].x = h - 1;
  }
  t.heads = total;
  t.stages = (total + kR - 1) / kR;
  if (threadIdx.x == 0) sm.ostart[t.stages] = P;
  __syncthreads();
}

// Copy the rows of stage st's run heads into a ring slot, row r of the
// slot for head st * R + r. Warp w takes the rows r = w, w + 8, ...; its
// lanes copy the row's 16-byte chunks.
__device__ __forceinline__ void issue_stage(const __nv_bfloat16* kb, int c8,
                                            const Tile& t, const Smem& sm,
                                            uint4* slot, int st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kR; r += kWarps) {
    const int h = st * kR + r;
    if (h >= t.heads) break;
    const uint4* row = reinterpret_cast<const uint4*>(
        kb + (long long)sm.idx[sm.heads[h]] * (8 * c8));
    for (int j = lane; j < c8; j += 32) cp_async16(slot + r * c8 + j, row + j);
  }
}

// The staged walk over the tile through the 2-slot ring; compute(st, slot)
// runs once stage st has arrived. One barrier a stage: after it every
// thread is done with stage st - 1, whose slot the copies of stage st + 1
// then refill while stage st is computed.
template <typename Compute>
__device__ __forceinline__ void walk(const __nv_bfloat16* kb, int c8,
                                     const Tile& t, const Smem& sm,
                                     Compute&& compute) {
  const int slot_len = kR * c8;
  if (t.stages > 0) issue_stage(kb, c8, t, sm, sm.ring, 0);
  cp_async_commit();
  for (int st = 0; st < t.stages; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < t.stages)
      issue_stage(kb, c8, t, sm, sm.ring + ((st + 1) & 1) * slot_len, st + 1);
    cp_async_commit();
    compute(st, sm.ring + (st & 1) * slot_len);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
infonce_fwd_kernel(const __nv_bfloat16* __restrict__ anchors,  // [K,Q,C]
                   const __nv_bfloat16* __restrict__ bank,     // [K,cap,C]
                   const int32_t* __restrict__ neg_idx,        // [K,Q,N]
                   float* __restrict__ e,                      // [K,Q,N]
                   float* __restrict__ dpart,                  // [K,S,Q]
                   int Q, int N, int C, long long cap, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const Layout L(N, C);
  const Smem sm(smem, L);
  const int c8 = L.c8;
  Tile t = tile_of(Q, N, L);

  // Lane group g (kLanes lanes) serves query g, and lane l the chunks
  // j = l + kLanes * i, so the thread's part of the anchor lives in
  // registers.
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long qbase = (long long)t.k * Q + t.q0;
  float a[kMaxJ][8];
  {
    const uint4* arow =
        reinterpret_cast<const uint4*>(anchors + (qbase + g) * C);
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      const int j = lane + kLanes * i;
      if (g < t.gq && j < c8) {
        unpack8(__ldg(arow + j), a[i]);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) a[i][v] = 0.f;
      }
    }
  }
  plan_tile(neg_idx, Q, N, L, sm, t);

  const __nv_bfloat16* kb = bank + (long long)t.k * cap * C;
  // <row, anchor> partial sum of this lane's chunks of staged row h. The
  // loads are not behind a branch, so the two samples' loads overlap.
  auto dot = [&](const uint4* slot, int h) {
    const uint4* row = slot + h * c8;
    uint4 raw[kMaxJ];
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      const int j = lane + kLanes * i;
      raw[i] = j < c8 ? row[j] : make_uint4(0, 0, 0, 0);
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      float x[8];
      unpack8(raw[i], x);
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] = fmaf(x[v], a[i][v], acc[v]);
    }
    return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
           ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  };
  walk(kb, c8, t, sm, [&](int st, const uint4* slot) {
    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];
    const int na = oa / G, nb = (ob - 1) / G, h0 = st * kR;
    auto valid = [&](int nl, int o) {
      return g < t.gq && nl <= nb && nl < t.nn && o >= oa && o < ob;
    };
    // two samples at a time, nl and nl + 1; the loop bounds are the same
    // for the whole block. An invalid pair reads the stage's first row and
    // is not stored. One butterfly sums both samples: after its first step
    // lanes 0-7 hold sample A's sums and lanes 8-15 B's.
    for (int nl = na; nl <= nb; nl += 2) {
      const int oA = nl * G + g, oB = oA + G;
      const bool vA = valid(nl, oA), vB = valid(nl + 1, oB);
      const int hA = vA ? sm.pk[oA].x : h0, hB = vB ? sm.pk[oB].x : h0;
      const float sA = dot(slot, hA - h0), sB = dot(slot, hB - h0);
      const bool hi = lane & (kLanes / 2);
      float s = (hi ? sB : sA) +
                __shfl_xor_sync(0xffffffffu, hi ? sA : sB, kLanes / 2);
#pragma unroll
      for (int d = kLanes / 4; d > 0; d >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, d);
      if (lane == 0 && vA)
        sm.pk[oA].y = __float_as_int(expf(s * inv_temp - inv_temp));
      if (lane == kLanes / 2 && vB)
        sm.pk[oB].y = __float_as_int(expf(s * inv_temp - inv_temp));
    }
  });

  // e out, coalesced over n; the chunk's partial denominators, each summed
  // by one warp in a fixed order
  for (int i = threadIdx.x; i < L.P; i += kThreads) {
    const int gg = i / L.chunk, nl = i - gg * L.chunk;
    if (gg < t.gq && nl < t.nn)
      e[(qbase + gg) * N + t.n0 + nl] = __int_as_float(sm.pk[nl * G + gg].y);
  }
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int gg = warp; gg < t.gq; gg += kWarps) {
    float sum = 0.f;
    for (int nl = wl; nl < t.nn; nl += 32)
      sum += __int_as_float(sm.pk[nl * G + gg].y);
    sum = warp_sum(sum);
    if (wl == 0) dpart[((long long)t.k * kS + t.s) * Q + t.q0 + gg] = sum;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
infonce_bwd_kernel(const float* __restrict__ e,                // [K,Q,N]
                   const __nv_bfloat16* __restrict__ bank,     // [K,cap,C]
                   const int32_t* __restrict__ neg_idx,        // [K,Q,N]
                   const float* __restrict__ invtot,           // [K,Q]
                   float* __restrict__ gpart,                  // [K,S,Q,C]
                   int Q, int N, int C, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const Layout L(N, C);
  const Smem sm(smem, L);
  const int c8 = L.c8;
  Tile t = tile_of(Q, N, L);

  const long long qbase = (long long)t.k * Q + t.q0;
  for (int i = threadIdx.x; i < L.P; i += kThreads) {
    const int gg = i / L.chunk, nl = i - gg * L.chunk;
    sm.pk[nl * G + gg].y = __float_as_int(
        (gg < t.gq && nl < t.nn)
            ? e[(qbase + gg) * N + t.n0 + nl] * invtot[qbase + gg]
            : 0.f);
  }
  plan_tile(neg_idx, Q, N, L, sm, t);

  // thread i owns the output chunks p = i + m * kThreads of the [G, c8]
  // tile (G * c8 <= kMaxOwn * kThreads, checked by arco_infonce_smem)
  int own_g[kMaxOwn], own_j[kMaxOwn];
  float acc[kMaxOwn][8];
#pragma unroll
  for (int m = 0; m < kMaxOwn; ++m) {
    const int p = threadIdx.x + m * kThreads;
    own_g[m] = p / c8;
    own_j[m] = p - own_g[m] * c8;
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[m][v] = 0.f;
  }
  const __nv_bfloat16* kb = bank + (long long)t.k * cap * C;
  walk(kb, c8, t, sm, [&](int st, const uint4* slot) {
    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];
    const int na = oa / G, nb = min((ob - 1) / G, t.nn - 1);
    // the stage's samples nl in [lo[m], hi[m]] for query own_g[m]
    int lo[kMaxOwn], hi[kMaxOwn];
#pragma unroll
    for (int m = 0; m < kMaxOwn; ++m) {
      const int g = own_g[m];
      lo[m] = na + (na * G + g < oa);
      hi[m] = g < t.gq ? nb - (nb * G + g >= ob) : na - 1;
    }
    // A pair outside the stage weighs 0 and reads the stage's first row
    // (real data), so the loads are not behind a branch and overlap.
    const int h0 = st * kR;
#pragma unroll 2
    for (int nl = na; nl <= nb; ++nl) {
      int2 pw[kMaxOwn];
      uint4 raw[kMaxOwn];
#pragma unroll
      for (int m = 0; m < kMaxOwn; ++m)
        pw[m] = nl >= lo[m] && nl <= hi[m] ? sm.pk[nl * G + own_g[m]]
                                          : make_int2(h0, 0);
#pragma unroll
      for (int m = 0; m < kMaxOwn; ++m)
        raw[m] = slot[(pw[m].x - h0) * c8 + own_j[m]];
#pragma unroll
      for (int m = 0; m < kMaxOwn; ++m) {
        const float w = __int_as_float(pw[m].y);
        float x[8];
        unpack8(raw[m], x);
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[m][v] = fmaf(w, x[v], acc[m][v]);
      }
    }
  });

#pragma unroll
  for (int m = 0; m < kMaxOwn; ++m) {
    if (own_g[m] < t.gq) {
      float4* out = reinterpret_cast<float4*>(
          gpart + (((long long)t.k * kS + t.s) * Q + t.q0 + own_g[m]) * C +
          8 * own_j[m]);
      out[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      out[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
}

// out[k, r] = sum_s part[k, s, r] for r < inner, in the order of s.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int S, long long inner, long long total) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const long long k = o / inner, r = o - k * inner;
  const float* p = part + k * S * inner + r;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += p[i * inner];
  out[o] = s;
}

int sum_splits(const float* part, float* out, int S, long long inner,
               long long total, cudaStream_t stream) {
  sum_splits_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(part, out, S, inner, total);
  return (int)cudaGetLastError();
}

// Let a kernel take up to kSmemMax bytes of dynamic shared memory on the
// current device, once per kernel and device.
cudaError_t allow_smem(const void* kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemMax);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

bool fwd_smem_set[kMaxDevices], bwd_smem_set[kMaxDevices];

}  // namespace

extern "C" {

// Queries per block and chunks of the samples: the partials hold
// K * splits * Q floats (fwd) and K * splits * Q * C floats (bwd).
int arco_infonce_group() { return kG; }
int arco_infonce_splits() { return kS; }

// Dynamic shared memory of one block of either kernel, or 0 for a shape
// they do not take: C a multiple of 8 with C / 8 <= kLanes * kMaxJ and
// kG * C / 8 <= kMaxOwn * kThreads, at most 32767 pairs per tile, and at
// most kSmemMax bytes.
size_t arco_infonce_smem(int N, int C) {
  if (N < 1 || C < 8 || C % 8 || C / 8 > kLanes * kMaxJ ||
      kG * (C / 8) > kMaxOwn * kThreads)
    return 0;
  const Layout L(N, C);
  return L.P > 32767 || L.bytes > kSmemMax ? 0 : L.bytes;
}

int arco_infonce_fwd(const void* anchors, const void* bank,
                     const void* neg_idx, void* e, void* dpart, void* denom,
                     int K, int Q, int N, int C, long long cap,
                     float inv_temp, void* stream) {
  const size_t smem = arco_infonce_smem(N, C);
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)infonce_fwd_kernel, fwd_smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kG - 1) / kG, kS, K);
  infonce_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)anchors, (const __nv_bfloat16*)bank,
      (const int32_t*)neg_idx, (float*)e, (float*)dpart, Q, N, C, cap,
      inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits((const float*)dpart, (float*)denom, kS, Q,
                    (long long)K * Q, (cudaStream_t)stream);
}

int arco_infonce_bwd(const void* e, const void* bank, const void* neg_idx,
                     const void* invtot, void* gpart, void* ga, int K, int Q,
                     int N, int C, long long cap, void* stream) {
  const size_t smem = arco_infonce_smem(N, C);
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)infonce_bwd_kernel, bwd_smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kG - 1) / kG, kS, K);
  infonce_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)e, (const __nv_bfloat16*)bank, (const int32_t*)neg_idx,
      (const float*)invtot, (float*)gpart, Q, N, C, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits((const float*)gpart, (float*)ga, kS, (long long)Q * C,
                    (long long)K * Q * C, (cudaStream_t)stream);
}

}  // extern "C"
