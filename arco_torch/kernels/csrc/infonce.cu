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
// What bounds them: the bytes of the sampled rows (C bf16 each), read from
// device memory once a block. The main path's sampler gives the locality:
// neg_idx[k,q,n] = rank[k, n*Q + q] with stratified ranks non-decreasing in
// the draw index (losses/contrastive.py), so at a fixed n neighbouring
// queries draw from neighbouring strata of the bank and often the same row.
//
// The tile. Grid: (ceil(Q/G) query groups, S chunks of the samples, K
// classes), 256 threads, G = 16 queries. A block loads its [G, N/S]
// indices and plans its stages: a (query, n) pair whose row equals query
// q - 1's at the same n reads that query's copy, so only run heads are
// staged, R rows to a stage, and a stage covers as many pairs as its R rows
// serve. cp.async copies a stage's rows (16-byte chunks) into one slot of a
// 2-slot ring while the other slot's stage is computed. At the 2D shapes
// (banks of 50000/30000 rows, K=4, Q=256, N=512) the staging copies 164,037
// of the 524,288 sampled rows at 'smc' draws (the main path's; 140,000
// distinct), 290,198 at 'asmc', and all of them at uniform draws.
//
// The work on a staged stage runs on the tensor cores
// (mma.sync.m16n8k16 bf16 x bf16 -> f32, operands through ldmatrix): no
// pair re-reads its row's C values out of shared memory and widens them to
// f32, and one instruction covers 16 rows x 8 queries x 16 channels.
//   fwd: the group's anchors are the B operand (two n8 tiles, staged once)
//        and the stage's rows the A operand (m16 tiles): S[R, 16] = rows .
//        anchors^T over k-steps of 16 channels. When a stage has fewer than
//        8 m16 tiles the warps split the k-steps and S is the fixed-order
//        sum of their partial tiles. Each pair then reads S[head][query].
//        bf16 x bf16 products are exact in f32: only the order of the sum
//        changes. e goes out coalesced over n, and each block writes the
//        partial denominators of its chunk of samples.
//   bwd: ga[16, C] += W[16, R] . rows[R, C], M = the 16 queries, K = the
//        stage's rows (B operand through ldmatrix.trans), N = C in n8 tiles
//        split over the warps (at C <= 112 the warps also split the
//        k-steps, summed in a fixed order at the end). W[g][r] = e * invtot
//        of the pair of query g that reads staged row r, else 0: a run head
//        serves one n and distinct queries, so no entry has two pairs. The
//        block writes a stage's W into shared memory from the plan, one
//        entry a thread, and the warps read their A fragments with
//        ldmatrix. W is f32 and the tensor cores take bf16, so W = hi + lo,
//        two bf16 products (W - hi - lo <= 2^-16 |W|, below the f32 sums'
//        rounding at these sizes). The accumulators stay in registers over
//        the whole tile, and each block writes a [G, C] partial for its
//        chunk of samples.
// The ring's row stride is an odd number of 16-byte chunks, so the eight
// rows of an ldmatrix fall in eight distinct bank groups; the chunk past C
// (C a multiple of 8, not of 16) and the rows past a stage's last, up to
// its m16 tile, are zeros.
// With the products on the tensor cores a block mostly waits on its
// stages' copies (one stage in flight while the other is computed; on the
// H100 that wait, not the products, holds both kernels above the bound,
// PERF.md), so the stage size follows the shared memory: the most blocks
// an SM that fit (3, or 2 for the backward at C > 256, whose accumulators
// need more registers), then as many rows a stage as fit. At C = 496: 2
// blocks of 32 rows; at C = 256: 3 blocks of 32 rows; at C = 16: 3 blocks
// of 384 rows, about a whole tile. At small K * Q the samples go to more
// chunks (S = 4, 8 or 16), so the grid has a block for each SM.
// A second grid sums the S partials in a fixed order: the results are
// bit-identical from run to run, and no float atomics are used.
//
// The f32 route (infonce_fwd_f32_kernel / infonce_bwd_f32_kernel: f32
// anchors and bank, the stage-2 step at --compute_dtype float32) keeps the
// tile and the plan, with rows of C / 4 16-byte chunks, and does each
// stage's work in f32 FMAs on the staged rows, one product per (query,
// sample) pair, in the order of the channels: no rounding of the operands
// (single-pass TF32 would leave ~5e-4 on s, ~1e-3 on e), and 2 K Q N C
// flops, ~8 us at the 2D shapes at f32's rate, below the ~0.09 ms that the
// rows' bytes take, so the copies set the pace. An f32 row is twice a
// bf16 one, so a stage holds half the rows and a block walks twice the
// stages; the route has a pipeline of its own (walk_f32) in which no
// stage waits on all copies or on a block barrier: a ring of D slots with
// a full and an empty mbarrier each (D: see Layout). Rows of 1 KB and more
// arrive by TMA bulk copies (cp.async.bulk, C * 4 bytes a row) that one
// warp issues; shorter rows by 16-byte cp.async that signal the full
// barrier as they land (at C = 16 a TMA copy of a 64-byte row costs more
// than its bytes). Stages st + 1 ... st + D - 1 are in flight while stage
// st is computed, and each warp waits only on its stage's full barrier.
// A call is one grid: the last block of each (class, query group) to
// finish, known by an integer ticket, sums the S partials in split order,
// as the bf16 route's second grid does (bit-identical from run to run, no
// float atomics); at C = 16 a second grid and the gap before it cost ~3
// us of a ~15 us call (PERF.md).
//   fwd: `lanes` lanes (16; at C < 128 half the row's chunks, at least 2)
//        compute one pair's dot product against their part of the query's
//        anchor, held in registers; two samples a pass share one butterfly
//        sum. Groups beyond the 16 queries take every other sample (C <
//        128).
//   bwd: each thread owns fixed (query, 16-byte chunk) entries of the
//        [G, C] output and accumulates e * invtot * row in registers;
//        threads beyond G * C / 4 take every other sample, and the block
//        sums their partials in a fixed order. The weights (e * invtot)
//        load while the first stages' copies are in flight.
// A pair reads its run head's row, so no pair reads a row past the
// stage's last and the tail needs no zeros; a pair outside the stage or
// the tile weighs 0 and reads the stage's first row (real data), so its
// loads need no branch or predicate (predicated loads ran ~3% slower on
// the H100 at C = 496). Each row is read
// by runs of consecutive lanes over consecutive chunks, which no bank
// conflict slows, so the ring's stride is C / 4 chunks with no pad. The
// registers allow 2 blocks an SM. Each kernel is a template on the chunks
// a thread holds (1, 2, 4 or 8), so at small C no thread loads and
// multiplies the zeros of chunks past the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using arco::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 16;                       // queries per block
constexpr int kMinSplits = 4, kMaxSplits = 16;
constexpr int kMinChunk = 32;                // samples a chunk, at least
constexpr int kSms = 132;                    // H100 SXM
constexpr int kMaxRows = 512;                // staged rows per stage
constexpr int kMaxC = 512;
constexpr int kRedFloats = kWarps * 32 * 8;  // bwd: k-split partials
constexpr size_t kSmemMax = 232448;          // Hopper's 227 KB per block
constexpr size_t kSmemSM = 233472;           // per SM, 1 KB a block reserved
constexpr size_t kSmemReserved = 1024;
constexpr int kMaxDevices = 64;
constexpr int kBlocksF32 = 2;                // f32 route: blocks an SM
constexpr int kMaxSlotsF32 = 8;              // f32 route: ring slots, at most
constexpr int kMinStageF32 = 16;             // f32 route: rows a stage, if 3+
constexpr int kMinRingF32 = 32;              // f32 route: ring rows, at least
constexpr int kTmaRowF32 = 1024;             // f32 route: TMA rows, bytes
constexpr int kLanesF32 = 16;                // f32 fwd: lanes a pair, at most

// The most blocks an SM that the kernels' registers allow (<= 85 a thread
// for 3): the forward (47) and the backward up to 2 n8-tile pairs a warp
// (C <= 256, 55-61) take 3, the backward with 3 or 4 pairs (88) 2. The
// forward's launch bounds ask for 2 only: the code ptxas schedules under a
// bound of 3 ran ~10% slower on the H100 at C = 256 (PERF.md).
constexpr int kMaxBlocks = 3;
__host__ __device__ constexpr int max_blocks(bool fwd, int pairs) {
  return fwd || pairs <= 2 ? kMaxBlocks : 2;
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive on `bar` once the thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of the phase's copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on `bar` when it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of
// each (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a . b, a 16x16 row-major, b 16x8 column-major, bf16, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dynamic shared memory of one block, in bytes from its start (the ring of
// staged rows first, 16-byte aligned), and the tile's sizes; computed on
// the host and passed to the kernels. The P = G * chunk (query, sample)
// pairs of a tile are ordered o = nl * G + g, sample-major. A ring row holds
// `stride` 16-byte chunks: the row's C / 8, a zero chunk when C / 8 is odd,
// and one more to make the count odd.
//
// Stage size: the copies of a stage are what a block waits on, so an SM
// wants many rows in flight and several blocks to overlap one block's
// planning and barriers with another's copies (on the H100, 3 blocks of 32
// rows beat 2 of 48 at C = 256). The layout takes the most blocks an SM
// (3, or 2 where the registers allow no more) at which a stage of 32 rows
// fits, else the most at which 16 fit, else one, and then as many rows as
// fit, up to 512.
//
// The f32 route: rows of cr = C / 4 chunks, stride cr; no spart, anchors
// or W (the FMAs read the ring and registers). Its ring has `slots` (D)
// slots of `rows` rows, and a full and an empty mbarrier a slot after the
// plan's arrays. The registers allow 2 blocks an SM; the plan's arrays
// take what the tile needs and the ring the rest, up to a D-th of the
// tile's pairs a slot (so a small tile still spreads over the slots) and
// kMaxRows. D is the most slots, up to 8, whose stages keep 16 rows, else
// 2: each stage costs the walk a fixed time, so on the H100 fewer, larger
// stages won at C = 496 (PERF.md). At C = 496 (2D) that is 2 slots of 22
// rows (87 KB a block: 43 KB in flight while 43 KB are computed, so 87 KB
// in flight an SM), at C = 16 (3D) 8 slots of 128 rows, more than a
// tile's run heads, all in flight at once. The ring is at least kThreads
// * 16 bytes for the bwd, which sums its sample slices there at the end.
struct Layout {
  int c8, cr, ks, stride, tlog, rows, mt, kp, npw, kpb, pairs, chunk, P;
  int blocks, wstride, lanes, slices, slots;
  bool f32, tma;
  size_t ring, spart, anchors, w, val, idx, head, heads, ostart, scan, bars;
  size_t bytes;

  Layout(int N, int C, int S, bool fwd, bool f32_ = false) {
    f32 = f32_;
    c8 = C / 8;
    cr = f32 ? C / 4 : c8;              // 16-byte chunks of a bank row
    ks = (c8 + 1) / 2;                  // k16 steps (fwd), n8-tile pairs (bwd)
    stride = f32 ? cr : 2 * ks + 1;
    tlog = 0;                           // issue: 2^tlog threads a row
    while ((1 << tlog) < imin(cr, 32)) ++tlog;
    npw = 1;                            // bwd: warps across the n8-tile pairs
    while (npw < imin(ks, kWarps)) npw *= 2;
    kpb = kWarps / npw;                 // bwd: warps across the k-steps
    pairs = (ks + npw - 1) / npw;       // bwd: n8-tile pairs a warp
    lanes = 2;                          // f32 fwd: lanes a pair
    while (lanes < imin(cr / 2, kLanesF32)) lanes *= 2;
    // f32: sample slices, fwd groups of `lanes` a query, bwd threads an
    // output chunk
    slices = fwd ? kThreads / lanes / kG : imax(1, kThreads / (kG * cr));
    chunk = (N + S - 1) / S;
    P = kG * chunk;
    slots = 2;
    bars = 0;
    tma = f32 && C * 4 >= kTmaRowF32;
    if (f32) {
      blocks = kBlocksF32;
      if (!fit_f32(fwd, kSmemSM / blocks - kSmemReserved)) {
        blocks = 1;
        fit_f32(fwd, kSmemMax);
      }
      return;
    }
    const int most = max_blocks(fwd, pairs);
    for (int least = 32; least >= 16; least -= 16)
      for (blocks = most; blocks >= 2; --blocks)
        if (fit(fwd, kSmemSM / blocks - kSmemReserved, least)) return;
    blocks = 1;
    fit(fwd, kSmemMax, 16);
  }

  // As many rows as fit `budget` bytes, if at least `least` do.
  bool fit(bool fwd, size_t budget, int least) {
    for (rows = kMaxRows; rows > least && place(fwd) > budget; rows -= 16) {
    }
    return place(fwd) <= budget;
  }

  // f32: the most slots, up to kMaxSlotsF32, whose stages keep at least
  // kMinStageF32 rows, else 2 (a stage costs the walk a fixed time, PERF.md),
  // each of as many rows as fit `budget`.
  bool fit_f32(bool fwd, size_t budget) {
    for (slots = kMaxSlotsF32; slots > 2; --slots)
      if (fit_rows_f32(fwd, budget) && rows >= kMinStageF32) return true;
    return fit_rows_f32(fwd, budget);
  }

  // f32: as many rows a slot as fit `budget`, at most kMaxRows and a D-th
  // of the tile's pairs, if the ring holds at least kMinRingF32 rows.
  bool fit_rows_f32(bool fwd, size_t budget) {
    const int least = (kMinRingF32 + slots - 1) / slots;
    rows = imax(least, imin(kMaxRows, (P + slots - 1) / slots));
    const size_t row = (size_t)slots * stride * 16;
    if (place(fwd) > budget && rows > least)
      rows = imax(least, rows - (int)((bytes - budget + row - 1) / row));
    while (place(fwd) > budget && rows > least) --rows;
    return bytes <= budget;
  }

  size_t place(bool fwd) {
    mt = rows / 16;                     // fwd: m16 tiles of a stage
    // fwd: warps across the k-steps (mt may be 0 on the f32 route)
    kp = mt >= kWarps ? 1 : kWarps / imax(1, mt);
    size_t off = 0;
    ring = off;
    size_t ring_bytes = (size_t)slots * rows * stride * 16;
    const size_t red_bytes = f32 ? (size_t)kThreads * 16
                                 : kRedFloats * sizeof(float);
    if (!fwd && ring_bytes < red_bytes) ring_bytes = red_bytes;
    off += ring_bytes;
    spart = anchors = w = off;
    wstride = rows + 8;                 // odd in 16-byte units, as the ring
    if (f32) {
      // the f32 route stages nothing else
    } else if (fwd) {
      off += (size_t)kp * rows * kG * sizeof(float);   // f32 [kp, R, G]
      anchors = off;                                    // [G, stride]
      off += (size_t)kG * stride * 16;
    } else {
      off += (size_t)2 * kG * wstride * 2;  // bf16 [2][G][wstride]: hi, lo
    }
    val = off;                          // f32 [P]: e (fwd), e * invtot (bwd)
    off += (size_t)P * 4;
    idx = off;                          // int32 [P], -1 outside the tile
    off += (size_t)P * 4;
    head = off;                         // int16 [P]: pair o -> its run head
    off += (size_t)P * 2;
    heads = off;                        // int16 [P]: run head h -> pair
    off += (size_t)P * 2;
    ostart = off;                       // int32 [stages + 1]
    off += (size_t)((P + rows - 1) / rows + 1) * 4;
    scan = off;                         // int32 [kWarps]
    off += kWarps * 4;
    if (f32) {                          // uint64 full[slots], empty[slots]
      bars = (off + 7) / 8 * 8;
      off = bars + (size_t)slots * 16;
    }
    return bytes = off;
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
  float* spart;     // fwd: stage similarities, [kp][R][G] partial tiles
  uint4* anchors;   // fwd: the group's anchors, [G][stride] chunks
  __nv_bfloat16* whi;   // bwd: a stage's weights W[G][R], hi and lo parts
  __nv_bfloat16* wlo;
  float* val;
  int32_t* idx;
  int16_t* head;
  int16_t* heads;
  int32_t* ostart;  // stage st covers the pairs [ostart[st], ostart[st+1])
  int32_t* scan;
  uint64_t* full;   // f32: slot s's rows have landed
  uint64_t* empty;  // f32: every warp is done with slot s
  __device__ Smem(unsigned char* base, const Layout& L) {
    ring = reinterpret_cast<uint4*>(base + L.ring);
    spart = reinterpret_cast<float*>(base + L.spart);
    anchors = reinterpret_cast<uint4*>(base + L.anchors);
    whi = reinterpret_cast<__nv_bfloat16*>(base + L.w);
    wlo = whi + kG * L.wstride;
    val = reinterpret_cast<float*>(base + L.val);
    idx = reinterpret_cast<int32_t*>(base + L.idx);
    head = reinterpret_cast<int16_t*>(base + L.head);
    heads = reinterpret_cast<int16_t*>(base + L.heads);
    ostart = reinterpret_cast<int32_t*>(base + L.ostart);
    scan = reinterpret_cast<int32_t*>(base + L.scan);
    full = reinterpret_cast<uint64_t*>(base + L.bars);
    empty = full + L.slots;
  }
};

__device__ __forceinline__ Tile tile_of(int Q, int N, const Layout& L) {
  Tile t;
  t.k = blockIdx.z;
  t.s = blockIdx.y;
  t.q0 = blockIdx.x * kG;
  t.gq = imin(kG, Q - t.q0);
  t.n0 = t.s * L.chunk;
  t.nn = imax(0, imin(L.chunk, N - t.n0));
  t.heads = t.stages = 0;
  return t;
}

// The chunk past C / 8 of every ring row, when C / 8 is odd: zeros, the
// last k-step's (fwd) or n8 tile's (bwd) padding. The copies never write it.
__device__ __forceinline__ void zero_pad(const Layout& L, const Smem& sm) {
  if (!L.f32 && (L.c8 & 1))
    for (int r = threadIdx.x; r < 2 * L.rows; r += kThreads)
      sm.ring[r * L.stride + L.c8] = make_uint4(0, 0, 0, 0);
}

// Load the tile's indices and plan its stages. A valid pair is a run head
// when g == 0 or its index differs from query g - 1's at the same n; only
// run heads are staged. Head h gets row h % R of stage h / R, and every
// pair reads its run head's row, so a stage covers a contiguous range of
// pairs: at the sampler's stratified draws a stage of R rows serves several
// times R pairs.
__device__ __forceinline__ void plan_tile(const int32_t* neg_idx, int Q, int N,
                          const Layout& L, const Smem& sm, Tile& t) {
  constexpr int G = kG;
  const int P = L.P, chunk = L.chunk, R = L.rows;
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
  const int lo = imin(P, (int)threadIdx.x * per), hi = imin(P, lo + per);
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
      if (h % R == 0) sm.ostart[h / R] = o;
      ++h;
    }
    sm.head[o] = (int16_t)(h - 1);
  }
  t.heads = total;
  t.stages = (total + R - 1) / R;
  if (threadIdx.x == 0) sm.ostart[t.stages] = P;
  __syncthreads();
}

// Copy the rows of stage st's run heads (cr chunks each from kb, the
// class's bank) into a ring slot, row r of the slot for head st * R + r,
// 2^tlog threads a row; then, on the bf16 route, zero the slot's rows past
// the stage's last, up to its last m16 tile (the bwd weighs them 0, and
// 0 * stale bits could be NaN).
__device__ __forceinline__ void issue_stage(const uint4* kb, const Layout& L,
                                            const Tile& t, const Smem& sm,
                                            uint4* slot, int st) {
  const int h0 = st * L.rows, nr = imin(L.rows, t.heads - h0);
  const int tpr = 1 << L.tlog;
  for (int r = threadIdx.x >> L.tlog; r < nr; r += kThreads >> L.tlog) {
    const uint4* row = kb + (long long)sm.idx[sm.heads[h0 + r]] * L.cr;
    uint4* dst = slot + r * L.stride;
    for (int j = threadIdx.x & (tpr - 1); j < L.cr; j += tpr)
      cp_async16(dst + j, row + j);
  }
  if (L.f32) return;
  const int nz = (((nr + 15) >> 4) << 4) - nr;
  for (int i = threadIdx.x; i < nz * L.stride; i += kThreads)
    slot[nr * L.stride + i] = make_uint4(0, 0, 0, 0);
}

// The staged walk over the tile through the 2-slot ring; compute(st, slot)
// runs once stage st has arrived. One barrier a stage: after it every
// thread is done with stage st - 1, whose slot the copies of stage st + 1
// then refill while stage st is computed.
template <typename Compute>
__device__ __forceinline__ void walk(const uint4* kb, const Layout& L,
                                     const Tile& t, const Smem& sm,
                                     Compute&& compute) {
  const int slot_len = L.rows * L.stride;
  if (t.stages > 0) issue_stage(kb, L, t, sm, sm.ring, 0);
  cp_async_commit();
  for (int st = 0; st < t.stages; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < t.stages)
      issue_stage(kb, L, t, sm, sm.ring + ((st + 1) & 1) * slot_len, st + 1);
    cp_async_commit();
    compute(st, sm.ring + (st & 1) * slot_len);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The f32 route's ring: slot s holds stage st = s, s + D, s + 2 D, ...
// full[s] completes when the stage's rows have landed: one arrival, the
// issuing lane's, plus the bytes of the stage's TMA copies, or one arrival
// a lane of the issuing warp as its cp.async copies land. empty[s] (one
// arrival a warp) completes when every warp is done with them. Thread 0
// sets them up before plan_tile, whose barriers publish them. TMA: whether
// the rows come by TMA (Layout::tma; a template parameter: with both ways
// of copying in one instance the kernels ran slower at C = 496, PERF.md).
template <bool TMA>
__device__ __forceinline__ void init_ring(const Layout& L, const Smem& sm) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < L.slots; ++s) {
    mbar_init(sm.full + s, TMA ? 1 : 32);
    mbar_init(sm.empty + s, kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One warp copies the rows of stage st's run heads into its slot, row r
// of the slot for head st * R + r: rows of 1 KB and more one TMA bulk copy
// (C * 4 bytes) each, after lane 0 has told full[] how many bytes to
// expect; shorter rows (C = 16: 64 B, where a TMA copy a row costs more
// than its bytes) as 16-byte cp.async chunks, min(C / 4, 32) lanes a row,
// after which each lane arrives on full[] as its copies land.
template <bool TMA>
__device__ __forceinline__ void issue_stage_f32(const uint4* kb,
                                                const Layout& L,
                                                const Tile& t, const Smem& sm,
                                                int st) {
  const int lane = threadIdx.x & 31, s = st % L.slots;
  const int h0 = st * L.rows, nr = imin(L.rows, t.heads - h0);
  uint4* slot = sm.ring + (size_t)s * L.rows * L.stride;
  if constexpr (TMA) {
    const unsigned row_bytes = L.cr * 16;
    if (lane == 0) mbar_arrive_tx(sm.full + s, nr * row_bytes);
    __syncwarp();
    for (int r = lane; r < nr; r += 32)
      bulk_copy(slot + r * L.stride,
                kb + (long long)sm.idx[sm.heads[h0 + r]] * L.cr, row_bytes,
                sm.full + s);
  } else {
    const int tpr = 1 << L.tlog;
    for (int r = lane >> L.tlog; r < nr; r += 32 >> L.tlog) {
      const uint4* row = kb + (long long)sm.idx[sm.heads[h0 + r]] * L.cr;
      uint4* dst = slot + r * L.stride;
      for (int j = lane & (tpr - 1); j < L.cr; j += tpr)
        cp_async16(dst + j, row + j);
    }
    cp_async_arrive(sm.full + s);
  }
}

// The f32 route's walk over the tile through the D-slot ring; compute(st,
// slot) runs once stage st has landed. Warp w fills slot w (w < D), then
// every thread runs before() (all of them: it may hold a block barrier)
// while those copies are in flight. Warp 0 refills stage st - 1's slot
// with stage st + D - 1 as soon as every warp is done with it (its empty
// barrier), before it computes stage st. So stages st + 1 ... st + D - 1
// are in flight while stage st is computed, and a warp waits only on its
// stage's full barrier: no block barrier and no wait on all copies sits
// on a stage. (An integer count in place of the empty barrier, the last
// warp done with a stage refilling its slot, ran slower on the H100 at C =
// 496: PERF.md.)
template <bool TMA, typename Before, typename Compute>
__device__ __forceinline__ void walk_f32(const uint4* kb, const Layout& L,
                                         const Tile& t, const Smem& sm,
                                         Before&& before,
                                         Compute&& compute) {
  const int D = L.slots, slot_len = L.rows * L.stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int st = warp; st < imin(D, t.stages); st += kWarps)
    issue_stage_f32<TMA>(kb, L, t, sm, st);
  before();
  for (int st = 0; st < t.stages; ++st) {
    const int s = st % D;
    if (warp == 0 && st > 0 && st + D - 1 < t.stages) {
      mbar_wait(sm.empty + (st - 1) % D, ((st - 1) / D) & 1);
      issue_stage_f32<TMA>(kb, L, t, sm, st + D - 1);
    }
    mbar_wait(sm.full + s, (st / D) & 1);
    compute(st, sm.ring + (size_t)s * slot_len);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + s);
  }
  __syncthreads();
}

// The f32 route's split sum, folded into the kernel: after each block of a
// (class, query group) has written its partial, the last of the S to
// finish (an integer ticket after __threadfence; no float atomics) sums
// the S partials in split order, as sum_splits_kernel does, into out and
// leaves its ticket at 0 for the next launch. The group's partial s of
// entry i lies at part[(k * S + s) * inner + off + i], its sum at
// out[k * inner + off + i], i < len.
__device__ __forceinline__ void fold_splits(const float* part, float* out,
                                            unsigned* tickets, const Tile& t,
                                            const Smem& sm, long long inner,
                                            long long off, int len) {
  const int S = gridDim.y;
  // the barrier orders the block's writes before thread 0's fence, which
  // releases them with the ticket (and, in the last block, acquires the
  // other blocks' before the barrier that lets its threads read them)
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = tickets + (long long)t.k * gridDim.x + blockIdx.x;
    __threadfence();
    const bool last = atomicAdd(ticket, 1u) == (unsigned)S - 1;
    if (last) {
      *ticket = 0u;
      __threadfence();
    }
    sm.scan[0] = last;
  }
  __syncthreads();
  if (!sm.scan[0]) return;
  const float* p = part + (long long)t.k * S * inner + off;
  float* o = out + (long long)t.k * inner + off;
  if (((inner | off | len) & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < len; i += 4 * kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < S; ++j) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(p + j * inner + i));
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      *reinterpret_cast<float4*>(o + i) = v;
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float v = 0.f;
      for (int j = 0; j < S; ++j) v += __ldcg(p + j * inner + i);
      o[i] = v;
    }
  }
}

// The f32 route's workspace: the tickets, one a (class, query group),
// rounded up to 16 bytes, then the partials.
__host__ __device__ inline long long ticket_words(int groups, int K) {
  return ((long long)groups * K + 3) / 4 * 4;
}

// The forward's tail: e out, coalesced over n; the chunk's partial
// denominators, each summed by one warp in a fixed order.
__device__ __forceinline__ void store_fwd(const Layout& L, const Tile& t,
                                          const Smem& sm, float* e,
                                          float* dpart, int Q, int N) {
  constexpr int G = kG;
  const long long qbase = (long long)t.k * Q + t.q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < L.P; i += kThreads) {
    const int gg = i / L.chunk, nl = i - gg * L.chunk;
    if (gg < t.gq && nl < t.nn)
      e[(qbase + gg) * N + t.n0 + nl] = sm.val[nl * G + gg];
  }
  for (int gg = warp; gg < t.gq; gg += kWarps) {
    float sum = 0.f;
    for (int nl = lane; nl < t.nn; nl += 32) sum += sm.val[nl * G + gg];
    sum = warp_sum(sum);
    if (lane == 0)
      dpart[((long long)t.k * gridDim.y + t.s) * Q + t.q0 + gg] = sum;
  }
}

// The backward's weights: val[o] = e * invtot of each pair of the tile, 0
// outside it.
__device__ __forceinline__ void load_weights(const Layout& L, const Tile& t,
                                             const Smem& sm, const float* e,
                                             const float* invtot, int Q,
                                             int N) {
  constexpr int G = kG;
  const long long qbase = (long long)t.k * Q + t.q0;
  for (int i = threadIdx.x; i < L.P; i += kThreads) {
    const int gg = i / L.chunk, nl = i - gg * L.chunk;
    sm.val[nl * G + gg] =
        (gg < t.gq && nl < t.nn)
            ? e[(qbase + gg) * N + t.n0 + nl] * invtot[qbase + gg]
            : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
infonce_fwd_kernel(const Layout L,
                   const __nv_bfloat16* __restrict__ anchors,  // [K,Q,C]
                   const __nv_bfloat16* __restrict__ bank,     // [K,cap,C]
                   const int32_t* __restrict__ neg_idx,        // [K,Q,N]
                   float* __restrict__ e,                      // [K,Q,N]
                   float* __restrict__ dpart,                  // [K,S,Q]
                   int Q, int N, int C, long long cap, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const Smem sm(smem, L);
  Tile t = tile_of(Q, N, L);
  const long long qbase = (long long)t.k * Q + t.q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the group's anchors, zeros past the group and past C
  {
    const uint4* arow = reinterpret_cast<const uint4*>(anchors + qbase * C);
    for (int i = threadIdx.x; i < G * L.stride; i += kThreads) {
      const int g = i / L.stride, j = i - g * L.stride;
      sm.anchors[i] = g < t.gq && j < L.c8
                          ? __ldg(arow + (long long)g * L.c8 + j)
                          : make_uint4(0, 0, 0, 0);
    }
  }
  zero_pad(L, sm);
  plan_tile(neg_idx, Q, N, L, sm, t);

  const uint4* kb =
      reinterpret_cast<const uint4*>(bank + (long long)t.k * cap * C);
  // A: lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of the m16 tile at
  // k-chunk l >> 4 (matrices rows 0-7 / 8-15 x k 0-7 / 8-15); B: anchor
  // (l & 7) + 8 (l >> 4) at k-chunk (l >> 3) & 1 (n8 tile 0 k lo, k hi,
  // then n8 tile 1)
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.stride +
                    (lane >> 4);
  const uint4* brow =
      sm.anchors + ((lane & 7) + 8 * (lane >> 4)) * L.stride +
      ((lane >> 3) & 1);
  const int g = lane >> 2, tq = lane & 3;
  const int units = L.mt * L.kp;
  walk(kb, L, t, sm, [&](int st, const uint4* slot) {
    const int h0 = st * L.rows;
    const int mtiles = (imin(L.rows, t.heads - h0) + 15) >> 4;
    // warp unit u: m16 tile u % mt, k-steps u / mt, u / mt + kp, ...
    for (int u = warp; u < units; u += kWarps) {
      const int mtile = u % L.mt, kpart = u / L.mt;
      if (mtile >= mtiles) continue;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint4* arow = slot + mtile * 16 * L.stride + a_off;
      for (int kk = kpart; kk < L.ks; kk += L.kp) {
        uint32_t a[4], b[4];
        ldsm_x4(a, arow + 2 * kk);
        ldsm_x4(b, brow + 2 * kk);
        mma16816(acc[0], a, b[0], b[1]);
        mma16816(acc[1], a, b[2], b[3]);
      }
      float* sp = sm.spart + ((size_t)kpart * L.rows + mtile * 16 + g) * G +
                  2 * tq;
      *reinterpret_cast<float2*>(sp) = make_float2(acc[0][0], acc[0][1]);
      *reinterpret_cast<float2*>(sp + 8 * G) =
          make_float2(acc[0][2], acc[0][3]);
      *reinterpret_cast<float2*>(sp + 8) = make_float2(acc[1][0], acc[1][1]);
      *reinterpret_cast<float2*>(sp + 8 * G + 8) =
          make_float2(acc[1][2], acc[1][3]);
    }
    __syncthreads();
    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];
    for (int o = oa + threadIdx.x; o < ob; o += kThreads) {
      const int nl = o / G, gg = o % G;
      if (gg < t.gq && nl < t.nn) {
        const float* sp = sm.spart + (sm.head[o] - h0) * G + gg;
        float s = 0.f;
        for (int p = 0; p < L.kp; ++p) s += sp[(size_t)p * L.rows * G];
        sm.val[o] = expf(s * inv_temp - inv_temp);
      }
    }
  });

  store_fwd(L, t, sm, e, dpart, Q, N);
}

// NP: the most n8-tile pairs a warp holds (1, 2 or 4), which sizes the
// accumulators and so the registers.
template <int NP>
__global__ void __launch_bounds__(kThreads, max_blocks(false, NP))
infonce_bwd_kernel(const Layout L,
                   const float* __restrict__ e,                // [K,Q,N]
                   const __nv_bfloat16* __restrict__ bank,     // [K,cap,C]
                   const int32_t* __restrict__ neg_idx,        // [K,Q,N]
                   const float* __restrict__ invtot,           // [K,Q]
                   float* __restrict__ gpart,                  // [K,S,Q,C]
                   int Q, int N, int C, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const int S = gridDim.y;
  const Smem sm(smem, L);
  Tile t = tile_of(Q, N, L);

  load_weights(L, t, sm, e, invtot, Q, N);
  zero_pad(L, sm);
  plan_tile(neg_idx, Q, N, L, sm, t);

  // warp: n8-tile pairs npl, npl + npw, ... (channels 16 np .. 16 np + 15)
  // over the k-steps kpart, kpart + kpb, ... of every stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int npl = warp % L.npw, kpart = warp / L.npw;
  // B (.trans): lane l addresses staged row (l & 7) + 8 ((l >> 3) & 1) of
  // the k-step at chunk l >> 4 of the pair (k lo / hi of n8 tile 0, then 1)
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.stride +
                    2 * npl + (lane >> 4);
  float acc[NP][2][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][0][v] = acc[i][1][v] = 0.f;

  const uint4* kb =
      reinterpret_cast<const uint4*>(bank + (long long)t.k * cap * C);
  // A (W, row-major [G][wstride]): lane l addresses query (l & 7) +
  // 8 ((l >> 3) & 1) at column 8 (l >> 4) of the k-step
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.wstride +
                    8 * (lane >> 4);
  walk(kb, L, t, sm, [&](int st, const uint4* slot) {
    const int h0 = st * L.rows;
    const int nr = imin(L.rows, t.heads - h0);
    const int ksteps = (nr + 15) >> 4;
    // W[g][r] = the weight of query g's pair that reads staged row r, or 0,
    // up to the stage's last k-step, split into bf16 hi + lo
    for (int i = threadIdx.x; i < ksteps * 16 * G; i += kThreads) {
      const int r = i / G, gg = i % G;
      float w = 0.f;
      if (r < nr) {
        const int h = h0 + r;
        const int o = (sm.heads[h] / G) * G + gg;   // query gg, head's n
        if (sm.head[o] == h) w = sm.val[o];
      }
      const __nv_bfloat16 hi = __float2bfloat16_rn(w);
      sm.whi[gg * L.wstride + r] = hi;
      sm.wlo[gg * L.wstride + r] =
          __float2bfloat16_rn(w - __bfloat162float(hi));
    }
    __syncthreads();
    for (int kk = kpart; kk < ksteps; kk += L.kpb) {
      uint32_t ahi[4], alo[4];
      ldsm_x4(ahi, sm.whi + a_off + 16 * kk);
      ldsm_x4(alo, sm.wlo + a_off + 16 * kk);
      const uint4* brow = slot + 16 * kk * L.stride + b_off;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (npl + i * L.npw < L.ks) {
          uint32_t b[4];
          ldsm_x4_trans(b, brow + 2 * i * L.npw);
          mma16816(acc[i][0], ahi, b[0], b[1]);
          mma16816(acc[i][0], alo, b[0], b[1]);
          mma16816(acc[i][1], ahi, b[2], b[3]);
          mma16816(acc[i][1], alo, b[2], b[3]);
        }
      }
    }
  });

  // k-split partials (C <= 112: one pair a warp), summed in kpart order in
  // the ring, which the walk no longer uses
  if (L.kpb > 1) {
    float* red = reinterpret_cast<float*>(sm.ring);
    float* mine = red + ((kpart * L.npw + npl) * 32 + lane) * 8;
    if (kpart > 0) {
      reinterpret_cast<float4*>(mine)[0] =
          make_float4(acc[0][0][0], acc[0][0][1], acc[0][0][2], acc[0][0][3]);
      reinterpret_cast<float4*>(mine)[1] =
          make_float4(acc[0][1][0], acc[0][1][1], acc[0][1][2], acc[0][1][3]);
    }
    __syncthreads();
    if (kpart == 0)
      for (int p = 1; p < L.kpb; ++p) {
        const float* other = mine + p * L.npw * 32 * 8;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[0][0][v] += other[v];
          acc[0][1][v] += other[4 + v];
        }
      }
  }
  if (kpart == 0) {
    float* out = gpart + (((long long)t.k * S + t.s) * Q + t.q0) * C;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int tile = 2 * (npl + i * L.npw) + nt;
        if (tile < L.c8) {
          const int col = 8 * tile + 2 * tq;
          if (g < t.gq)
            *reinterpret_cast<float2*>(out + (long long)g * C + col) =
                make_float2(acc[i][nt][0], acc[i][nt][1]);
          if (g + 8 < t.gq)
            *reinterpret_cast<float2*>(out + (long long)(g + 8) * C + col) =
                make_float2(acc[i][nt][2], acc[i][nt][3]);
        }
      }
  }
}

// The f32 route's forward: the pairs' dot products in f32 FMAs on the
// staged rows (see the top of the file). work: the tickets, then the
// partial denominators [K,S,Q]. J: the chunks a lane reads of a row
// (ceil(C / 4 / lanes), a power of two up to 8); TMA: Layout::tma.
template <int J, bool TMA>
__global__ void __launch_bounds__(kThreads, kBlocksF32)
infonce_fwd_f32_kernel(const Layout L,
                       const float* __restrict__ anchors,      // [K,Q,C]
                       const float* __restrict__ bank,         // [K,cap,C]
                       const int32_t* __restrict__ neg_idx,    // [K,Q,N]
                       float* __restrict__ e,                  // [K,Q,N]
                       unsigned* __restrict__ work,
                       float* __restrict__ denom,              // [K,Q]
                       int Q, int N, int C, long long cap,
                       float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const Smem sm(smem, L);
  Tile t = tile_of(Q, N, L);
  const long long qbase = (long long)t.k * Q + t.q0;

  // Lane group grp (LP lanes) serves query grp % G and the samples of its
  // slice grp / G; lane l the chunks j = l + LP * i, so the thread's part
  // of the anchor lives in registers. A warp's groups share one slice, so
  // the loop bounds below are the same for the whole warp.
  const int LP = L.lanes, nsl = L.slices;
  const int grp = threadIdx.x / LP, lane = threadIdx.x % LP;
  const int g = grp % G, slice = grp / G;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a[J];
  {
    const float4* arow = reinterpret_cast<const float4*>(anchors) +
                         (qbase + g) * L.cr;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = lane + LP * i;
      a[i] = g < t.gq && j < L.cr ? __ldg(arow + j) : zero;
    }
  }
  init_ring<TMA>(L, sm);
  plan_tile(neg_idx, Q, N, L, sm, t);

  const uint4* kb =
      reinterpret_cast<const uint4*>(bank + (long long)t.k * cap * C);
  // <row, anchor> partial sum of this lane's chunks of slot row r. The
  // loads are not behind a branch, so the two samples' loads overlap.
  auto dot = [&](const uint4* slot, int r) {
    const float4* row = reinterpret_cast<const float4*>(slot + r * L.stride);
    float4 x[J];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = lane + LP * i;
      x[i] = j < L.cr ? row[j] : zero;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < J; ++i) {
      acc[0] = fmaf(x[i].x, a[i].x, acc[0]);
      acc[1] = fmaf(x[i].y, a[i].y, acc[1]);
      acc[2] = fmaf(x[i].z, a[i].z, acc[2]);
      acc[3] = fmaf(x[i].w, a[i].w, acc[3]);
    }
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
  };
  walk_f32<TMA>(kb, L, t, sm, [] {}, [&](int st, const uint4* slot) {
    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];
    const int na = oa / G, nb = (ob - 1) / G, h0 = st * L.rows;
    auto valid = [&](int nl, int o) {
      return g < t.gq && nl <= nb && nl < t.nn && o >= oa && o < ob;
    };
    // two samples at a time, nl and nl + 1. An invalid pair reads the
    // stage's first row and is not stored. One butterfly sums both
    // samples: after its first step the low half of the group holds
    // sample A's sums and the high half B's.
    for (int nl = na + 2 * slice; nl <= nb; nl += 2 * nsl) {
      const int oA = nl * G + g, oB = oA + G;
      const bool vA = valid(nl, oA), vB = valid(nl + 1, oB);
      const int rA = vA ? sm.head[oA] - h0 : 0;
      const int rB = vB ? sm.head[oB] - h0 : 0;
      const float sA = dot(slot, rA), sB = dot(slot, rB);
      const bool hi = lane & (LP / 2);
      float s = (hi ? sB : sA) +
                __shfl_xor_sync(0xffffffffu, hi ? sA : sB, LP / 2);
      for (int d = LP / 4; d > 0; d >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, d);
      if (lane == 0 && vA) sm.val[oA] = expf(s * inv_temp - inv_temp);
      if (lane == LP / 2 && vB) sm.val[oB] = expf(s * inv_temp - inv_temp);
    }
  });
  float* dpart =
      reinterpret_cast<float*>(work + ticket_words(gridDim.x, gridDim.z));
  store_fwd(L, t, sm, e, dpart, Q, N);
  fold_splits(dpart, denom, work, t, sm, Q, t.q0, t.gq);
}

// The f32 route's backward: each thread accumulates e * invtot * row for
// its (query, chunk) entries of the [G, C] output over its samples. work:
// the tickets, then the partials [K,S,Q,C]. M: the entries a thread owns
// (ceil(G * C / 4 / kThreads), a power of two up to 8); TMA: Layout::tma.
template <int M, bool TMA>
__global__ void __launch_bounds__(kThreads, kBlocksF32)
infonce_bwd_f32_kernel(const Layout L,
                       const float* __restrict__ e,            // [K,Q,N]
                       const float* __restrict__ bank,         // [K,cap,C]
                       const int32_t* __restrict__ neg_idx,    // [K,Q,N]
                       const float* __restrict__ invtot,       // [K,Q]
                       unsigned* __restrict__ work,
                       float* __restrict__ ga,                 // [K,Q,C]
                       int Q, int N, int C, long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kG;
  const Smem sm(smem, L);
  Tile t = tile_of(Q, N, L);
  init_ring<TMA>(L, sm);
  plan_tile(neg_idx, Q, N, L, sm, t);

  // With one slice thread i owns the output chunks p = i + m * kThreads of
  // the [G, cr] tile (G * cr <= M * kThreads); with more, each
  // thread one chunk p = i % own of slice i / own. own_g = G: no entry.
  const int own = G * L.cr, nsl = L.slices;
  const int slice = nsl > 1 ? threadIdx.x / own : 0;
  int own_g[M], own_j[M];
  float4 acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int p = nsl > 1 ? threadIdx.x % own : threadIdx.x + m * kThreads;
    const bool ok = nsl > 1 ? m == 0 && slice < nsl : p < own;
    own_g[m] = ok ? p / L.cr : G;
    own_j[m] = ok ? p - own_g[m] * L.cr : 0;
    acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const uint4* kb =
      reinterpret_cast<const uint4*>(bank + (long long)t.k * cap * C);
  // the weights load while the first stages' copies are in flight
  auto weights = [&] {
    load_weights(L, t, sm, e, invtot, Q, N);
    __syncthreads();
  };
  walk_f32<TMA>(kb, L, t, sm, weights, [&](int st, const uint4* slot) {
    const int oa = sm.ostart[st], ob = sm.ostart[st + 1];
    const int na = oa / G, nb = imin((ob - 1) / G, t.nn - 1);
    // the stage's samples nl in [lo[m], hi[m]] for query own_g[m]
    int lo[M], hi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int g = own_g[m];
      lo[m] = na + (na * G + g < oa);
      hi[m] = g < t.gq ? nb - (nb * G + g >= ob) : na - 1;
    }
    // A pair outside the stage weighs 0 and reads the stage's first row.
    const int h0 = st * L.rows;
    for (int nl = na + slice; nl <= nb; nl += nsl) {
      int r[M];
      float w[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const bool v = nl >= lo[m] && nl <= hi[m];
        const int o = nl * G + own_g[m];
        r[m] = v ? sm.head[o] - h0 : 0;
        w[m] = v ? sm.val[o] : 0.f;
      }
      float4 x[M];
#pragma unroll
      for (int m = 0; m < M; ++m)
        x[m] = reinterpret_cast<const float4*>(slot + r[m] * L.stride)
            [own_j[m]];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        acc[m].x = fmaf(w[m], x[m].x, acc[m].x);
        acc[m].y = fmaf(w[m], x[m].y, acc[m].y);
        acc[m].z = fmaf(w[m], x[m].z, acc[m].z);
        acc[m].w = fmaf(w[m], x[m].w, acc[m].w);
      }
    }
  });

  // the slices' partials, summed in slice order in the ring, which the
  // walk no longer uses
  if (nsl > 1) {
    float4* red = reinterpret_cast<float4*>(sm.ring);
    const int p = threadIdx.x % own;
    if (slice > 0 && slice < nsl) red[(slice - 1) * own + p] = acc[0];
    __syncthreads();
    if (slice == 0)
      for (int s = 1; s < nsl; ++s) {
        const float4 v = red[(s - 1) * own + p];
        acc[0].x += v.x;
        acc[0].y += v.y;
        acc[0].z += v.z;
        acc[0].w += v.w;
      }
  }
  float* gpart =
      reinterpret_cast<float*>(work + ticket_words(gridDim.x, gridDim.z));
  if (slice == 0) {
    float4* out = reinterpret_cast<float4*>(
        gpart + (((long long)t.k * gridDim.y + t.s) * Q + t.q0) * C);
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (own_g[m] < t.gq)
        out[(long long)own_g[m] * L.cr + own_j[m]] = acc[m];
  }
  fold_splits(gpart, ga, work, t, sm, (long long)Q * C, (long long)t.q0 * C,
              t.gq * C);
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

bool fwd_smem_set[kMaxDevices], bwd_smem_set[3][kMaxDevices];
bool fwd_f32_smem_set[2][4][kMaxDevices], bwd_f32_smem_set[2][4][kMaxDevices];

// i with 2^i >= x, 2^(i-1) < x: the f32 kernels' instance for x <= 8.
int log2_ceil(int x) {
  int i = 0;
  while ((1 << i) < x) ++i;
  return i;
}

// Launch an f32 kernel instance with the layout's shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_f32(Kernel kernel, bool* smem_set, const Layout& L,
                       dim3 grid, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem((const void*)kernel, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, L.bytes, stream>>>(L, args...);
  return cudaGetLastError();
}

// Launch the backward instance for L.pairs n8-tile pairs a warp.
template <int NP>
cudaError_t launch_bwd(const Layout& L, dim3 grid, cudaStream_t stream,
                       bool* smem_set, const float* e,
                       const __nv_bfloat16* bank, const int32_t* neg_idx,
                       const float* invtot, float* gpart, int Q, int N, int C,
                       long long cap) {
  cudaError_t err = allow_smem((const void*)infonce_bwd_kernel<NP>, smem_set);
  if (err != cudaSuccess) return err;
  infonce_bwd_kernel<NP><<<grid, kThreads, L.bytes, stream>>>(
      L, e, bank, neg_idx, invtot, gpart, Q, N, C, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Queries per block.
int arco_infonce_group() { return kG; }

// Chunks of the samples: 4, doubled (up to 16, while a chunk keeps at
// least kMinChunk samples) until the grid has a block for each SM. The
// partials hold K * splits * Q floats (fwd) and K * splits * Q * C floats
// (bwd).
int arco_infonce_splits(int K, int Q, int N, int C) {
  (void)C;
  const long long groups = (long long)K * ((Q + kG - 1) / kG);
  int S = kMinSplits;
  while (S < kMaxSplits && groups * S < kSms &&
         (N + 2 * S - 1) / (2 * S) >= kMinChunk)
    S *= 2;
  return S;
}

// Rows a stage of the forward (fwd != 0) or the backward kernel of the
// bf16 (f32 == 0) or the f32 route stages at this shape.
int arco_infonce_rows(int K, int Q, int N, int C, int fwd, int f32) {
  return Layout(N, C, arco_infonce_splits(K, Q, N, C), fwd != 0, f32 != 0)
      .rows;
}

// Slots of the ring of the forward (fwd != 0) or the backward kernel of
// the bf16 (f32 == 0) or the f32 route at this shape.
int arco_infonce_slots(int K, int Q, int N, int C, int fwd, int f32) {
  return Layout(N, C, arco_infonce_splits(K, Q, N, C), fwd != 0, f32 != 0)
      .slots;
}

// Bytes of the f32 route's workspace for the forward (fwd != 0) or the
// backward: a ticket (uint32) a (class, query group), rounded up to 16
// bytes, then the partials, K * splits * Q floats (fwd) or K * splits * Q
// * C (bwd). The tickets must be zero before the first launch; every
// launch leaves them at zero.
long long arco_infonce_work(int K, int Q, int N, int C, int fwd) {
  const long long S = arco_infonce_splits(K, Q, N, C);
  return 4 * ticket_words((Q + kG - 1) / kG, K) +
         4 * (long long)K * S * Q * (fwd ? 1 : C);
}

// Dynamic shared memory of a block of either kernel of the bf16 (f32 ==
// 0) or the f32 route at the fewest splits, or 0 for a shape they do not
// take: C a multiple of 8 up to 512, at most 32767 pairs per tile, and at
// most kSmemMax bytes (more splits only make the tile smaller).
size_t arco_infonce_smem(int N, int C, int f32) {
  if (N < 1 || C < 8 || C % 8 || C > kMaxC) return 0;
  const Layout f(N, C, kMinSplits, true, f32 != 0),
      b(N, C, kMinSplits, false, f32 != 0);
  if (f.P > 32767 || f.bytes > kSmemMax || b.bytes > kSmemMax) return 0;
  return f.bytes > b.bytes ? f.bytes : b.bytes;
}

int arco_infonce_fwd(const void* anchors, const void* bank,
                     const void* neg_idx, void* e, void* dpart, void* denom,
                     int K, int Q, int N, int C, long long cap,
                     float inv_temp, void* stream) {
  if (!arco_infonce_smem(N, C, 0)) return (int)cudaErrorInvalidValue;
  const int S = arco_infonce_splits(K, Q, N, C);
  const Layout L(N, C, S, true);
  cudaError_t err = allow_smem((const void*)infonce_fwd_kernel, fwd_smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kG - 1) / kG, S, K);
  infonce_fwd_kernel<<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      L, (const __nv_bfloat16*)anchors, (const __nv_bfloat16*)bank,
      (const int32_t*)neg_idx, (float*)e, (float*)dpart, Q, N, C, cap,
      inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits((const float*)dpart, (float*)denom, S, Q,
                    (long long)K * Q, (cudaStream_t)stream);
}

int arco_infonce_bwd(const void* e, const void* bank, const void* neg_idx,
                     const void* invtot, void* gpart, void* ga, int K, int Q,
                     int N, int C, long long cap, void* stream) {
  if (!arco_infonce_smem(N, C, 0)) return (int)cudaErrorInvalidValue;
  const int S = arco_infonce_splits(K, Q, N, C);
  const Layout L(N, C, S, false);
  const dim3 grid((Q + kG - 1) / kG, S, K);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ef = (const float*)e;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)bank;
  const int32_t* ib = (const int32_t*)neg_idx;
  const float* it = (const float*)invtot;
  float* gp = (float*)gpart;
  const cudaError_t err =
      L.pairs == 1 ? launch_bwd<1>(L, grid, st, bwd_smem_set[0], ef, kb, ib,
                                   it, gp, Q, N, C, cap)
      : L.pairs == 2 ? launch_bwd<2>(L, grid, st, bwd_smem_set[1], ef, kb,
                                     ib, it, gp, Q, N, C, cap)
                     : launch_bwd<4>(L, grid, st, bwd_smem_set[2], ef, kb,
                                     ib, it, gp, Q, N, C, cap);
  if (err != cudaSuccess) return (int)err;
  return sum_splits((const float*)gpart, (float*)ga, S, (long long)Q * C,
                    (long long)K * Q * C, (cudaStream_t)stream);
}

// The f32 route: f32 anchors and bank, the same arguments and outputs,
// but in place of dpart / gpart the workspace of arco_infonce_work bytes,
// whose tickets let the kernel sum its partials itself: one grid a call.
int arco_infonce_fwd_f32(const void* anchors, const void* bank,
                         const void* neg_idx, void* e, void* work,
                         void* denom, int K, int Q, int N, int C,
                         long long cap, float inv_temp, void* stream) {
  if (!arco_infonce_smem(N, C, 1)) return (int)cudaErrorInvalidValue;
  const int S = arco_infonce_splits(K, Q, N, C);
  const Layout L(N, C, S, true, true);
  const dim3 grid((Q + kG - 1) / kG, S, K);
  decltype(&infonce_fwd_f32_kernel<1, false>) const kernels[2][4] = {
      {infonce_fwd_f32_kernel<1, false>, infonce_fwd_f32_kernel<2, false>,
       infonce_fwd_f32_kernel<4, false>, infonce_fwd_f32_kernel<8, false>},
      {infonce_fwd_f32_kernel<1, true>, infonce_fwd_f32_kernel<2, true>,
       infonce_fwd_f32_kernel<4, true>, infonce_fwd_f32_kernel<8, true>}};
  const int j = log2_ceil((L.cr + L.lanes - 1) / L.lanes);
  return (int)launch_f32(kernels[L.tma][j], fwd_f32_smem_set[L.tma][j], L,
                         grid, (cudaStream_t)stream, (const float*)anchors,
                         (const float*)bank, (const int32_t*)neg_idx,
                         (float*)e, (unsigned*)work, (float*)denom, Q, N, C,
                         cap, inv_temp);
}

int arco_infonce_bwd_f32(const void* e, const void* bank, const void* neg_idx,
                         const void* invtot, void* work, void* ga, int K,
                         int Q, int N, int C, long long cap, void* stream) {
  if (!arco_infonce_smem(N, C, 1)) return (int)cudaErrorInvalidValue;
  const int S = arco_infonce_splits(K, Q, N, C);
  const Layout L(N, C, S, false, true);
  const dim3 grid((Q + kG - 1) / kG, S, K);
  decltype(&infonce_bwd_f32_kernel<1, false>) const kernels[2][4] = {
      {infonce_bwd_f32_kernel<1, false>, infonce_bwd_f32_kernel<2, false>,
       infonce_bwd_f32_kernel<4, false>, infonce_bwd_f32_kernel<8, false>},
      {infonce_bwd_f32_kernel<1, true>, infonce_bwd_f32_kernel<2, true>,
       infonce_bwd_f32_kernel<4, true>, infonce_bwd_f32_kernel<8, true>}};
  const int m = log2_ceil((kG * L.cr + kThreads - 1) / kThreads);
  return (int)launch_f32(kernels[L.tma][m], bwd_f32_smem_set[L.tma][m], L,
                         grid, (cudaStream_t)stream, (const float*)e,
                         (const float*)bank, (const int32_t*)neg_idx,
                         (const float*)invtot, (unsigned*)work, (float*)ga,
                         Q, N, C, cap);
}

}  // extern "C"
