// q4_mm_tile.cuh: the block body shared by q4_matmul.cu (one weight stream, with an
// optional residual) and q4_gated_matmul.cu (two weight streams, W1 and W3, over one X
// tile, with the activation epilogue). Y[m, n] = sum_k X[m, k] · w[n, k] for X (M, K)
// bf16 against Q40 weights in the i4p split-plane layout: packed byte c of row n holds
// w[n, c] in its low nibble and w[n, K/2 + c] in its high nibble, and each 32-value
// block has one f16 scale. Every weight decodes as bf16((q - 8) · f32(s)), rounded once;
// the products accumulate in f32.
//
// Operands swapped: the weight rows are the MMA's rows (A) and the activation rows its
// columns (B), so M = 8 fills an MMA with no padding. A never touches shared memory:
// each thread decodes its A fragments in registers from the packed bytes, two weights
// per bf16x2 instruction: the nibble as the mantissa of 128 + q, a subtraction of 136
// (exact), then fma(q - 8, hi, (q - 8)·lo) with the scale split exactly into a bf16 hi
// and a bf16 lo part (an f16 has 11 significant bits, bf16 8): the one rounding is that
// of (q - 8)·s, the function of the TPU kernel to the bit.
//
// Products, by tile. Up to 16 activation rows (WG = 0): per-warp mma.sync.m16n8k16,
// 16 weight rows by 8 activation rows; the order of k inside one MMA step is free as
// long as A and B agree, so thread tq of a row takes 8·CH consecutive packed bytes of
// the stage, all of one Q40 block (one scale per plane), and its X fragment is the same
// 4 consecutive k of each plane, read from shared memory. Above 16 rows (WG = 1):
// warpgroup wgmma.m64nNk16 with A from registers, 64 weight rows by all N = BN
// activation rows, B (X) read by the tensor cores straight from the swizzled boxes the
// copy engine wrote; the A fragments are decoded in natural k order, and the products
// of one chunk run while the next chunk decodes. The X fragment loads of mma.sync bound
// it at 64 and 512 rows; the warpgroup products do without them.
//
// Ring: a stage holds CH 32-byte chunks (one Q40 block per plane each) of every weight
// row of the tile, their scales, and the matching 2 x 32·CH values of the X rows. The
// copy engine fills X and the weights with one tensor copy per X plane box and weight
// stream (host-encoded maps; boxes swizzled in 128- or 64-byte patterns so that the
// 16-byte fragment loads of a warp hit distinct bank groups; what lies past M, N or K/2
// zero-filled), counted in by an mbarrier per stage. The scales come by 4-byte cp.async
// (a row's high-plane scales start at byte K/32 of its scale row, which a tensor copy
// cannot take at every K). STAGES - 1 stages are in flight ahead of the math; one block
// barrier per stage frees a slot. Per-thread 16-byte cp.async copies of X and the
// weights cost the threads about a third of the time at M = 64 and 512 on an H100.
//
// Work: a block tile is BW weight rows (per stream) by BN activation rows. Items are
// (tile, K split) pairs, weight-major (the activation tiles of one weight tile run side
// by side and share it in L2); the grid is at most the blocks the card holds at once,
// and a block walks the items in strides of the grid. With K split, every split block
// writes its f32 fragments to the workspace in the order of its threads, and the last
// block of a tile to finish (an acq_rel counter per tile) sums them in split order
// (deterministic, no float atomics), resets the counter, and runs the epilogue; one
// launch per call.
//
// Epilogue: the f32 sums (for two streams, act(gate) · up on the full gate sum) are
// staged through shared memory, then written coalesced in the caller's dtype (f32 or
// bf16, rounded once), the residual (f32 or bf16) added in f32 first.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace q4mm {

using namespace acopy;

constexpr int kChunk = 32;  // packed bytes of a weight row per stage: one block per plane

struct Params {
  CUtensorMap xmap;        // x as (rows m, plane 2, k/2) bf16: a box of one plane
  CUtensorMap wmap[2];     // each stream's packed planes as (rows n, k/2) u8
  const __nv_bfloat16* x;  // (m, k) bf16, 16-byte aligned rows
  const uint8_t* wp[2];    // (n, k/2) u8 i4p planes of each stream, 16-byte aligned
  const __half* ws[2];     // (n, k/32) f16 scales, 4-byte aligned
  const void* res;         // (m, n) residual (res_kind 1 f32, 2 bf16) or null
  void* y;                 // (m, n) output: out_kind 0 f32, 1 bf16
  float* part;             // split fragments (splits > 1)
  int* counters;           // one per tile, zero between calls (splits > 1)
  int m, n, k;
  int res_kind, out_kind;
  int act;                 // two streams: 0 silu, 1 gelu_tanh
  int splits, per_split;   // K splits, chunks per split
};

// NS weight streams; a warp owns WT 16-row tiles of each stream by NT 8-row tiles of
// the activations; WW x WN warps; a stage holds CH chunks (2 or 4); STAGES stages.
template <int NS_, int WT_, int NT_, int WW_, int WN_, int CH_, int STAGES_, int WG_ = 0>
struct Cfg {
  static constexpr int NS = NS_, WT = WT_, NT = NT_, WW = WW_, WN = WN_, CH = CH_;
  static constexpr int STAGES = STAGES_;
  // WG: warpgroup products (wgmma, 64 weight rows by all BN activation rows, A from
  // registers, X from shared memory) instead of per-warp mma.sync
  static constexpr bool WG = WG_ != 0;
  static_assert(!WG || (WW % 4 == 0 && WN == 1 && (NT == 8 || NT == 16)),
                "a warpgroup product takes 4 warps over 64 rows and 64 or 128 columns");
  static_assert(CH == 2 || CH == 4, "a stage holds 2 or 4 chunks");
  static constexpr int kThreads = 32 * WW * WN;
  static constexpr int BW = WW * WT * 16;  // weight rows per block and stream
  static constexpr int BN = WN * NT * 8;   // activation rows per block
  static constexpr int kRowW = kChunk * CH;  // packed bytes of a weight row per stage
  // X of a stage: per plane, boxes of 128-byte rows (64 k; one tensor copy each),
  // swizzled by the copy engine in its 128-byte pattern
  static constexpr int kXBox = 128;
  static constexpr int kXBoxes = CH / 2;
  // scale words per row: the f16 pairs holding the stage's low-plane scales (a stage
  // starts at an even chunk), then those holding its high-plane scales (which may start
  // at an odd index)
  static constexpr int kLoWords = CH / 2;
  static constexpr int kSWords = 2 * CH;
  static constexpr int kXBytes = 2 * kXBoxes * BN * kXBox;
  static constexpr int kWBytes = NS * BW * kRowW;
  static constexpr int kTmaBytes = kXBytes + kWBytes;  // what the tensor copies bring
  static constexpr int kSBytes = NS * BW * kSWords * 4;
  // stages start on 1024 bytes, the span of the 128-byte swizzle pattern
  static constexpr int kStageBytes = (kXBytes + kWBytes + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kLdc = BW + 4;               // staged output row (floats)
  // first of the 16 weight rows a warp owns in its t-th tile: 16-row tiles of a warp
  // side by side (mma.sync), or the warpgroup's 64 rows, one 16-row slice per warp
  __device__ static __forceinline__ int row0(int t, int warp_w) {
    return WG ? (t * WW + warp_w) * 16 : (warp_w * WT + t) * 16;
  }
  static constexpr int kFrags = NS * WT * NT;       // f32x4 accumulators per thread
  // accumulator copies over the k steps, so that at least 4 MMAs in a row are
  // independent (summed in a fixed order before the epilogue)
  static constexpr int KA = WG || NS * WT * NT >= 4 ? 1 : 4 / (NS * WT * NT);
  static constexpr int kRing = STAGES * kStageBytes;
  // the ring (or the staged output tile), then the stages' mbarriers and a flag: no
  // static shared memory, so the dynamic window starts at shared address 0, on the
  // 1024 bytes the copy engine's swizzle patterns start on
  static constexpr int kMain = kRing > BN * kLdc * 4 ? kRing : BN * kLdc * 4;
  static constexpr int kSmem = kMain + 8 * STAGES + 8;
  static_assert(BN <= 256 && BW <= 256, "a tensor copy box has at most 256 rows");
  static_assert((BN * kXBox) % 1024 == 0 && kXBytes % 1024 == 0,
                "boxes start on their swizzle span");
  // byte offset of 16-byte unit u of row r in a box of `row`-byte rows, as the copy
  // engine's swizzle stores it (128: unit ^ r % 8; 64: unit ^ (r / 2) % 4)
  __device__ static __forceinline__ int swz(int r, int u, int row) {
    return row == 128 ? r * 128 + ((u ^ (r & 7)) << 4) : r * 64 + ((u ^ ((r >> 1) & 3)) << 4);
  }
};

__device__ __forceinline__ float act_f32(float a, int act) {
  if (act == 0) return a / (1.0f + expf(-a));
  const float c = 0.79788456080286535587989211986876f;  // sqrt(2/pi)
  return 0.5f * a * (1.0f + tanhf(c * a * (1.0f + 0.044715f * a * a)));
}

// A Q40 scale as two bf16 pairs (hi, hi) and (lo, lo): hi is s truncated to bf16 and lo
// the rest, s - hi, which has at most 3 significant bits (an f16 has 11) and is exact
// in bf16; lo carries s's sign when it is zero, so that a zero weight keeps the sign
// (q - 8)·s gives it.
__device__ __forceinline__ void split_scale(unsigned short h, uint32_t& hi2, uint32_t& lo2) {
  const float s = __half2float(__ushort_as_half(h));
  const uint32_t sb = __float_as_uint(s);
  const uint32_t lb =
      __float_as_uint(s - __uint_as_float(sb & 0xFFFF0000u)) | (sb & 0x80000000u);
  hi2 = __byte_perm(sb, 0, 0x3232);
  lo2 = __byte_perm(lb, 0, 0x3232);
}

// bf16x2 (128 + q) pairs -> bf16((q - 8)·s) pairs: a = q - 8 (exact), then
// fma(a, hi, a·lo) with a·lo exact (at most 7 significant bits), so the one rounding is
// that of (q - 8)·s: the function of the TPU kernel, to the bit.
__device__ __forceinline__ uint32_t dequant2(uint32_t v, uint32_t hi2, uint32_t lo2) {
  uint32_t a, p, d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(a) : "r"(v), "r"(0x43084308u));  // 136
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(a), "r"(lo2));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(hi2), "r"(p));
  return d;
}

// One packed word of a row (bytes b0..b3) -> the A fragment pairs of its two k steps:
// lo[0] = (b0, b1) low nibbles, lo[1] = (b2, b3); hi[] the same of the high nibbles.
// A nibble becomes the mantissa of 128 + q (bf16 0x4300 | q).
__device__ __forceinline__ void decode_word(uint32_t w, uint32_t lhi, uint32_t llo,
                                            uint32_t hhi, uint32_t hlo, uint32_t (&lo)[2],
                                            uint32_t (&hi)[2]) {
  const uint32_t w4 = w >> 4;
  lo[0] = dequant2((__byte_perm(w, 0, 0x4140) & 0x000F000Fu) | 0x43004300u, lhi, llo);
  lo[1] = dequant2((__byte_perm(w, 0, 0x4342) & 0x000F000Fu) | 0x43004300u, lhi, llo);
  hi[0] = dequant2((__byte_perm(w4, 0, 0x4140) & 0x000F000Fu) | 0x43004300u, hhi, hlo);
  hi[1] = dequant2((__byte_perm(w4, 0, 0x4342) & 0x000F000Fu) | 0x43004300u, hhi, hlo);
}

// d += a · b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copies of one stage: chunks cs .. cs + CH - 1 (32 packed bytes each) of
// every row. Thread 0 issues one tensor copy per X plane box and one per weight stream,
// counted in by `full` (the copy engine zero-fills rows past m or n and columns past
// K/2; a split ends on a stage boundary, so no stage reaches into the next split). The
// scales come by 4-byte cp.async from every thread, in its commit group of the stage,
// those of chunks at or past c_end zero-filled.
template <class C>
__device__ __forceinline__ void issue_stage(const Params& p, unsigned char* st,
                                            uint64_t* full, int cs, int c_end, int n0,
                                            int m0, int tid) {
  const int nb = p.k >> 5;
  const int c0 = cs * kChunk;
  if (tid == 0) {
    mbar_arrive_expect_tx(full, C::kTmaBytes);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane)
#pragma unroll
      for (int j = 0; j < C::kXBoxes; ++j)
        tensor_copy_3d(st + (plane * C::kXBoxes + j) * C::BN * C::kXBox, &p.xmap,
                       c0 + j * (C::kXBox / 2), plane, m0, full);
#pragma unroll
    for (int s = 0; s < C::NS; ++s)
      tensor_copy_2d(st + C::kXBytes + s * C::BW * C::kRowW, &p.wmap[s], c0, n0, full);
  }
  const int lo_end = min(cs + C::CH, c_end);  // low-plane scales needed: [cs, lo_end)
#pragma unroll
  for (int s = 0; s < C::NS; ++s) {
    uint32_t* ssm =
        reinterpret_cast<uint32_t*>(st + C::kTmaBytes) + s * C::BW * C::kSWords;
    for (int i = tid; i < C::BW * C::kSWords; i += C::kThreads) {
      const int r = i / C::kSWords, w = i % C::kSWords;
      const int row = n0 + r;
      // first f16 of the word, and the end of the halves its plane needs
      const int first = w < C::kLoWords ? cs + 2 * w
                                        : (((nb >> 1) + cs) & ~1) + 2 * (w - C::kLoWords);
      const int end = w < C::kLoWords ? lo_end : (nb >> 1) + lo_end;
      const bool ok = row < p.n && first < end;
      const __half* src =
          p.ws[s] + static_cast<size_t>(row < p.n ? row : 0) * nb + (ok ? first : 0);
      cp_async4(ssm + r * C::kSWords + w, src, ok ? 4 : 0);
    }
  }
}

// One stage's products. Thread tq of a row takes the stage row's packed bytes
// [8·CH·tq, 8·CH·(tq + 1)), all in one Q40 block (blk): word i gives the low-plane k
// step i and the high-plane step 2CH + i, and the X fragment of a step is the same 4
// consecutive k of its plane.
template <class C>
__device__ __forceinline__ void compute_stage(const unsigned char* st,
                                              float (&acc)[C::NS][C::WT][C::NT][C::KA][4],
                                              int warp_w, int warp_n, int lane, int cs,
                                              int half_nb) {
  constexpr int CH = C::CH;
  const int gid = lane >> 2, tq = lane & 3;
  const int blk = (tq * CH) >> 2;
  const int lo_i = blk;  // f16 index in the lo words (a stage starts at an even chunk)
  const int hi_i = 2 * C::kLoWords + ((half_nb + cs) & 1) + blk;
  uint32_t wv[C::NS][C::WT][2][2 * CH];  // the thread's words of rows r0, r0 + 8
  uint32_t sc[C::NS][C::WT][2][4];       // their scales: lo (hi, lo pair), hi (hi, lo)
#pragma unroll
  for (int s = 0; s < C::NS; ++s) {
    const unsigned char* wsm = st + C::kXBytes + s * C::BW * C::kRowW;
    const unsigned short* ssm = reinterpret_cast<const unsigned short*>(
        st + C::kTmaBytes + s * C::BW * C::kSWords * 4);
#pragma unroll
    for (int t = 0; t < C::WT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = C::row0(t, warp_w) + gid + 8 * h;
        // CH = 4: threads 2 and 3 take their two units in the other order (see the X
        // fragments below)
#pragma unroll
        for (int j = 0; j < CH / 2; ++j) {
          const int u = tq * (CH / 2) + (CH == 4 ? j ^ (tq >> 1) : j);
          const uint4 v = *reinterpret_cast<const uint4*>(wsm + C::swz(r, u, C::kRowW));
          wv[s][t][h][4 * j] = v.x;
          wv[s][t][h][4 * j + 1] = v.y;
          wv[s][t][h][4 * j + 2] = v.z;
          wv[s][t][h][4 * j + 3] = v.w;
        }
        const unsigned short* sr = ssm + r * 2 * C::kSWords;
        split_scale(sr[lo_i], sc[s][t][h][0], sc[s][t][h][1]);
        split_scale(sr[hi_i], sc[s][t][h][2], sc[s][t][h][3]);
      }
  }
#pragma unroll
  for (int v = 0; v < CH; ++v) {
    // A fragments of words 2v and 2v + 1: steps lo(2v), lo(2v+1), hi(2v), hi(2v+1)
    uint32_t a[C::NS][C::WT][4][4];
#pragma unroll
    for (int s = 0; s < C::NS; ++s)
#pragma unroll
      for (int t = 0; t < C::WT; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t lo[2], hi[2];
            const uint32_t(&q)[4] = sc[s][t][h];
            decode_word(wv[s][t][h][2 * v + j], q[0], q[1], q[2], q[3], lo, hi);
            // fragment regs: 0 (row gid, k j0 j1), 1 (row gid+8, j0 j1), 2 (gid, j2 j3), 3
            a[s][t][j][h] = lo[0];
            a[s][t][j][2 + h] = lo[1];
            a[s][t][2 + j][h] = hi[0];
            a[s][t][2 + j][2 + h] = hi[1];
          }
    // X fragments of the same four steps: the low-plane unit holds steps 0-1, the high
    // (CH = 4: threads 2 and 3 run their units in the order 2, 3, 0, 1, so that the four
    // threads of a row read four distinct bank groups; the k order inside an MMA step
    // may depend on tq, as both operands of a k come from threads of the same tq)
    const int u = tq * CH + (CH == 4 ? (v + 2 * (tq >> 1)) & 3 : v);
    const int box = (u * 16) / C::kXBox, ub = u % (C::kXBox / 16);
    uint4 xf[C::NT][2];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int ar = (warp_n * C::NT + nt) * 8 + gid;
      const unsigned char* xr = st + box * C::BN * C::kXBox + C::swz(ar, ub, C::kXBox);
      xf[nt][0] = *reinterpret_cast<const uint4*>(xr);
      xf[nt][1] = *reinterpret_cast<const uint4*>(xr + C::kXBoxes * C::BN * C::kXBox);
    }
    // step-major, so that neighbouring MMAs feed different accumulators
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const uint4& x = xf[nt][k >> 1];
        const uint32_t b0 = (k & 1) ? x.z : x.x, b1 = (k & 1) ? x.w : x.y;
#pragma unroll
        for (int s = 0; s < C::NS; ++s)
#pragma unroll
          for (int t = 0; t < C::WT; ++t) mma(acc[s][t][nt][k % C::KA], a[s][t][k], b0, b1);
      }
  }
}

// Warpgroup products: D (64 x N, f32, in registers: d[4j..4j+3] the n8 block j as
// mma.sync lays it out) += A (64 x 16, bf16, in registers: a warp's 16 rows as an
// mma.sync A fragment) · B, where B is N rows of 16 consecutive k of X in shared memory
// (K-major), described by `desc`.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4],
                                        uint64_t desc) {
  if constexpr (N == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

// Shared-memory matrix descriptor of K-major 128-byte rows in the copy engine's 128-byte
// swizzle (layout 1), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr >> 4) & 0x3FFF) | (1ull << 16) | (uint64_t{1024 >> 4} << 32) | (1ull << 62);
}

// One stage's warpgroup products. For each chunk, every thread decodes the A
// fragments of its two rows in natural k order (a k16 step's k 2tq, 2tq + 1, 2tq + 8,
// 2tq + 9 are packed bytes 2tq... of the step's 16: half tq % 2 of words tq / 2 and
// tq / 2 + 2), then the warpgroup issues the four k16 steps (low plane 0-15, 16-31, then
// the high plane) against the X boxes; they run while the next chunk decodes.
template <class C>
__device__ __forceinline__ void compute_stage_wg(const unsigned char* st,
                                                 float (&acc)[C::NS][C::WT][C::NT][C::KA][4],
                                                 int warp_w, int lane, int cs, int half_nb) {
  constexpr int CH = C::CH, N = C::BN;
  const int gid = lane >> 2, tq = lane & 3;
  const uint32_t sel = (tq & 1) ? 0x4342u : 0x4140u;  // bytes 2, 3 or 0, 1 of a word
  // two A buffers: chunk c + 1 decodes while the products of chunk c run
  uint32_t ab[2][C::NS][C::WT][4][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    uint32_t(&a)[C::NS][C::WT][4][4] = ab[c & 1];
    const int lo_i = c;  // f16 index in the lo words (a stage starts at an even chunk)
    const int hi_i = 2 * C::kLoWords + ((half_nb + cs) & 1) + c;
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      const unsigned char* wsm = st + C::kXBytes + s * C::BW * C::kRowW;
      const unsigned short* ssm = reinterpret_cast<const unsigned short*>(
          st + C::kTmaBytes + s * C::BW * C::kSWords * 4);
#pragma unroll
      for (int t = 0; t < C::WT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = C::row0(t, warp_w) + gid + 8 * h;
          const unsigned short* sr = ssm + r * 2 * C::kSWords;
          uint32_t lhi, llo, hhi, hlo;
          split_scale(sr[lo_i], lhi, llo);
          split_scale(sr[hi_i], hhi, hlo);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int byte = 32 * c + 4 * (tq >> 1) + 8 * i;
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                wsm + C::swz(r, byte >> 4, C::kRowW) + (byte & 15));
            const uint32_t lo = (__byte_perm(w, 0, sel) & 0x000F000Fu) | 0x43004300u;
            const uint32_t hi = (__byte_perm(w >> 4, 0, sel) & 0x000F000Fu) | 0x43004300u;
            // word i: k16 step i / 2 of its plane, register h (k 2tq..) or 2 + h (2tq + 8..)
            a[s][t][i >> 1][h + 2 * (i & 1)] = dequant2(lo, lhi, llo);
            a[s][t][2 + (i >> 1)][h + 2 * (i & 1)] = dequant2(hi, hhi, hlo);
          }
        }
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int off = 64 * c + 32 * (k & 1);  // bytes into the plane's stage row
      const uint64_t desc = kmajor_desc(
          st + ((k >> 1) * C::kXBoxes + off / C::kXBox) * C::BN * C::kXBox + off % C::kXBox);
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
#pragma unroll
        for (int t = 0; t < C::WT; ++t)
          wgmma_n<N>(reinterpret_cast<float(&)[N / 2]>(acc[s][t]), a[s][t][k], desc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of chunk c - 1 are done: its buffer is free
  }
  wgmma_wait<0>();  // the stage's slot is read by nothing once the block barrier frees it
}

template <class C>
__device__ __forceinline__ void store_out(const Params& p, size_t o, float v) {
  if (p.res_kind == 1) v += static_cast<const float*>(p.res)[o];
  else if (p.res_kind == 2) v += __bfloat162float(static_cast<const __nv_bfloat16*>(p.res)[o]);
  if (p.out_kind == 0) static_cast<float*>(p.y)[o] = v;
  else static_cast<__nv_bfloat16*>(p.y)[o] = __float2bfloat16_rn(v);
}

template <class C>
__device__ __forceinline__ void run(const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kMain);
  int& s_last = *reinterpret_cast<int*>(smem + C::kMain + 8 * C::STAGES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_w = warp % C::WW, warp_n = warp / C::WW;
  const int gid = lane >> 2, tq = lane & 3;
  const int chunks = (p.k >> 1) / kChunk;
  const int half_nb = p.k >> 6;
  const int tiles_m = (p.m + C::BN - 1) / C::BN;
  const int tiles = (p.n + C::BW - 1) / C::BW * tiles_m;
  const int items = tiles * p.splits;
  if (smem_addr(smem) & 1023u) __trap();  // the swizzle needs the ring on 1024 bytes
  if (tid == 0) {
    prefetch_tensormap(&p.xmap);
#pragma unroll
    for (int s = 0; s < C::NS; ++s) prefetch_tensormap(&p.wmap[s]);
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int g0 = 0;  // ring stages this block has used
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / p.splits, z = item - tile * p.splits;
    const int n0 = tile / tiles_m * C::BW, m0 = tile % tiles_m * C::BN;
    const int c_begin = z * p.per_split;  // a multiple of CH
    const int c_end = min(chunks, c_begin + p.per_split);
    const int ns = (c_end - c_begin + C::CH - 1) / C::CH;
    float acc[C::NS][C::WT][C::NT][C::KA][4];
#pragma unroll
    for (int s = 0; s < C::NS; ++s)
#pragma unroll
      for (int t = 0; t < C::WT; ++t)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int c = 0; c < C::KA; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[s][t][nt][c][i] = 0.0f;

    // stage i of this item is stage g0 + i of the block: ring slot (g0 + i) % STAGES,
    // whose `full` barrier completes its phase (g0 + i) / STAGES when the tensor
    // copies landed
    auto slot = [&](int i) { return (g0 + i) % C::STAGES; };
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
      if (s < ns)
        issue_stage<C>(p, smem + slot(s) * C::kStageBytes, &full[slot(s)],
                       c_begin + s * C::CH, c_end, n0, m0, tid);
      cp_async_commit();
    }
    for (int it = 0; it < ns; ++it) {
      cp_async_wait<C::STAGES - 2>();
      mbar_wait(&full[slot(it)], ((g0 + it) / C::STAGES) & 1);
      __syncthreads();  // stage it landed for every thread; stage it - 1 is free
      const int nx = it + C::STAGES - 1;
      if (nx < ns)
        issue_stage<C>(p, smem + slot(nx) * C::kStageBytes, &full[slot(nx)],
                       c_begin + nx * C::CH, c_end, n0, m0, tid);
      cp_async_commit();
      if constexpr (C::WG)
        compute_stage_wg<C>(smem + slot(it) * C::kStageBytes, acc, warp_w, lane,
                            c_begin + it * C::CH, half_nb);
      else
        compute_stage<C>(smem + slot(it) * C::kStageBytes, acc, warp_w, warp_n, lane,
                         c_begin + it * C::CH, half_nb);
    }
    g0 += ns;
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: it stages the output below
#pragma unroll
    for (int s = 0; s < C::NS; ++s)
#pragma unroll
      for (int t = 0; t < C::WT; ++t)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int c = 1; c < C::KA; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[s][t][nt][0][i] += acc[s][t][nt][c][i];

    if (p.splits > 1) {
      // fragments in thread order: [tile][split][frag][thread] float4
      float4* base = reinterpret_cast<float4*>(p.part) +
                     static_cast<size_t>(tile) * p.splits * C::kFrags * C::kThreads;
      float4* mine = base + static_cast<size_t>(z) * C::kFrags * C::kThreads;
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
#pragma unroll
        for (int t = 0; t < C::WT; ++t)
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt) {
            const int f = (s * C::WT + t) * C::NT + nt;
            const float* v = acc[s][t][nt][0];
            __stcg(mine + f * C::kThreads + tid, make_float4(v[0], v[1], v[2], v[3]));
          }
      // every thread's fragments, then thread 0's release of the tile's counter; the
      // last block's acquire sees every split's fragments
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int prev;
        asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                     : "=r"(prev)
                     : "l"(p.counters + tile)
                     : "memory");
        s_last = prev == p.splits - 1;
      }
      __syncthreads();
      if (!s_last) continue;
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
#pragma unroll
        for (int t = 0; t < C::WT; ++t)
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt) {
            const int f = (s * C::WT + t) * C::NT + nt;
            float4 sum = __ldcg(base + f * C::kThreads + tid);
            for (int zz = 1; zz < p.splits; ++zz) {
              const float4 v =
                  __ldcg(base + (static_cast<size_t>(zz) * C::kFrags + f) * C::kThreads + tid);
              sum.x += v.x;
              sum.y += v.y;
              sum.z += v.z;
              sum.w += v.w;
            }
            acc[s][t][nt][0][0] = sum.x;
            acc[s][t][nt][0][1] = sum.y;
            acc[s][t][nt][0][2] = sum.z;
            acc[s][t][nt][0][3] = sum.w;
          }
      if (tid == 0) p.counters[tile] = 0;
    }

    // stage the tile as [activation row][weight row] f32, then write it coalesced
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int t = 0; t < C::WT; ++t)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int nl = C::row0(t, warp_w) + gid;
        const int ml = (warp_n * C::NT + nt) * 8 + 2 * tq;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = C::NS == 2 ? act_f32(acc[0][t][nt][0][i], p.act) * acc[C::NS - 1][t][nt][0][i]
                            : acc[0][t][nt][0][i];
        cs[ml * C::kLdc + nl] = v[0];
        cs[(ml + 1) * C::kLdc + nl] = v[1];
        cs[ml * C::kLdc + nl + 8] = v[2];
        cs[(ml + 1) * C::kLdc + nl + 8] = v[3];
      }
    __syncthreads();
    for (int i = tid; i < C::BN * C::BW; i += C::kThreads) {
      const int ml = i / C::BW, nl = i % C::BW;
      if (m0 + ml < p.m && n0 + nl < p.n)
        store_out<C>(p, static_cast<size_t>(m0 + ml) * p.n + n0 + nl, cs[ml * C::kLdc + nl]);
    }
    fence_proxy_async();  // the staging stores before the next item's tensor copies
    __syncthreads();      // the next item refills the ring
  }
}

// The driver's tensor-map encoder, found once through the runtime (no link to libcuda).
inline PFN_cuTensorMapEncodeTiled encoder() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f,
                                                           12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor maps of one call: x as (m rows, 2 planes, k/2) bf16 in boxes of one plane
// row of kXBox bytes by BN rows; each stream as (n rows, k/2) u8 in boxes of kRowW bytes
// by BW rows; swizzled as compute_stage reads them.
template <class C>
cudaError_t encode_maps(Params& p) {
  const PFN_cuTensorMapEncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t kh = static_cast<cuuint64_t>(p.k) / 2;
  const cuuint64_t xdims[3] = {kh, 2, static_cast<cuuint64_t>(p.m)};
  const cuuint64_t xstrides[2] = {kh * 2, static_cast<cuuint64_t>(p.k) * 2};
  const cuuint32_t xbox[3] = {C::kXBox / 2, 1, C::BN};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (enc(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(p.x),
          xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdims[2] = {kh, static_cast<cuuint64_t>(p.n)};
  const cuuint64_t wstrides[1] = {kh};
  const cuuint32_t wbox[2] = {C::kRowW, C::BW};
  const CUtensorMapSwizzle wswz =
      C::kRowW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  for (int s = 0; s < C::NS; ++s)
    if (enc(&p.wmap[s], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(p.wp[s]), wdims,
            wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, wswz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Let a kernel take its dynamic shared memory, once per kernel.
template <class C, class K>
cudaError_t configure(K* kernel) {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  return e;
}

template <class C, class K>
int launch(K* kernel, Params p, int grid, cudaStream_t st) {
  cudaError_t e = configure<C>(kernel);
  if (e == cudaSuccess) e = encode_maps<C>(p);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one configuration the card holds on an SM at once, or -1.
template <class C, class K>
int blocks_per_sm(K* kernel) {
  int n = 0;
  if (configure<C>(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::kThreads, C::kSmem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace q4mm
