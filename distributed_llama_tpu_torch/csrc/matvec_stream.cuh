// matvec_stream.cuh: the block body shared by q4_matvec.cu (Q40 weights in the i4p
// split-plane layout) and q8_matvec.cu (int8 planes): y = W·x for one activation row,
// the decode matvec. The two formats differ only in the dot of a 32-byte weight chunk
// (nibbles against two int8 planes of the row, or int8 against one) and in the scale
// type (f16 or f32); the row arrives as floats to quantize (kQuantize), already
// quantized (kPrequantized) or as floats kept in f32 (kPrecise, i8 only).
//
// What it computes, the function of the TPU kernels: per 32-block b of the row,
//   xq[j] = round_half_even(x[j] * (127 / absmax_b)), sx[b] = absmax_b / 127 (true divisions)
//   P[n,b] = sum_{j in b} W[n,j] * xq[j]   (int32, exact; i4p: (q - 8)·xq through the
//                                            block sums of xq)
//   y[n]   = sum_b (s[n,b] * sx[b]) * P[n,b]   (f32), written as f32 or bf16 (rounded once)
// and for kPrecise P[n,b] = sum_{j in b} W[n,j] * x[j] in f32 and sx = 1. Only the order
// of the f32 sums differs from the plain versions; it is fixed, so a call repeats bit
// for bit.
//
// What bounds it on an H100: bytes. Every weight byte is read once per call (0.5625 B
// per weight for i4p, 1.125 for i8, scales included) for ~2 integer ops per weight.
//
// What the design does about it:
// - Work: one wave of blocks (the kernel's own occupancy query), block b owning rows
//   [b·N/G, (b+1)·N/G). Their packed bytes are one contiguous span (rows are K/2 or K
//   bytes apart, 32-byte aligned).
// - Weights: the span streams through a ring of `stages` slots, each `rs` whole rows,
//   one cp.async.bulk per slot counted in by the slot's mbarrier; their scales (a row's
//   are K/16 or K/8 bytes: 4-byte, not 16-byte, aligned) come by 4-byte cp.async from
//   every thread, tracked by the same mbarrier (cp.async.mbarrier.arrive.noinc). A slot
//   refills as soon as the block has left it. ops/mv_plan.py sizes the ring: one row
//   per warp group in a slot of up to 32 KB (more rows of short rows, up to 16 KB), at
//   least 3 slots and about 64 KB, so each block keeps at least 44,032 bytes of weights
//   requested at the Llama-2-7B shapes, two blocks per SM.
// - The row: its loads are issued first (every thread's 16-byte loads before any is
//   used), then the first slot, then the row is quantized (each 32-block reduced across
//   the lanes holding it) or copied, then the other slots: row loads issued behind the
//   whole ring wait for the megabytes of weights ahead of them in the memory system.
// - Experts (the q4/q8 expert entries, float row only): the weights are one layer's
//   stack of the n_local matrices a rank owns, experts [e_lo, e_lo + n_local) (all E
//   of them on one card: the window (0, E)), and a one-element index in device memory,
//   written by the router's top-k just ahead in the stream, says which expert. Every
//   block loads the index first and offsets its weight and scale bases by
//   (e - e_lo)·n rows before its first bulk copy: one dependent load ahead of the ring,
//   and no copy of the expert, no host read of the index, so a captured step replays
//   with the index the router writes that step (the JAX package's dynamic_slice_in_dim
//   on the stack). An index outside the window (an expert another rank owns, under
//   expert parallelism) makes each block write zeros to its rows and return before it
//   reads a weight or scale byte: the JAX package's lax.cond(owner, compute, zeros),
//   at the cost of a launch and the index read. One block of a launch that computes adds
//   one to a device counter (`owned`), so a run can count the owners' computes without
//   reading an index on the host.
// - The pre-quantized row comes from the fused prologue (csrc/prologue.cu), the kernel
//   just ahead in the stream. That entry is launched with programmatic stream
//   serialization (PDL): its blocks are scheduled as soon as the prologue has started,
//   issue the first `pre` slots of their weights (never all of a block's slots: a row
//   load queued behind a block's whole share of weights holds up its dots, as above),
//   run griddepcontrol.wait (which returns once the prologue's grid has finished and
//   its writes are visible), and only then load the row (from L2, where the prologue
//   just wrote it) and issue the rest. So the launch overlaps the prologue, and the
//   weights stream during whatever of it is left (on an H100 a lone prologue of
//   1.4-2.2 us has written its row before the blocks reach their row loads).
//   THE RULE: before griddepcontrol.wait a block reads nothing that another kernel
//   writes (only the static weights and their scales) and writes no global memory. The
//   caching allocator reuses freed blocks in stream order, so this kernel's output can
//   lie in a buffer the prologue (or the kernel before it) is still reading.
// - Lanes own columns: a row is shared by `gw` warps (one where a slot holds 8 rows),
//   and lane l of them takes the row's 32-byte chunks l, l + 32·gw, ... (one quant block
//   of each plane for i4p, one block for i8) of every row it works on. So its part of
//   the row (xq words with the blocks' sx and 8·sum(xq), or the precise row in f32) is
//   loaded into registers once (the precise row is widened to f32 in ring slots not
//   yet issued, on its way there), and a row costs two 16-byte shared-memory loads and
//   the scales per chunk. Lanes 4-7 of each 8 read the second half of their chunk first, so
//   a warp's loads hit distinct banks.
// - Math: low nibbles against xq by signed __dp4a, high nibbles in place (16·q) by the
//   unsigned-by-signed dp4a, shifted back once; int8 by signed __dp4a; the precise body
//   builds each f32 weight in the mantissa of 2^23 (a byte permute and one subtraction,
//   no int-to-float conversion). Warp shuffles, then (gw > 1) the warps' partials in
//   warp order, finish each row; it is written in the caller's dtype.
//
// Shared memory (bytes, each region on 128): the weight ring, the scale ring, the row
// (xq, sx, block sums; none for the precise row), the partials of two slots (gw > 1),
// the mbarriers. ops/mv_plan.py's `layout` computes the same figures.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace mvs {

using namespace acopy;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // what a block may take on an H100 (227 KB)
constexpr int kLoads = 8;         // 16-byte row loads in flight per thread

enum Fmt { kI4p = 0, kI8 = 1 };
enum Mode { kQuantize = 0, kPrequantized = 1, kPrecise = 2 };

struct Params {
  const void* x;       // (k,) f32 or bf16 row, 16-byte aligned (kQuantize, kPrecise)
  const int8_t* xq;    // (k,) int8 row, 16-byte aligned (kPrequantized)
  const float* sx;     // (k/32,) f32 block scales of xq (kPrequantized)
  const uint8_t* w;    // (n, row bytes) packed rows, 16-byte aligned
  const void* s;       // (n, k/32) scales: f16 (i4p) or f32 (i8), 4-byte aligned
  void* y;             // (n,) f32 or bf16 (out_bf16)
  int n, k, out_bf16;
  int rs, stages, gw;  // rows per slot, slots, warps per row
  int pre;             // slots issued before griddepcontrol.wait (kPrequantized)
  // the expert entries: w and s hold a stack of n_local (n, k) matrices, experts
  // [e_lo, e_lo + n_local) of the layer (the owner window), and the kernel reads which
  // expert from *e, in device memory; a launch that computes adds one to *owned
  const long long* e;
  int e_lo, n_local;
  int* owned;
};

inline Params make_params(const void* x, const void* xq, const void* sx, const void* w,
                          const void* s, void* y, int out_bf16, int n, int k, int rs,
                          int stages, int gw, int pre = 0) {
  Params p{};
  p.x = x;
  p.xq = static_cast<const int8_t*>(xq);
  p.sx = static_cast<const float*>(sx);
  p.w = static_cast<const uint8_t*>(w);
  p.s = s;
  p.y = y;
  p.n = n;
  p.k = k;
  p.out_bf16 = out_bf16;
  p.rs = rs;
  p.stages = stages;
  p.gw = gw;
  p.pre = pre;
  p.e = nullptr;
  p.e_lo = 0;
  p.n_local = 0;
  p.owned = nullptr;
  return p;
}

struct Layout {
  int stage, sstage;           // bytes of one weight slot and one scale slot
  int ring, sring, xq, sx, ssum, red, bars, total;  // offsets, and the total
};

__host__ __device__ constexpr int up128(int b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline Layout layout(int fmt, int mode, int k, int rs, int stages,
                                         int gw) {
  Layout l{};
  const int nb = k / 32;
  l.stage = up128(rs * (fmt == kI4p ? k / 2 : k));
  l.sstage = up128(rs * nb * (fmt == kI4p ? 2 : 4));
  l.ring = 0;
  l.sring = l.ring + stages * l.stage;
  l.xq = l.sring + stages * l.sstage;
  if (mode == kPrecise) {  // the f32 row passes through the ring into registers
    l.sx = l.ssum = l.red = l.xq;
  } else {
    l.sx = l.xq + up128(k);
    l.ssum = l.sx + up128(4 * nb);
    l.red = l.ssum + (fmt == kI4p ? up128(4 * nb) : 0);
  }
  l.bars = l.red + up128(2 * rs * gw * 4);
  l.total = l.bars + 8 * stages;
  return l;
}

__device__ __forceinline__ uint4 ld_nc(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// wait until the grid ahead in the stream has finished and its writes are visible
// (returns at once when the launch was not programmatic)
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the row
// ---------------------------------------------------------------------------

// Round r of a row of `pieces` 16-byte pieces: piece r·kLoads·kThreads + i·kThreads + tid
// into v[i], every load issued before any is used. Round 0 is loaded before the weight
// stream starts: behind it, the row's loads would wait for megabytes of weights. kCg:
// load through L2 only (the pre-quantized row, which the prologue writes while this
// kernel already runs: not read-only for this kernel's lifetime, as ld.global.nc needs).
template <bool kCg = false>
__device__ __forceinline__ void load_round(const void* src, int pieces, int r,
                                           uint4 (&v)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int pc = (r * kLoads + i) * kThreads + threadIdx.x;
    const char* at = static_cast<const char*>(src) + 16 * static_cast<size_t>(pc);
    v[i] = pc >= pieces ? make_uint4(0, 0, 0, 0)
           : kCg        ? __ldcg(reinterpret_cast<const uint4*>(at))
                        : ld_nc(at);
  }
}

// Q80 of the float row into xq / sx (and the block sums of xq for i4p); v0: round 0 of
// its pieces. The lanes holding one 32-block (8 pieces of f32, 4 of bf16) reduce it
// together.
template <bool kI4, bool kXB>
__device__ void quantize_row(const void* x, int k, const uint4 (&v0)[kLoads], int8_t* xq,
                             float* sx, int* ssum) {
  constexpr int kVals = kXB ? 8 : 4;   // values per piece
  constexpr int kLanes = 32 / kVals;   // lanes per block
  const int pieces = k / kVals;
  for (int r = 0; r * kLoads * kThreads < pieces; ++r) {
    uint4 v[kLoads];
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) v[i] = v0[i];
    } else {
      load_round(x, pieces, r, v);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int pc0 = (r * kLoads + i) * kThreads;
      if (pc0 >= pieces) break;  // block-uniform
      const int pc = pc0 + threadIdx.x;
      float f[kVals];
      const unsigned u[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kXB) {
          f[2 * j] = __uint_as_float(u[j] << 16);
          f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
        } else {
          f[j] = __uint_as_float(u[j]);
        }
      }
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kVals; ++j) a = fmaxf(a, fabsf(f[j]));
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
      const float inv = a > 0.f ? 127.0f / a : 0.f;
      int s = 0;
      unsigned packed[kVals / 4];
#pragma unroll
      for (int j = 0; j < kVals / 4; ++j) {
        unsigned word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int q = __float2int_rn(f[4 * j + b] * inv);
          s += q;
          word |= (static_cast<unsigned>(q) & 0xffu) << (8 * b);
        }
        packed[j] = word;
      }
      if constexpr (kI4) {
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      }
      if (pc < pieces) {
        if constexpr (kXB)
          reinterpret_cast<uint2*>(xq)[pc] = make_uint2(packed[0], packed[1]);
        else
          reinterpret_cast<unsigned*>(xq)[pc] = packed[0];
        if ((threadIdx.x & (kLanes - 1)) == 0) {
          sx[pc / kLanes] = a / 127.0f;
          if constexpr (kI4) ssum[pc / kLanes] = s;
        }
      }
    }
  }
}

// A pre-quantized row: xq (v0: round 0 of its 16-byte pieces) and, for i4p, each block's
// sum of xq (two pieces per block, summed by the lane pair); sx0: sx[tid], loaded with v0.
template <bool kI4>
__device__ void copy_row(const int8_t* xq_in, const float* sx_in, int k,
                         const uint4 (&v0)[kLoads], float sx0, int8_t* xq, float* sx,
                         int* ssum) {
  const int pieces = k / 16;
  for (int r = 0; r * kLoads * kThreads < pieces; ++r) {
    uint4 v[kLoads];
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) v[i] = v0[i];
    } else {
      load_round<true>(xq_in, pieces, r, v);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int pc0 = (r * kLoads + i) * kThreads;
      if (pc0 >= pieces) break;  // block-uniform
      const int pc = pc0 + threadIdx.x;
      if constexpr (kI4) {
        int s = __dp4a(static_cast<int>(v[i].x), 0x01010101, 0);
        s = __dp4a(static_cast<int>(v[i].y), 0x01010101, s);
        s = __dp4a(static_cast<int>(v[i].z), 0x01010101, s);
        s = __dp4a(static_cast<int>(v[i].w), 0x01010101, s);
        s += __shfl_xor_sync(kFull, s, 1);
        if (pc < pieces && (pc & 1) == 0) ssum[pc / 2] = s;
      }
      if (pc < pieces) reinterpret_cast<uint4*>(xq)[pc] = v[i];
    }
  }
  if (threadIdx.x < k / 32) sx[threadIdx.x] = sx0;
  for (int b = threadIdx.x + kThreads; b < k / 32; b += kThreads) sx[b] = __ldcg(sx_in + b);
}

// The precise row (v0: round 0 of its 16-byte pieces) widened to f32 in shared memory:
// float4 q (of 8) of 32-block c at float4 8c + (q ^ c % 8), so lanes on neighbouring
// blocks that read the same q hit distinct banks.
template <bool kXB>
__device__ void widen_row(const void* x, int k, const uint4 (&v0)[kLoads], float4* x4) {
  constexpr int kVals = kXB ? 8 : 4;
  const int pieces = k / kVals;
  for (int r = 0; r * kLoads * kThreads < pieces; ++r) {
    uint4 v[kLoads];
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) v[i] = v0[i];
    } else {
      load_round(x, pieces, r, v);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int pc = (r * kLoads + i) * kThreads + threadIdx.x;
      if (pc >= pieces) break;
      const int f4 = pc * (kVals / 4);  // the piece's first float4, in row order
      const int c = f4 / 8;
      if constexpr (kXB) {
        x4[8 * c + ((f4 % 8) ^ (c & 7))] =
            make_float4(__uint_as_float(v[i].x << 16), __uint_as_float(v[i].x & 0xffff0000u),
                        __uint_as_float(v[i].y << 16), __uint_as_float(v[i].y & 0xffff0000u));
        x4[8 * c + ((f4 % 8 + 1) ^ (c & 7))] =
            make_float4(__uint_as_float(v[i].z << 16), __uint_as_float(v[i].z & 0xffff0000u),
                        __uint_as_float(v[i].w << 16), __uint_as_float(v[i].w & 0xffff0000u));
      } else {
        x4[8 * c + ((f4 % 8) ^ (c & 7))] =
            make_float4(__uint_as_float(v[i].x), __uint_as_float(v[i].y),
                        __uint_as_float(v[i].z), __uint_as_float(v[i].w));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

// 8 words of a 32-byte chunk as this lane holds them: the 16-byte half h0 first
__device__ __forceinline__ void load_chunk(const unsigned char* c32, int h0, unsigned w[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(c32 + 16 * h0);
  const uint4 b = *reinterpret_cast<const uint4*>(c32 + 16 * (1 - h0));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// int8 byte j of (word ^ 0x80808080) as f32, exactly: 2^23 + (b + 128) built in the
// mantissa, minus 2^23 + 128 (no int-to-float conversion, which runs at a quarter rate)
__device__ __forceinline__ float byte_f32(unsigned biased, int j) {
  return __int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u, 0x7540 + j))) -
         8388736.0f;
}

__device__ __forceinline__ void store_y(void* y, int out_bf16, size_t row, float v) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(y)[row] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[row] = v;
}

// the dot of 4 unsigned bytes of a with 4 signed bytes of b, plus c
__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// CPL: chunks of a row per lane, at most (cpl_of below)
template <int FMT, int MODE, bool kXB, int CPL>
__device__ void run(const Params& p) {
  static_assert(FMT == kI8 || MODE != kPrecise, "the precise row is an i8 mode");
  constexpr bool kI4 = FMT == kI4p;
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = p.k, nb = k / 32;
  const int rb = kI4 ? k / 2 : k;          // packed bytes of a row
  const int cpr = rb / 32;                 // 32-byte chunks of a row
  const int srow = kI4 ? nb * 2 : nb * 4;  // scale bytes of a row
  const Layout L = layout(FMT, MODE, k, p.rs, p.stages, p.gw);
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * p.n / gridDim.x);
  const int r1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.n / gridDim.x);
  const int nrows = r1 - r0;
  if (nrows <= 0) return;
  const int nst = (nrows + p.rs - 1) / p.rs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = kWarps / p.gw;  // rows of a slot in flight at once
  const int grp = warp / p.gw, wig = warp % p.gw;
  const int gl = wig * 32 + lane, lanes = 32 * p.gw;  // lane within the row's warps
  // which 16-byte half of a chunk the lane reads first: lanes 4-7 of each 8 start on
  // the other half, so the 8 lanes of a shared-memory phase hit distinct banks
  const int h0 = (lane >> 2) & 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  // the expert entries: an index inside the owner window picks local matrix e - e_lo;
  // one outside it writes zeros to the block's rows and reads no weight or scale byte
  // (the same index in every thread, so the whole block leaves before any barrier)
  const uint8_t* wbase = p.w;
  const char* sbase = static_cast<const char*>(p.s);
  if (p.e != nullptr) {
    const long long e = *p.e - p.e_lo;
    if (e < 0 || e >= p.n_local) {
      for (int i = threadIdx.x; i < nrows; i += kThreads)
        store_y(p.y, p.out_bf16, static_cast<size_t>(r0) + i, 0.f);
      return;
    }
    // the last block always has rows (r1 = n): it counts the launch
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0 && p.owned != nullptr)
      atomicAdd(p.owned, 1);
    wbase += e * p.n * static_cast<long long>(rb);
    sbase += e * p.n * static_cast<long long>(srow);
  }

  if (tid == 0) {
    // per slot and use: thread 0's arrival with the bulk bytes, and every thread's
    // arrival on its scale copies
    for (int i = 0; i < p.stages; ++i) mbar_init(&bars[i], kThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {
    const int slot = j % p.stages;
    const int rows = min(p.rs, nrows - j * p.rs);
    const size_t row0 = static_cast<size_t>(r0) + static_cast<size_t>(j) * p.rs;
    if (tid == 0) {
      mbar_arrive_expect_tx(&bars[slot], rows * rb);
      bulk_copy(smem + L.ring + slot * L.stage, wbase + row0 * rb, rows * rb, &bars[slot]);
    }
    const char* src = sbase + row0 * srow;
    unsigned char* dst = smem + L.sring + slot * L.sstage;
    for (int i = tid; i < rows * srow / 4; i += kThreads)
      cp_async4(dst + 4 * i, src + 4 * i, 4);
    cp_async_mbar_arrive(&bars[slot]);
  };

  // The row's loads come first: behind the weight stream they would wait for megabytes
  // of weights. Then the first slot, the row's staging, and the other slots, so the
  // first slot is ahead of the rest in the memory system. The pre-quantized entry
  // (PDL) first issues `pre` slots of static weights, which need not wait for the
  // prologue, and loads the row after griddepcontrol.wait (the rule in the header).
  // The lane's part of the row stays in registers for every row it takes: chunks
  // c = gl + m·lanes; the precise row as f32 in natural order, the others as their xq
  // words (in the lane's half order) with the blocks' scales and offsets.
  float xp[MODE == kPrecise ? CPL : 1][32];
  uint4 v0[kLoads];
  const void* src = MODE == kPrequantized ? static_cast<const void*>(p.xq) : p.x;
  const int pieces = MODE == kPrequantized ? k / 16 : k / (kXB ? 8 : 4);
  int issued = 0;  // slots issued so far
  if constexpr (MODE == kPrequantized) {
    const int pre = max(1, min(p.pre, nst - 1));
    for (; issued < pre; ++issued) issue(issued);
    wait_for_predecessor();
  }
  load_round<MODE == kPrequantized>(src, pieces, 0, v0);
  const float sx0 = MODE == kPrequantized && tid < nb ? __ldcg(p.sx + tid) : 0.f;
  if (issued == 0) issue(issued++);

  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  float* sx = reinterpret_cast<float*>(smem + L.sx);
  int* ssum = reinterpret_cast<int*>(smem + L.ssum);
  if constexpr (MODE == kQuantize) quantize_row<kI4, kXB>(p.x, k, v0, xq, sx, ssum);
  if constexpr (MODE == kPrequantized) copy_row<kI4>(p.xq, p.sx, k, v0, sx0, xq, sx, ssum);
  if constexpr (MODE == kPrecise) {
    // the f32 row passes through slots 1.. of the ring, not yet issued, on its way to
    // the lanes' registers
    float4* x4 = reinterpret_cast<float4*>(smem + L.ring + L.stage);
    widen_row<kXB>(p.x, k, v0, x4);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int c = min(gl + m * lanes, cpr - 1);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = x4[8 * c + (q ^ (c & 7))];
        xp[m][4 * q] = v.x;
        xp[m][4 * q + 1] = v.y;
        xp[m][4 * q + 2] = v.z;
        xp[m][4 * q + 3] = v.w;
      }
    }
    fence_proxy_async();  // these reads before the copies that refill the slots
    __syncthreads();
  }
  for (; issued < min(p.stages, nst); ++issued) issue(issued);
  __syncthreads();

  unsigned xr[MODE == kPrecise ? 1 : CPL][8], xr2[kI4 ? CPL : 1][8];
  float sa[MODE == kPrecise ? 1 : CPL], sb[kI4 ? CPL : 1];
  int oa[kI4 ? CPL : 1], ob[kI4 ? CPL : 1];
  if constexpr (MODE != kPrecise) {
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int c = min(gl + m * lanes, cpr - 1);
      load_chunk(reinterpret_cast<const unsigned char*>(xq) + 32 * c, h0, xr[m]);
      sa[m] = sx[c];
      if constexpr (kI4) {
        load_chunk(reinterpret_cast<const unsigned char*>(xq) + rb + 32 * c, h0, xr2[m]);
        sb[m] = sx[c + nb / 2];
        oa[m] = 8 * ssum[c];
        ob[m] = 8 * ssum[c + nb / 2];
      }
    }
  }

  float* red = reinterpret_cast<float*>(smem + L.red);
  // the f32 sums of slot j's rows where gw warps share a row: each warp's partial, then
  // (after the next block barrier) their sum in warp order
  auto finish = [&](int j) {
    const int rows = min(p.rs, nrows - j * p.rs);
    for (int i = tid; i < rows; i += kThreads) {
      const float* part = red + ((j & 1) * p.rs + i) * p.gw;
      float v = part[0];
      for (int q = 1; q < p.gw; ++q) v += part[q];
      store_y(p.y, p.out_bf16, static_cast<size_t>(r0) + static_cast<size_t>(j) * p.rs + i,
              v);
    }
  };

  for (int j = 0; j < nst; ++j) {
    const int slot = j % p.stages;
    mbar_wait(&bars[slot], (j / p.stages) & 1);
    __syncthreads();  // every thread is done with slot j - 1: it may refill
    if (j > 0) {
      if (p.gw > 1) finish(j - 1);
      if (j - 1 + p.stages < nst) issue(j - 1 + p.stages);
    }
    const int rows = min(p.rs, nrows - j * p.rs);
    const unsigned char* wst = smem + L.ring + slot * L.stage;
    const unsigned char* sst = smem + L.sring + slot * L.sstage;
    for (int i = grp; i < rows; i += groups) {
      const unsigned char* wr = wst + i * rb;
      float acc = 0.f;
      unsigned w[CPL][8];
      float s1[CPL], s2[kI4 ? CPL : 1];
#pragma unroll
      for (int m = 0; m < CPL; ++m) {  // every load of the row before any math
        const int c = min(gl + m * lanes, cpr - 1);
        load_chunk(wr + 32 * c, h0, w[m]);
        if constexpr (kI4) {
          const __half* sr = reinterpret_cast<const __half*>(sst + i * srow);
          s1[m] = __half2float(sr[c]);
          s2[m] = __half2float(sr[c + nb / 2]);
        } else {
          s1[m] = reinterpret_cast<const float*>(sst + i * srow)[c];
        }
      }
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        if (gl + m * lanes >= cpr) break;
        if constexpr (MODE == kPrecise) {
          float pv = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // word e of the chunk in natural order: the lane holds half h0 first
            const unsigned u = (h0 ? w[m][e ^ 4] : w[m][e]) ^ 0x80808080u;
            pv = fmaf(byte_f32(u, 0), xp[m][4 * e], pv);
            pv = fmaf(byte_f32(u, 1), xp[m][4 * e + 1], pv);
            pv = fmaf(byte_f32(u, 2), xp[m][4 * e + 2], pv);
            pv = fmaf(byte_f32(u, 3), xp[m][4 * e + 3], pv);
          }
          acc += s1[m] * pv;
        } else if constexpr (kI4) {
          // low nibbles as signed bytes; high nibbles in place (16·q) as unsigned bytes
          int plo = 0, phi = 0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            plo = __dp4a(static_cast<int>(w[m][e] & 0x0F0F0F0Fu), static_cast<int>(xr[m][e]),
                         plo);
            phi = dp4a_us(w[m][e] & 0xF0F0F0F0u, static_cast<int>(xr2[m][e]), phi);
          }
          acc += (s1[m] * sa[m]) * static_cast<float>(plo - oa[m]);
          acc += (s2[m] * sb[m]) * static_cast<float>((phi >> 4) - ob[m]);
        } else {
          int pv = 0;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            pv = __dp4a(static_cast<int>(w[m][e]), static_cast<int>(xr[m][e]), pv);
          acc += (s1[m] * sa[m]) * static_cast<float>(pv);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) {
        if (p.gw == 1)
          store_y(p.y, p.out_bf16, static_cast<size_t>(r0) + static_cast<size_t>(j) * p.rs + i,
                  acc);
        else
          red[((j & 1) * p.rs + i) * p.gw + wig] = acc;
      }
    }
  }
  if (p.gw > 1) {
    __syncthreads();
    finish(nst - 1);
  }
}

// chunks of a row per lane: the row's 32-byte chunks over the lanes of its gw warps
__host__ __device__ constexpr int cpl_of(int fmt, int k, int gw) {
  return ((fmt == kI4p ? k / 64 : k / 32) + 32 * gw - 1) / (32 * gw);
}

// Let a kernel take up to kMaxSmem of dynamic shared memory, once per kernel.
template <auto kKernel>
cudaError_t configure() {
  static const cudaError_t e =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return e;
}

// kPdl: launch with programmatic stream serialization (the pre-quantized entry); a
// launch the card refuses returns its error, never a launch without the attribute
template <auto kKernel, bool kPdl>
int launch_one(const Params& p, int smem, int grid, cudaStream_t st) {
  const cudaError_t e = configure<kKernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kPdl) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t le = cudaLaunchKernelEx(&cfg, kKernel, p);
    if (le != cudaSuccess) return static_cast<int>(le);
  } else {
    kKernel<<<grid, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <auto kKernel>
int fit_one(int smem) {
  int n = 0;
  if (configure<kKernel>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// KS::kernel<CPL>: the kernel of one entry with CPL chunks per lane (1-4; the precise
// mode 1-2).
template <int FMT, int MODE, class KS>
int launch(const Params& p, int grid, cudaStream_t st) {
  constexpr bool kPdl = MODE == kPrequantized;
  const int smem = layout(FMT, MODE, p.k, p.rs, p.stages, p.gw).total;
  if (smem > kMaxSmem || p.rs < 1 || p.stages < 2 || p.gw < 1 || kWarps % p.gw || grid < 1 ||
      (p.e != nullptr && (MODE != kQuantize || p.n_local < 1 || p.e_lo < 0)) ||
      (MODE == kPrequantized && (p.pre < 1 || p.pre > p.stages)) ||
      (MODE == kPrecise && (p.stages - 1) * layout(FMT, MODE, p.k, p.rs, p.stages, p.gw).stage <
                               4 * p.k))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (MODE == kPrecise) {  // the f32 row in registers: at most 2 chunks
    switch (cpl_of(FMT, p.k, p.gw)) {
      case 1: return launch_one<KS::template kernel<1>, kPdl>(p, smem, grid, st);
      case 2: return launch_one<KS::template kernel<2>, kPdl>(p, smem, grid, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (cpl_of(FMT, p.k, p.gw)) {
      case 1: return launch_one<KS::template kernel<1>, kPdl>(p, smem, grid, st);
      case 2: return launch_one<KS::template kernel<2>, kPdl>(p, smem, grid, st);
      case 3: return launch_one<KS::template kernel<3>, kPdl>(p, smem, grid, st);
      case 4: return launch_one<KS::template kernel<4>, kPdl>(p, smem, grid, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// Blocks of an entry's kernel one SM holds at once with this ring, or -1.
template <int FMT, int MODE, class KS>
int blocks_per_sm(int k, int rs, int stages, int gw) {
  const int smem = layout(FMT, MODE, k, rs, stages, gw).total;
  if (smem > kMaxSmem || gw < 1 || kWarps % gw) return -1;
  if constexpr (MODE == kPrecise) {
    switch (cpl_of(FMT, k, gw)) {
      case 1: return fit_one<KS::template kernel<1>>(smem);
      case 2: return fit_one<KS::template kernel<2>>(smem);
      default: return -1;
    }
  } else {
    switch (cpl_of(FMT, k, gw)) {
      case 1: return fit_one<KS::template kernel<1>>(smem);
      case 2: return fit_one<KS::template kernel<2>>(smem);
      case 3: return fit_one<KS::template kernel<3>>(smem);
      case 4: return fit_one<KS::template kernel<4>>(smem);
      default: return -1;
    }
  }
}

}  // namespace mvs
