// attention_tile.cuh: the block body shared by paged_attention.cu and
// decode_attention.cu. Each block computes one (batch row, kv head, key split, 64-row
// query pass) piece of flash attention on the bf16 tensor cores, streaming its keys
// through a ring of bulk copies in shared memory; the last block of a (row, head, pass)
// to finish merges the splits, so a call is one launch.
//
// Query rows: row r = ti·g + gi of kv head h (chunk position ti, head gi of the group)
// reads q[(b·hk + h)·R + r]. Keys: the committed slots below the row's length, in
// 64-slot tiles dealt to the splits in turn (split j: tiles j, j + nsplit, ...; at any
// length the splits share the work, and a split past the length writes an empty
// partial, m = -1e30, l = 0), which the Src policy resolves to rows of the K/V stores;
// then the T chunk keys tau <= r / g (k_new, v_new, (B·hk, T, HS)), which follow the
// row's last slot in the split that holds it.
//
// Tiles: a ring stage holds kKT = 64 keys of K and V, rows padded by 16 bytes so that
// the ldmatrix fragment loads hit 32 distinct banks. Each of the 128 threads moves one
// K or V row of a tile with one cp.async.bulk (the copy engine, not the thread, moves
// the bytes), and an mbarrier per stage counts them in. A row past the block's keys is
// zero-filled by the thread and never copied: slots at or past the row's length are
// never read, so a NaN in an unused block cannot reach an MMA tile, where 0·NaN would
// poison P·V.
//
// Products: mma.sync.m16n8k16 bf16 with f32 accumulators. q and p are split into a bf16
// hi part and a bf16 lo part (x - hi), and each product is issued for both, so the
// scores and the output keep ~2^-16 relative accuracy (a bf16 K or V is exact). With f32
// stores (parity runs, --dtype float32) the products run on the CUDA cores in f32
// inside the same ring and merge. The softmax runs in f32 in log2 units (ex2), and the
// carry is rescaled only when a row's max moves. With at most 8 query rows and bf16
// stores (decode), a narrow body makes the keys the MMA rows and the query rows its 8
// columns: half the products per key.
//
// Warps: a pass covers up to 4 row tiles of 16 rows. With np row tiles, the 4 warps
// split each stage's keys ksplit = 4 / np ways (decode, np = 1: 16 keys per warp), each
// warp carrying its own (m, l, acc) over its keys, and the warps of a row tile merge in
// shared memory at the end.
//
// Merge: each split block writes its partial (m, l, acc); a per-(row, head, pass)
// counter, released and acquired by one thread per block, tells the last block, which
// folds the partials in split order (deterministic, no float atomics) and resets the
// counter for the next call. With one split the block writes the output itself.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace attn {

using namespace acopy;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 64;                       // keys per ring stage
constexpr int kStages = 3;                    // ring depth
constexpr int kRowTile = 16;                  // query rows per MMA tile
constexpr int kPassRows = kWarps * kRowTile;  // query rows per block
constexpr int kMaxSplits = 32;                // splits of one (row, head, pass) at most
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;       // (BH, R, HS) f32
  const void* kc;       // K store: pools (L, N, hk, bt, HS) or caches (L, 1, hk, S, HS)
  const void* vc;
  const void* k_new;    // (BH, T, HS) chunk keys, store dtype
  const void* v_new;
  const int* tables;    // paged: (B, W) int32
  const int* lengths;   // paged: (B,) int32
  const long long* pos; // contiguous: (1,) int64, the committed length
  const int* layer;     // (1,) int32
  float* part_m;        // (BH, nsplit, R) f32, when nsplit > 1
  float* part_l;
  float* part_acc;      // (BH, nsplit, R, HS) f32
  int* counters;        // (BH · npass) int32, zero between calls
  float* out;           // (BH, R, HS) f32
  int hk, R, g, T, nsplit, n_slots;
  int n_blocks, bt, W;  // paged
  int s_len;            // contiguous: slots per head
  float scale;
};

// Row stride of a stage tile in elements: HS plus 16 bytes.
template <typename T, int HS>
__host__ __device__ constexpr int row_stride() {
  return HS + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int HS>
__host__ __device__ constexpr int stage_elems() {
  return kKT * row_stride<T, HS>();
}

// Dynamic shared memory of one block: the ring, reused by the warps' merge.
template <typename T, int HS>
__host__ __device__ constexpr size_t smem_bytes() {
  // f32 stores: the ring, then each warp's p of 16 rows x 32 keys for the P·V step
  const size_t ring = static_cast<size_t>(kStages) * 2 * stage_elems<T, HS>() * sizeof(T) +
                      (sizeof(T) == 4 ? kWarps * kRowTile * 32 * sizeof(float) : 0);
  const size_t red = static_cast<size_t>(kWarps) * kRowTile * (HS + 2) * sizeof(float);
  return ring > red ? ring : red;
}

// Let a block kernel take its dynamic shared memory, and prefer the largest shared
// memory carveout, so that as many blocks fit on an SM as registers allow.
template <typename K>
cudaError_t configure(K* kernel, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// Blocks of a configured kernel that fit on one SM at once, or -1.
template <typename K>
int blocks_per_sm(K* kernel, size_t smem) {
  int n = 0;
  if (configure(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a · b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16 pair hi and the pair of what hi leaves out, x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row l % 8 of
// matrix l / 8. Plain: r[i] of lane (gid, tq) holds row gid, columns 2tq, 2tq + 1 of
// matrix i; transposed: rows 2tq, 2tq + 1 of column gid.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  const unsigned a = smem_addr(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* row) {
  const unsigned a = smem_addr(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// an 8x8 bf16 matrix fragment transposed across the warp
__device__ __forceinline__ uint32_t movtrans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The block body. Src gives, for batch row b: committed(p, b), the row's committed
// length; page(p, b, s), what locates slot s (a pool block, read ahead of the copies);
// and row(p, h, layer, s, page), the index of slot s's HS-wide row in the K/V stores.
// Grid: (npass, nsplit, BH).
template <typename Src, typename T, int HS, bool kNarrow>
__device__ __forceinline__ void attention_block(const Params& p, unsigned char* smem) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int RS = row_stride<T, HS>();
  constexpr int SE = stage_elems<T, HS>();
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  constexpr int KS = HS / 16;                             // k-steps of the score product
  constexpr int DN = HS / 8;                              // n-tiles of the output
  constexpr int MT = HS / 16;                             // m-tiles of O^T (narrow)
  static_assert(!kNarrow || !kF32, "the narrow body reads bf16 tiles");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const int pass = blockIdx.x;
  const int split = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.hk;
  const int h = bh - b * p.hk;
  const int layer = p.layer[0];

  const int row_base = pass * kPassRows;
  const int rows = min(kPassRows, p.R - row_base);
  const int np = min(kWarps, (rows + kRowTile - 1) / kRowTile);
  const int ksplit = kWarps / np;
  const bool active = warp < np * ksplit;
  const int rt = warp % np;
  const int nk = kKT / ksplit;         // keys of each stage this warp owns
  const int ko = (warp / np) * nk;     // their first key in the stage

  // committed slots of this row in 64-slot tiles; split j takes tiles j, j + nsplit,
  // j + 2·nsplit, ... (strided: at any length the splits share the work). The block's
  // keys form one list: its tiles' slots (only the row's last tile is partial), then,
  // in the split holding that last tile (split 0 when there is none), the T chunk keys.
  const int n_comm = min(p.n_slots, max(0, Src::committed(p, b)));
  const int ct_all = (n_comm + kKT - 1) / kKT;
  const int ct = ct_all > split ? (ct_all - split + p.nsplit - 1) / p.nsplit : 0;
  const bool owner = split == (ct_all > 0 ? (ct_all - 1) % p.nsplit : 0);
  const int nc = owner && ct > 0 ? n_comm - (ct_all - 1) * kKT + (ct - 1) * kKT : ct * kKT;
  const int n_keys = nc + (owner ? p.T : 0);
  const int ntiles = (n_keys + kKT - 1) / kKT;
  // slot of list key v < nc
  auto slot_of = [&](int v) { return (split + (v / kKT) * p.nsplit) * kKT + v % kKT; };

  const T* kc = static_cast<const T*>(p.kc);
  const T* vc = static_cast<const T*>(p.vc);
  const T* kn = static_cast<const T*>(p.k_new) + static_cast<size_t>(bh) * p.T * HS;
  const T* vn = static_cast<const T*>(p.v_new) + static_cast<size_t>(bh) * p.T * HS;
  T* ring = reinterpret_cast<T*>(smem);

  // the ring: stage i % kStages holds tile i once full[i % kStages] completes its phase
  // i / kStages. Thread tid copies row tid of every tile, one bulk copy: K row tid, or
  // V row tid - kKT; a row past the block's keys is zero-filled instead. The page (pool
  // block) of its next row is read one tile ahead, so no copy waits on a table read.
  static_assert(kThreads == 2 * kKT, "one K or V row per thread");
  __shared__ __align__(8) uint64_t full[kStages];
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int j = tid & (kKT - 1);
  const bool is_v = tid >= kKT;
  const T* src_store = is_v ? vc : kc;
  const T* src_chunk = is_v ? vn : kn;
  int page = 0;
  auto fetch_page = [&](int i) {
    const int v = i * kKT + j;
    page = v < nc ? Src::page(p, b, slot_of(v)) : 0;
  };
  // start tile i (called for i = 0, 1, 2, ... in order; nothing past the last tile)
  auto issue = [&](int i) {
    if (i >= ntiles) return;
    const int st = i % kStages;
    T* row = ring + st * 2 * SE + (is_v ? SE : 0) + j * RS;
    const int v = i * kKT + j;
    if (tid == 0) {
      const int n_rows = min(kKT, n_keys - i * kKT);
      mbar_arrive_expect_tx(&full[st], 2 * n_rows * HS * static_cast<int>(sizeof(T)));
    }
    if (v < n_keys) {
      const T* src = v < nc ? src_store + Src::row(p, h, layer, slot_of(v), page) * HS
                            : src_chunk + static_cast<size_t>(v - nc) * HS;
      bulk_copy(row, src, HS * static_cast<int>(sizeof(T)), &full[st]);
    } else {
#pragma unroll
      for (int e = 0; e < HS; e += EPC)
        *reinterpret_cast<uint4*>(row + e) = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();
    }
    fetch_page(i + 1);
  };

  fetch_page(0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const float scale2 = p.scale * 1.4426950408889634f;  // scale · log2 e
  const int nsplit = p.nsplit;
  const size_t part0 = static_cast<size_t>(bh) * nsplit + split;  // partial row block
  // where the warps that split a row tile's keys merge (the ring is free by then)
  float* red_acc = reinterpret_cast<float*>(smem);  // [warp][16][HS]
  float* red_m = red_acc + kWarps * kRowTile * HS;  // [warp][16]
  float* red_l = red_m + kWarps * kRowTile;
  bool in_red = true;  // the carries wait in red_* for the merge
  if constexpr (kNarrow) {
    // R <= 8 (decode): keys are the MMA rows and the query rows its 8 columns, so a
    // product carries 8 query rows instead of 16 of which at most 8 are live: half the
    // products and half the softmax work per key. Every warp takes 16 keys of each tile.
    // This thread's query row gid as bf16 hi/lo B fragments
    uint32_t qh[KS][2], ql[KS][2];
    {
      const float* qr = p.q + (static_cast<size_t>(bh) * p.R + gid) * HS;
      const bool ok = gid < p.R;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int d = kk * 16 + 2 * tq;
        const float2 z = make_float2(0.0f, 0.0f);
        const float2 b0 = ok ? *reinterpret_cast<const float2*>(qr + d) : z;
        const float2 b1 = ok ? *reinterpret_cast<const float2*>(qr + d + 8) : z;
        split2(b0.x, b0.y, qh[kk][0], ql[kk][0]);
        split2(b1.x, b1.y, qh[kk][1], ql[kk][1]);
      }
    }
    // the thread's accumulator columns are query rows 2tq (A) and 2tq + 1 (B)
    const int tiA = (2 * tq) / p.g;
    const int tiB = (2 * tq + 1) / p.g;
    float mA = kNeg, mB = kNeg, lA = 0.0f, lB = 0.0f;
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][c] = 0.0f;
    }
    for (int it = 0; it < ntiles; ++it) {
      __syncthreads();  // every warp is done with tile it - 1: its stage may refill
      issue(it + kStages - 1);
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      const int v0 = it * kKT + ko;  // the warp's first key in the block's list
      if (v0 >= n_keys) continue;
      const T* ks = ring + (it % kStages) * 2 * SE;
      const T* vs = ks + SE;
      // S^T (16 keys x 8 rows): the hi and the lo products in two chains
      float sh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const T* krow = ks + (ko + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4];  // keys +0, +8 of dims +0, then of dims +8
        ldsm4(kf, krow + kk * 16);
        mma(sh, kf, qh[kk]);
        mma(sl, kf, ql[kk]);
      }
      // c: key gid + 8·(c >> 1), row 2tq + (c & 1)
      const bool all_valid = v0 + 16 <= nc;
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = v0 + gid + (c >> 1) * 8;
        const int ti = (c & 1) ? tiB : tiA;
        const bool ok = all_valid || v < nc || (v < n_keys && v - nc <= ti);
        x[c] = ok ? (sh[c] + sl[c]) * scale2 : kNeg;
      }
      float mxA = fmaxf(x[0], x[2]), mxB = fmaxf(x[1], x[3]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mxA = fmaxf(mxA, __shfl_xor_sync(kFull, mxA, o));
        mxB = fmaxf(mxB, __shfl_xor_sync(kFull, mxB, o));
      }
      const float mnA = fmaxf(mA, mxA);
      const float mnB = fmaxf(mB, mxB);
      if (__any_sync(kFull, mnA != mA || mnB != mB)) {
        const float alA = exp2_approx(mA - mnA);
        const float alB = exp2_approx(mB - mnB);
        lA *= alA;
        lB *= alB;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] *= alA;
          acc[mt][1] *= alB;
          acc[mt][2] *= alA;
          acc[mt][3] *= alB;
        }
        mA = mnA;
        mB = mnB;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[c] = x[c] == kNeg ? 0.0f : exp2_approx(x[c] - ((c & 1) ? mB : mA));
      float rsA = x[0] + x[2], rsB = x[1] + x[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        rsA += __shfl_xor_sync(kFull, rsA, o);
        rsB += __shfl_xor_sync(kFull, rsB, o);
      }
      lA += rsA;
      lB += rsB;
      // P^T as the B fragment (keys x rows): each 8x8 bf16 block transposed in registers
      uint32_t ph[2], pl[2], t0, t1;
      split2(x[0], x[1], t0, t1);
      ph[0] = movtrans(t0);
      pl[0] = movtrans(t1);
      split2(x[2], x[3], t0, t1);
      ph[1] = movtrans(t0);
      pl[1] = movtrans(t1);
      // O^T (dims x rows) += V^T (dims x keys) · P^T
      const T* vrow = vs + (ko + (lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t vf[4];  // V^T: dims +0, +8 of keys +0, then of keys +8
        ldsm4_t(vf, vrow + mt * 16);
        mma(acc[mt], vf, ph);
        mma(acc[mt], vf, pl);
      }
    }
    __syncthreads();  // every tile issued was waited for: the ring is free
    // acc[mt]: dim mt·16 + gid (+8 for c >= 2), row 2tq + (c & 1)
    float* rw = red_acc + warp * kRowTile * HS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int d = mt * 16 + gid;
      rw[(2 * tq) * HS + d] = acc[mt][0];
      rw[(2 * tq + 1) * HS + d] = acc[mt][1];
      rw[(2 * tq) * HS + d + 8] = acc[mt][2];
      rw[(2 * tq + 1) * HS + d + 8] = acc[mt][3];
    }
    if (gid == 0) {
      red_m[warp * kRowTile + 2 * tq] = mA;
      red_m[warp * kRowTile + 2 * tq + 1] = mB;
      red_l[warp * kRowTile + 2 * tq] = lA;
      red_l[warp * kRowTile + 2 * tq + 1] = lB;
    }
  } else if constexpr (kF32) {
    // f32 stores (parity runs, --dtype float32): the products on the CUDA cores in f32,
    // in the plain version's order (one FMA per dim), since a bf16 split of f32 K and V
    // moves the output by more than the downstream bf16 roundings can absorb. Lane j of
    // the warp owns key c0 + j of each 32-key step, and dims lane + 32u of the output
    // of each of the warp's 16 rows; p goes through shared memory to the P·V step.
    constexpr int DU = HS / 32;
    float* pw = reinterpret_cast<float*>(smem + kStages * 2 * SE * sizeof(T)) +
                warp * kRowTile * 32;  // [16 rows][32 keys]
    const int r0 = row_base + rt * kRowTile;
    const float* qw = p.q + (static_cast<size_t>(bh) * p.R + r0) * HS;
    const int live = active ? max(0, min(kRowTile, p.R - r0)) : 0;
    float m[kRowTile], l[kRowTile], acc[kRowTile][DU];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      m[r] = kNeg;
      l[r] = 0.0f;
#pragma unroll
      for (int u = 0; u < DU; ++u) acc[r][u] = 0.0f;
    }
    for (int it = 0; it < ntiles; ++it) {
      __syncthreads();  // every warp is done with tile it - 1: its stage may refill
      issue(it + kStages - 1);
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      if (!active) continue;
      const T* ks = ring + (it % kStages) * 2 * SE;
      const T* vs = ks + SE;
      const int v0 = it * kKT;
      for (int c0 = ko; c0 < ko + nk && v0 + c0 < n_keys; c0 += 32) {
        const int nkey = min(32, ko + nk - c0);
        const int v = v0 + c0 + lane;  // this lane's key in the block's list
        const float* krow = ks + (c0 + (lane < nkey ? lane : 0)) * RS;
        float sc[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) sc[r] = 0.0f;
        for (int d = 0; d < HS; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
          for (int r = 0; r < kRowTile; ++r) {
            if (r < live) {
              const float4 qv = __ldg(reinterpret_cast<const float4*>(qw + r * HS + d));
              sc[r] = fmaf(qv.x, kv.x, sc[r]);
              sc[r] = fmaf(qv.y, kv.y, sc[r]);
              sc[r] = fmaf(qv.z, kv.z, sc[r]);
              sc[r] = fmaf(qv.w, kv.w, sc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const int ti = (r0 + r) / p.g;
          const bool ok = lane < nkey && (v < nc || (v < n_keys && v - nc <= ti));
          const float x = ok ? sc[r] * scale2 : kNeg;
          float mx = x;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          const float mn = fmaxf(m[r], mx);
          if (mn != m[r]) {  // warp-uniform: m[r] and mx are the same in every lane
            const float al = exp2f(m[r] - mn);
            l[r] *= al;
#pragma unroll
            for (int u = 0; u < DU; ++u) acc[r][u] *= al;
            m[r] = mn;
          }
          const float pv = x == kNeg ? 0.0f : exp2f(x - mn);
          float sum = pv;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
          l[r] += sum;
          pw[r * 32 + lane] = pv;
        }
        __syncwarp();
        for (int jk = 0; jk < nkey; ++jk) {
          const float* vrow = vs + (c0 + jk) * RS + lane;
#pragma unroll
          for (int u = 0; u < DU; ++u) {
            const float vv = vrow[32 * u];
#pragma unroll
            for (int r = 0; r < kRowTile; ++r)
              acc[r][u] = fmaf(pw[r * 32 + jk], vv, acc[r][u]);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every tile issued was waited for: the ring is free
    if (active) {
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
#pragma unroll
        for (int u = 0; u < DU; ++u)
          red_acc[(warp * kRowTile + r) * HS + lane + 32 * u] = acc[r][u];
        if (lane == 0) {
          red_m[warp * kRowTile + r] = m[r];
          red_l[warp * kRowTile + r] = l[r];
        }
      }
    }
  } else {
    // this warp's query rows (ra, ra + 8) as bf16 hi/lo A fragments
    const int ra = row_base + rt * kRowTile + gid;
    uint32_t qh[KS][4], ql[KS][4];
    {
      const float* qa = p.q + (static_cast<size_t>(bh) * p.R + ra) * HS;
      const float* qb = qa + 8 * HS;
      const bool oka = active && ra < p.R;
      const bool okb = active && ra + 8 < p.R;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int d = kk * 16 + 2 * tq;
        const float2 z = make_float2(0.0f, 0.0f);
        const float2 a0 = oka ? *reinterpret_cast<const float2*>(qa + d) : z;
        const float2 a1 = okb ? *reinterpret_cast<const float2*>(qb + d) : z;
        const float2 a2 = oka ? *reinterpret_cast<const float2*>(qa + d + 8) : z;
        const float2 a3 = okb ? *reinterpret_cast<const float2*>(qb + d + 8) : z;
        split2(a0.x, a0.y, qh[kk][0], ql[kk][0]);
        split2(a1.x, a1.y, qh[kk][1], ql[kk][1]);
        split2(a2.x, a2.y, qh[kk][2], ql[kk][2]);
        split2(a3.x, a3.y, qh[kk][3], ql[kk][3]);
      }
    }
    // the causal bound of each of the thread's two rows: chunk key tau is visible iff
    // tau <= ti
    const int ti0 = ra / p.g;
    const int ti1 = (ra + 8) / p.g;

    float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
    float acc[DN][4];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dn][c] = 0.0f;
    }

    for (int it = 0; it < ntiles; ++it) {
      __syncthreads();  // every warp is done with tile it - 1: its stage may refill
      issue(it + kStages - 1);
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      if (!active) continue;
      const T* ks = ring + (it % kStages) * 2 * SE;
      const T* vs = ks + SE;
      const int v0 = it * kKT;  // the tile's first key in the block's list
      // up to 32 keys (4 n-tiles) at a time; keys past the list's end change nothing
      for (int c0 = ko; c0 < ko + nk && v0 + c0 < n_keys; c0 += 32) {
        const int ntn = min(4, (ko + nk - c0) / 8);
        // scores: the hi and the lo products in separate accumulators (two chains)
        float s[4][4], sl[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] = sl[nt][c] = 0.0f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int nt = 0; nt < 4; nt += 2) {
            if (nt < ntn) {
              // matrices: keys of n-tile nt (dims +0, +8), then of n-tile nt + 1
              uint32_t kf[4];
              ldsm4(kf, ks + (c0 + (nt + (lane >> 4)) * 8 + (lane & 7)) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
              const uint32_t k0[2] = {kf[0], kf[1]};
              const uint32_t k1[2] = {kf[2], kf[3]};
              mma(s[nt], qh[kk], k0);
              mma(sl[nt], ql[kk], k0);
              mma(s[nt + 1], qh[kk], k1);
              mma(sl[nt + 1], ql[kk], k1);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] += sl[nt][c];
        }
        // mask, scale (to log2 units: p = 2^(s·scale·log2 e - m)) and the running max of
        // rows ra (x = 0) and ra + 8 (x = 1); a run of committed slots needs no mask
        const bool all_valid = v0 + c0 + 8 * ntn <= nc;
        float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntn) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              // a committed slot, or chunk key tau = v - nc when tau <= ti
              const int v = v0 + c0 + nt * 8 + 2 * tq + (c & 1);
              const int ti = (c & 2) ? ti1 : ti0;
              const bool ok = all_valid || v < nc || (v < n_keys && v - nc <= ti);
              const float x = ok ? s[nt][c] * scale2 : kNeg;
              s[nt][c] = x;
              if (c & 2) mx1 = fmaxf(mx1, x);
              else mx0 = fmaxf(mx0, x);
            }
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        // the carry is rescaled only when some row's max moved
        if (__any_sync(kFull, mn0 != m0 || mn1 != m1)) {
          const float al0 = exp2_approx(m0 - mn0);
          const float al1 = exp2_approx(m1 - mn1);
          l0 *= al0;
          l1 *= al1;
#pragma unroll
          for (int dn = 0; dn < DN; ++dn) {
            acc[dn][0] *= al0;
            acc[dn][1] *= al0;
            acc[dn][2] *= al1;
            acc[dn][3] *= al1;
          }
          m0 = mn0;
          m1 = mn1;
        }
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntn) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = s[nt][c];
              const float pv = v == kNeg ? 0.0f : exp2_approx(v - ((c & 2) ? m1 : m0));
              s[nt][c] = pv;
              if (c & 2) rs1 += pv;
              else rs0 += pv;
            }
          }
        }
        rs0 += __shfl_xor_sync(kFull, rs0, 1);
        rs0 += __shfl_xor_sync(kFull, rs0, 2);
        rs1 += __shfl_xor_sync(kFull, rs1, 1);
        rs1 += __shfl_xor_sync(kFull, rs1, 2);
        l0 += rs0;
        l1 += rs1;
        // O += P·V over 16 keys per k-step: n-tiles 2kt and 2kt + 1 form the A fragment
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          if (2 * kt < ntn) {
            uint32_t ph[4], pl[4];
            split2(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
            split2(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
            split2(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
            split2(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
            // transposed matrices: keys +0 and +8 of dims dn, then of dims dn + 1
            const __nv_bfloat16* vrow =
                vs + (c0 + kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                (lane >> 4) * 8;
#pragma unroll
            for (int dn = 0; dn < DN; dn += 2) {
              uint32_t vf[4];
              ldsm4_t(vf, vrow + dn * 8);
              const uint32_t v0[2] = {vf[0], vf[1]};
              const uint32_t v1[2] = {vf[2], vf[3]};
              mma(acc[dn], ph, v0);
              mma(acc[dn], pl, v0);
              mma(acc[dn + 1], ph, v1);
              mma(acc[dn + 1], pl, v1);
            }
          }
        }
      }
    }
    __syncthreads();  // every tile issued was waited for: the ring is free
    if (ksplit == 1) {
      // each warp owns its rows outright: the output, or this split's partial, straight
      // from registers
      in_red = false;
      if (active) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = ra + 8 * x;
          if (row < p.R) {
            const float l = x ? l1 : l0;
            float* dst = nsplit == 1 ? p.out + (static_cast<size_t>(bh) * p.R + row) * HS
                                     : p.part_acc + (part0 * p.R + row) * HS;
#pragma unroll
            for (int dn = 0; dn < DN; ++dn) {
              float2 v = make_float2(acc[dn][2 * x], acc[dn][2 * x + 1]);
              if (nsplit == 1) v = make_float2(v.x / l, v.y / l);
              *reinterpret_cast<float2*>(dst + dn * 8 + 2 * tq) = v;
            }
            if (nsplit > 1 && tq == 0) {
              p.part_m[part0 * p.R + row] = x ? m1 : m0;
              p.part_l[part0 * p.R + row] = l;
            }
          }
        }
      }
    } else if (active) {
      float* ra_row = red_acc + (warp * kRowTile + gid) * HS;
      float* rb_row = ra_row + 8 * HS;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + 2 * tq;
        *reinterpret_cast<float2*>(ra_row + d) = make_float2(acc[dn][0], acc[dn][1]);
        *reinterpret_cast<float2*>(rb_row + d) = make_float2(acc[dn][2], acc[dn][3]);
      }
      if (tq == 0) {
        red_m[warp * kRowTile + gid] = m0;
        red_m[warp * kRowTile + gid + 8] = m1;
        red_l[warp * kRowTile + gid] = l0;
        red_l[warp * kRowTile + gid + 8] = l1;
      }
    }
  }
  if (in_red) {
    __syncthreads();
    for (int e = tid; e < rows * HS; e += kThreads) {
      const int rl = e / HS;
      const int d = e - rl * HS;
      const int t16 = rl / kRowTile;
      const int r = rl - t16 * kRowTile;
      float mx = kNeg;
      for (int j = 0; j < ksplit; ++j)
        mx = fmaxf(mx, red_m[(t16 + j * np) * kRowTile + r]);
      float ls = 0.0f, as = 0.0f;
      for (int j = 0; j < ksplit; ++j) {
        const int w = t16 + j * np;
        const float f = exp2_approx(red_m[w * kRowTile + r] - mx);
        ls += red_l[w * kRowTile + r] * f;
        as += red_acc[(w * kRowTile + r) * HS + d] * f;
      }
      if (nsplit == 1) {
        p.out[(static_cast<size_t>(bh) * p.R + row_base + rl) * HS + d] = as / ls;
      } else {
        const size_t pi = part0 * p.R + row_base + rl;
        p.part_acc[pi * HS + d] = as;
        if (d == 0) {
          p.part_m[pi] = mx;
          p.part_l[pi] = ls;
        }
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (row, head, pass) to finish merges the splits in order. The
  // barrier orders every thread's partial before thread 0's release (acq_rel) of the
  // counter; the last block's acquire then sees every block's partials.
  __shared__ int s_last;
  __syncthreads();
  int* counter = p.counters + static_cast<size_t>(bh) * gridDim.x + pass;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    s_last = prev == nsplit - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // one pass over the splits with a running max: every load is independent of the
  // arithmetic, so a thread's loads are all in flight at once
  constexpr int V4 = HS / 4;
  const float4* acc4 = reinterpret_cast<const float4*>(p.part_acc);
  float4* out4 = reinterpret_cast<float4*>(p.out);
  const size_t p0 = static_cast<size_t>(bh) * nsplit * p.R + row_base;  // + j·R + rl
  for (int e = tid; e < rows * V4; e += kThreads) {
    const int rl = e / V4;
    const int d4 = e - rl * V4;
    float mx = kNeg, den = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int jj = 0; jj < nsplit; ++jj) {
      const size_t pj = p0 + static_cast<size_t>(jj) * p.R + rl;
      const float mj = __ldcg(p.part_m + pj);
      const float lj = __ldcg(p.part_l + pj);
      const float4 v = __ldcg(acc4 + pj * V4 + d4);
      const float mn = fmaxf(mx, mj);
      const float fo = exp2_approx(mx - mn);
      const float fj = exp2_approx(mj - mn);
      den = den * fo + lj * fj;
      a = make_float4(a.x * fo + v.x * fj, a.y * fo + v.y * fj, a.z * fo + v.z * fj,
                      a.w * fo + v.w * fj);
      mx = mn;
    }
    out4[(static_cast<size_t>(bh) * p.R + row_base + rl) * V4 + d4] =
        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
  if (tid == 0) *counter = 0;
}

}  // namespace attn
