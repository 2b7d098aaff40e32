// paged_attention: T chunk queries per batch row attend over that row's block-table KV
// in an (L, N, hk, bt, hs) block pool, plus the chunk's own uncommitted K/V under an
// in-chunk causal mask — the serving path's attention for decode (T = 1) and prefill
// chunks (T <= 64).
//
// Replaces distributed_llama_tpu/ops/pallas_paged_attention.py `paged_attention`
// (kernel body `_kernel`: per (row, kv head) a flash (m, l, acc) carry over the table's
// blocks, the chunk folded in at the last grid step with the mask tau <= ti).
//
// What it computes (the same function as the TPU kernel): for batch row b, kv head h
// and query row r = ti·g + gi (ti the chunk position, gi the head in the group), scores
// (q·k)·1/sqrt(hs) in f32 over the committed slots s < lengths[b] (slot s lives in pool
// block tables[b, s / bt] at offset s % bt, layer `layer[0]`) and over the chunk keys
// tau <= ti; softmax in f32; output sum p·v / sum p. A slot at or past lengths[b] is
// never read (its tile rows are zero-filled), so scratch blocks and garbage rows cannot
// reach the output. tables, lengths and the layer index are read from device memory,
// so the launch does not depend on their values.
//
// What bounds it on an H100: bytes at decode and 8-token chunks. Each committed K and
// V row is read once (2·hs·2 bytes per slot and kv head in bf16) for 4·T·g·hs flops per
// slot, twice that with the hi/lo split: 64 flops per byte at T = 64, g = 1, under the
// bf16 tensor cores' ridge of ~295. mma.sync runs well below that peak, so at 64-token
// chunks the products, not the bytes, set the time of this design.
//
// What the design does (csrc/attention_tile.cuh): one launch. A block per (64 query
// rows, slot split, batch row and kv head) owns all of the row's query rows up to 64,
// so each K/V tile is read from HBM once per (row, head, split); rows past 64 are
// further blocks of the same split, adjacent in the grid, that find the tiles in L2.
// Tiles of 64 slots stream through a 3-stage ring of bulk copies, one per K or V row,
// the pool block of each slot read from the table a tile ahead. Scores and P·V run on
// the tensor cores in bf16 hi/lo pairs; at T·g <= 8 (decode) a narrow body puts the
// keys on the MMA rows, so a product is not 15/16 padding, and the four warps split
// each tile's slots and merge in shared memory. f32 pools take an f32 CUDA-core body in
// the same ring. The chunk keys follow the row's last slot, under the causal mask. The
// splits are sized from the window (n_read), never from a row's length, and the last
// split block to finish merges them.

#include "attention_tile.cuh"

namespace {

struct PagedSrc {
  __device__ __forceinline__ static int committed(const attn::Params& p, int b) {
    return p.lengths[b];
  }
  __device__ __forceinline__ static int page(const attn::Params& p, int b, int s) {
    return p.tables[static_cast<size_t>(b) * p.W + s / p.bt];
  }
  __device__ __forceinline__ static size_t row(const attn::Params& p, int h, int layer,
                                               int s, int blk) {
    return ((static_cast<size_t>(layer) * p.n_blocks + blk) * p.hk + h) * p.bt + s % p.bt;
  }
};

template <typename T, int HS, bool kNarrow>
__global__ void __launch_bounds__(attn::kThreads)
paged_attn_kernel(const attn::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn::attention_block<PagedSrc, T, HS, kNarrow>(p, smem);
}

// Launch, or with p == nullptr return the blocks that fit on one SM (-1 on failure).
template <typename T, int HS, bool kNarrow>
int run_body(const attn::Params* p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = attn::smem_bytes<T, HS>();
  if (p == nullptr)
    return attn::blocks_per_sm(paged_attn_kernel<T, HS, kNarrow>, smem);
  static const cudaError_t attr = attn::configure(paged_attn_kernel<T, HS, kNarrow>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_attn_kernel<T, HS, kNarrow><<<grid, attn::kThreads, smem, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 stores with at most 8 query rows take the narrow body
template <typename T, int HS>
int run(const attn::Params* p, int rows, dim3 grid, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (rows <= 8) return run_body<T, HS, true>(p, grid, st);
  }
  return run_body<T, HS, false>(p, grid, st);
}

template <typename T>
int run_hs(const attn::Params* p, int hs, int rows, dim3 grid, cudaStream_t st) {
  switch (hs) {
    case 32: return run<T, 32>(p, rows, grid, st);
    case 64: return run<T, 64>(p, rows, grid, st);
    case 96: return run<T, 96>(p, rows, grid, st);
    case 128: return run<T, 128>(p, rows, grid, st);
    default: return p == nullptr ? -1 : static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, hk, R = T·g, hs) f32; kc/vc: (L, n_blocks, hk, bt, hs) bf16 (cache_bf16 = 1) or
// f32; k_new/v_new: (B, hk, T, hs) in the cache dtype; tables: (B, W) i32; lengths: (B,)
// i32; layer: (1,) i32 — all on the device. Slots [0, n_slots = n_read·bt) of each table
// are readable; split j takes the 64-slot tiles j, j + nsplit, ... part_m/part_l:
// (B·hk, nsplit, R) f32 and part_acc: (B·hk, nsplit, R, hs) f32 scratch, and counters:
// (B·hk·npass) i32, zero, left zero — all three unused when nsplit == 1. out:
// (B, hk, R, hs) f32. 1 <= nsplit <= 32; hs in {32, 64, 96, 128}; npass = ceil(R / 64).
extern "C" int paged_attention(const void* q, const void* kc, const void* vc,
                               const void* k_new, const void* v_new, const void* tables,
                               const void* lengths, const void* layer, void* part_m,
                               void* part_l, void* part_acc, void* counters, void* out,
                               int cache_bf16, int B, int hk, int R, int g, int T_len,
                               int hs, int n_blocks, int bt, int W, int n_slots, int nsplit,
                               float scale, void* stream) {
  if (nsplit < 1 || nsplit > attn::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  attn::Params p{};
  p.q = static_cast<const float*>(q);
  p.kc = kc;
  p.vc = vc;
  p.k_new = k_new;
  p.v_new = v_new;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.layer = static_cast<const int*>(layer);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.counters = static_cast<int*>(counters);
  p.out = static_cast<float*>(out);
  p.hk = hk;
  p.R = R;
  p.g = g;
  p.T = T_len;
  p.nsplit = nsplit;
  p.n_slots = n_slots;
  p.n_blocks = n_blocks;
  p.bt = bt;
  p.W = W;
  p.scale = scale;
  const dim3 grid((R + attn::kPassRows - 1) / attn::kPassRows, nsplit, B * hk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_bf16) return run_hs<__nv_bfloat16>(&p, hs, R, grid, st);
  return run_hs<float>(&p, hs, R, grid, st);
}

// Blocks of the kernel for this cache dtype, head size and query rows per (row, kv
// head) that fit on one SM at once (the wrapper sizes its splits so that one wave holds
// the launch), or -1.
extern "C" int paged_attention_blocks_per_sm(int cache_bf16, int hs, int rows) {
  if (cache_bf16) return run_hs<__nv_bfloat16>(nullptr, hs, rows, dim3(), nullptr);
  return run_hs<float>(nullptr, hs, rows, dim3(), nullptr);
}

