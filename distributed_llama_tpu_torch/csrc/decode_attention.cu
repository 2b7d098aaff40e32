// decode_attention: one decode token's grouped-query attention for one layer, read
// straight out of the stacked (L, 1, hk, S, hs) KV caches.
//
// Replaces distributed_llama_tpu/ops/pallas_attention.py `fused_decode_attention`
// (kernel bodies `_kernel`, one block, and `_kernel_tiled`, the window-tiled flash
// carry).
//
// What it computes (the same function as the TPU kernel): for kv head h and each of
// its g query heads, softmax over the committed cache slots [0, min(pos, win)) of layer
// `layer` plus the current token (k_new, v_new, not yet in the cache), scores
// (q·k) * 1/sqrt(hs) in f32, output sum_s p_s v_s / sum_s p_s in f32. Slots >= pos and
// slots >= win are never read (their tile rows are zero-filled), so a stale or
// unwritten slot can touch neither the scores nor the values. pos and the layer index
// are read from device memory: the launch depends on the window only, so a captured
// CUDA graph replays at every position of a window.
//
// What bounds it on an H100: bytes. Each committed slot's k and v rows are read once
// (2·hs·2 bytes per slot and kv head in bf16) for ~4·g·hs flops, far under the ridge;
// at short positions the latency of one block's chain (first tile, products, merge).
//
// What the design does (csrc/attention_tile.cuh, shared with paged_attention.cu): one
// launch. A block per (kv head, slot split) streams its 64-slot tiles through a 3-stage
// ring of bulk copies (two tiles in flight before the first is used), the four warps
// take 16 slots of each tile on the tensor cores (the narrow body: slots on the MMA
// rows, the g query heads on its columns), and the last split block of a head folds
// the partials. The current token follows the last committed slot. The splits
// are sized from the window, up to the blocks the card holds at once, and deal the
// tiles in turn, so at any position the splits share the work; a split with no slot
// below pos writes an empty partial (m = -1e30, l = 0).

#include "attention_tile.cuh"

namespace {

struct ContigSrc {
  __device__ __forceinline__ static int committed(const attn::Params& p, int) {
    const long long pos = p.pos[0];
    return pos <= 0 ? 0 : static_cast<int>(min(pos, static_cast<long long>(p.n_slots)));
  }
  __device__ __forceinline__ static int page(const attn::Params&, int, int) { return 0; }
  __device__ __forceinline__ static size_t row(const attn::Params& p, int h, int layer,
                                               int s, int) {
    return (static_cast<size_t>(layer) * p.hk + h) * p.s_len + s;
  }
};

template <typename T, int HS, bool kNarrow>
__global__ void __launch_bounds__(attn::kThreads)
decode_attn_kernel(const attn::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn::attention_block<ContigSrc, T, HS, kNarrow>(p, smem);
}

// Launch, or with p == nullptr return the blocks that fit on one SM (-1 on failure).
template <typename T, int HS, bool kNarrow>
int run_body(const attn::Params* p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = attn::smem_bytes<T, HS>();
  if (p == nullptr)
    return attn::blocks_per_sm(decode_attn_kernel<T, HS, kNarrow>, smem);
  static const cudaError_t attr = attn::configure(decode_attn_kernel<T, HS, kNarrow>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attn_kernel<T, HS, kNarrow><<<grid, attn::kThreads, smem, st>>>(*p);
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

// q: (hk, g, hs) f32; kc/vc: (L, 1, hk, S, hs) in bf16 (cache_bf16=1) or f32;
// k_new/v_new: (hk, 1, hs) in the cache dtype; pos: (1,) int64 and layer: (1,) int32 on
// the device; part_m/part_l: (hk, nsplit, g) f32 and part_acc: (hk, nsplit, g, hs) f32
// scratch, counters: (hk·npass) i32, zero, left zero — unused when nsplit == 1; out:
// (hk, g, hs) f32. Slots [0, win) are readable (win <= S); split j takes the 64-slot
// tiles j, j + nsplit, ..., 1 <= nsplit <= 32. hs in {32, 64, 96, 128};
// npass = ceil(g / 64).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* k_new, const void* v_new, const void* pos,
                                const void* layer, void* part_m, void* part_l,
                                void* part_acc, void* counters, void* out, int cache_bf16,
                                int hk, int g, int hs, int s_len, int win, int nsplit,
                                float scale, void* stream) {
  if (nsplit < 1 || nsplit > attn::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  attn::Params p{};
  p.q = static_cast<const float*>(q);
  p.kc = kc;
  p.vc = vc;
  p.k_new = k_new;
  p.v_new = v_new;
  p.pos = static_cast<const long long*>(pos);
  p.layer = static_cast<const int*>(layer);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.counters = static_cast<int*>(counters);
  p.out = static_cast<float*>(out);
  p.hk = hk;
  p.R = g;
  p.g = g;
  p.T = 1;
  p.nsplit = nsplit;
  p.n_slots = win;
  p.s_len = s_len;
  p.scale = scale;
  const dim3 grid((g + attn::kPassRows - 1) / attn::kPassRows, nsplit, hk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_bf16) return run_hs<__nv_bfloat16>(&p, hs, g, grid, st);
  return run_hs<float>(&p, hs, g, grid, st);
}

// Blocks of the kernel for this cache dtype, head size and query rows per (row, kv
// head) that fit on one SM at once (the wrapper sizes its splits so that one wave holds
// the launch), or -1.
extern "C" int decode_attention_blocks_per_sm(int cache_bf16, int hs, int rows) {
  if (cache_bf16) return run_hs<__nv_bfloat16>(nullptr, hs, rows, dim3(), nullptr);
  return run_hs<float>(nullptr, hs, rows, dim3(), nullptr);
}
