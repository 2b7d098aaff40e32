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
// never read, so scratch blocks and garbage rows cannot reach the output (the TPU kernel
// masks v to 0 for the same reason). tables, lengths and the layer index are read from
// device memory, so the launch does not depend on their values.
//
// What bounds it on an H100: bytes at decode (each committed K and V row is read once,
// 2·hs·2 bytes per slot and kv head in bf16, for ~4·g·T·hs flops), operations in f32 at
// 64-token chunks (T·g query rows per slot).
//
// What the design does: pass 1 gives each (row, kv head, 16-query-row tile, slot
// split) a block of 4 warps. The block walks its split 32 slots at a time: every thread
// first starts all of its loads of the tile's K and V rows (widened to f32 into shared
// memory, slot addresses resolved through the table once per tile), then lane j of each
// warp owns slot j and computes its score for 4 query rows from shared memory, the warp
// reductions give the tile's max and sum, and each thread carries the output of one
// head dim for all 16 query rows in registers. The block writes one unnormalised
// partial (m, l, acc). The host picks the number of splits so that pass 1 covers the
// card about four times. Pass 2, one block per (row, kv head, query-row tile), runs the
// same tile loop over the chunk keys with the causal mask and then merges the splits in
// a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // keys per tile: lane j owns key j
constexpr int kRT = 16;      // query rows per block
constexpr int kMaxHs = 128;  // head dims: one per thread in the P·V phase
constexpr int kLoadPer = kTile * kMaxHs / kThreads;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Smem {
  float q[kRT][kMaxHs];
  float k[kTile][kMaxHs + 1];  // +1: lane j reads row j, conflict-free
  float v[kTile][kMaxHs];
  float p[kRT][kTile];
  float m[kRT];
  float l[kRT];
  float a[kRT];
  size_t base[kTile];
};

// Load the tile's n_valid key rows (element offsets sm.base[j] into kp / vp) as f32.
template <typename T>
__device__ __forceinline__ void load_tile(Smem& sm, const T* __restrict__ kp,
                                          const T* __restrict__ vp, int n_valid, int hs) {
  const int tid = threadIdx.x;
  const int n_el = kTile * hs;
  float kr[kLoadPer], vr[kLoadPer];
#pragma unroll
  for (int i = 0; i < kLoadPer; ++i) {
    const int e = tid + i * kThreads;
    const int j = e / hs;
    const int d = e - j * hs;
    const bool ok = e < n_el && j < n_valid;
    kr[i] = ok ? to_f(kp[sm.base[j] + d]) : 0.0f;
    vr[i] = ok ? to_f(vp[sm.base[j] + d]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kLoadPer; ++i) {
    const int e = tid + i * kThreads;
    const int j = e / hs;
    const int d = e - j * hs;
    if (e < n_el) {
      sm.k[j][d] = kr[i];
      sm.v[j][d] = vr[i];
    }
  }
}

// One online-softmax step over the tile in shared memory: keys [0, n_valid), key j
// visible to block row r iff j < n_valid and (causal_g == 0 or tile0 + j <= (r0 + r) /
// causal_g). acc[r] carries head dim threadIdx.x of row r.
__device__ __forceinline__ void attend_tile(Smem& sm, float (&acc)[kRT], int nrows,
                                            int n_valid, int hs, float scale, int r0,
                                            int tile0, int causal_g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < kRT / kWarps; ++rr) {
    const int r = warp + rr * kWarps;
    bool ok = r < nrows && lane < n_valid;
    if (causal_g > 0) ok = ok && tile0 + lane <= (r0 + r) / causal_g;
    float s = kNeg;
    if (ok) {
      float dot = 0.0f;
      for (int d = 0; d < hs; ++d) dot += sm.q[r][d] * sm.k[lane][d];
      s = dot * scale;
    }
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    const float p = ok ? expf(s - m_new) : 0.0f;
    const float psum = warp_sum(p);
    sm.p[r][lane] = p;
    __syncwarp();
    if (lane == 0) {
      const float a = expf(m_old - m_new);
      sm.a[r] = a;
      sm.l[r] = sm.l[r] * a + psum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < hs) {
#pragma unroll
    for (int r = 0; r < kRT; ++r) acc[r] *= sm.a[r];
    for (int j = 0; j < n_valid; ++j) {
      const float vv = sm.v[j][d];
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] += sm.p[r][j] * vv;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void init_block(Smem& sm, float (&acc)[kRT],
                                           const float* __restrict__ q, int nrows, int hs) {
  for (int e = threadIdx.x; e < kRT * kMaxHs; e += kThreads) {
    const int r = e / kMaxHs;
    const int d = e % kMaxHs;
    sm.q[r][d] = (r < nrows && d < hs) ? q[static_cast<size_t>(r) * hs + d] : 0.0f;
  }
  if (threadIdx.x < kRT) {
    sm.m[threadIdx.x] = kNeg;
    sm.l[threadIdx.x] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRT; ++r) acc[r] = 0.0f;
  __syncthreads();
}

// pass 1: grid (nsplit, row tiles, B·hk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ tables,
                   const int* __restrict__ lengths, const int* __restrict__ layer,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int hk, int R, int hs, int n_blocks,
                   int bt, int W, int n_slots, int split_slots, float scale) {
  __shared__ Smem sm;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int r0 = blockIdx.y * kRT;
  const int bh = blockIdx.z;
  const int b = bh / hk;
  const int h = bh - b * hk;
  const int nrows = min(kRT, R - r0);
  const int s_begin = split * split_slots;
  const int s_end = min(min(s_begin + split_slots, n_slots), lengths[b]);
  const size_t head = (static_cast<size_t>(layer[0]) * n_blocks * hk + h) * bt * hs;
  const size_t blk_stride = static_cast<size_t>(hk) * bt * hs;
  float acc[kRT];
  init_block(sm, acc, q + (static_cast<size_t>(bh) * R + r0) * hs, nrows, hs);
  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int n_valid = min(kTile, s_end - t0);
    if (threadIdx.x < n_valid) {
      const int s = t0 + threadIdx.x;
      const int blk = tables[static_cast<size_t>(b) * W + s / bt];
      sm.base[threadIdx.x] = head + static_cast<size_t>(blk) * blk_stride +
                             static_cast<size_t>(s % bt) * hs;
    }
    __syncthreads();
    load_tile(sm, kc, vc, n_valid, hs);
    __syncthreads();
    attend_tile(sm, acc, nrows, n_valid, hs, scale, r0, 0, 0);
  }
  const size_t p0 = (static_cast<size_t>(bh) * nsplit + split) * R + r0;
  if (threadIdx.x < nrows) {
    part_m[p0 + threadIdx.x] = sm.m[threadIdx.x];
    part_l[p0 + threadIdx.x] = sm.l[threadIdx.x];
  }
  const int d = threadIdx.x;
  if (d < hs) {
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r < nrows) part_acc[(p0 + r) * hs + d] = acc[r];
  }
}

// pass 2: grid (row tiles, B·hk) — the chunk keys under the causal mask, then the merge
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, const float* __restrict__ part_m,
                   const float* __restrict__ part_l, const float* __restrict__ part_acc,
                   float* __restrict__ out, int R, int g, int T_len, int hs, int nsplit,
                   float scale) {
  __shared__ Smem sm;
  const int r0 = blockIdx.x * kRT;
  const int bh = blockIdx.y;
  const int nrows = min(kRT, R - r0);
  float acc[kRT];
  init_block(sm, acc, q + (static_cast<size_t>(bh) * R + r0) * hs, nrows, hs);
  const size_t chunk = static_cast<size_t>(bh) * T_len * hs;
  const int t_end = min(T_len, (r0 + nrows - 1) / g + 1);  // no row sees later keys
  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    const int n_valid = min(kTile, t_end - t0);
    if (threadIdx.x < n_valid)
      sm.base[threadIdx.x] = chunk + static_cast<size_t>(t0 + threadIdx.x) * hs;
    __syncthreads();
    load_tile(sm, k_new, v_new, n_valid, hs);
    __syncthreads();
    attend_tile(sm, acc, nrows, n_valid, hs, scale, r0, t0, g);
  }
  float m[kRT], l[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    m[r] = sm.m[r];
    l[r] = sm.l[r];
  }
  const int d = threadIdx.x;
  for (int j = 0; j < nsplit; ++j) {
    const size_t p0 = (static_cast<size_t>(bh) * nsplit + j) * R + r0;
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      if (r < nrows) {
        const float pm = part_m[p0 + r];
        const float nm = fmaxf(m[r], pm);
        const float a = expf(m[r] - nm);
        const float ap = expf(pm - nm);
        l[r] = l[r] * a + part_l[p0 + r] * ap;
        if (d < hs) acc[r] = acc[r] * a + part_acc[(p0 + r) * hs + d] * ap;
        m[r] = nm;
      }
    }
  }
  if (d < hs) {
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r < nrows) out[(static_cast<size_t>(bh) * R + r0 + r) * hs + d] = acc[r] / l[r];
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* k_new,
           const void* v_new, const void* tables, const void* lengths, const void* layer,
           void* part_m, void* part_l, void* part_acc, void* out, int B, int hk, int R,
           int g, int T_len, int hs, int n_blocks, int bt, int W, int n_slots, int nsplit,
           int split_slots, float scale, cudaStream_t st) {
  const int row_tiles = (R + kRT - 1) / kRT;
  if (nsplit > 0) {
    paged_split_kernel<T><<<dim3(nsplit, row_tiles, B * hk), kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const int*>(tables), static_cast<const int*>(lengths),
        static_cast<const int*>(layer), static_cast<float*>(part_m),
        static_cast<float*>(part_l), static_cast<float*>(part_acc), hk, R, hs, n_blocks, bt,
        W, n_slots, split_slots, scale);
  }
  paged_merge_kernel<T><<<dim3(row_tiles, B * hk), kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const float*>(part_acc),
      static_cast<float*>(out), R, g, T_len, hs, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, hk, R = T·g, hs) f32; kc/vc: (L, n_blocks, hk, bt, hs) bf16 (cache_bf16 = 1) or
// f32; k_new/v_new: (B, hk, T, hs) in the cache dtype; tables: (B, W) i32; lengths: (B,)
// i32; layer: (1,) i32 — all on the device. part_m/part_l: (B·hk, nsplit, R) f32 and
// part_acc: (B·hk, nsplit, R, hs) f32 scratch; out: (B, hk, R, hs) f32. Slots
// [0, n_slots = n_read·bt) of each table are readable; split j covers slots
// [j·split_slots, (j+1)·split_slots). hs <= 128.
extern "C" int paged_attention(const void* q, const void* kc, const void* vc,
                               const void* k_new, const void* v_new, const void* tables,
                               const void* lengths, const void* layer, void* part_m,
                               void* part_l, void* part_acc, void* out, int cache_bf16,
                               int B, int hk, int R, int g, int T_len, int hs, int n_blocks,
                               int bt, int W, int n_slots, int nsplit, int split_slots,
                               float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_bf16)
    return launch<__nv_bfloat16>(q, kc, vc, k_new, v_new, tables, lengths, layer, part_m,
                                 part_l, part_acc, out, B, hk, R, g, T_len, hs, n_blocks,
                                 bt, W, n_slots, nsplit, split_slots, scale, st);
  return launch<float>(q, kc, vc, k_new, v_new, tables, lengths, layer, part_m, part_l,
                       part_acc, out, B, hk, R, g, T_len, hs, n_blocks, bt, W, n_slots,
                       nsplit, split_slots, scale, st);
}

// Exported tile width, so the wrapper sizes the splits the same way.
extern "C" int paged_attention_tile_slots() { return kTile; }
