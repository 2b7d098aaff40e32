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
// slots >= win are never read at all, so a stale or unwritten slot can touch neither
// the scores nor the values.
//
// What bounds it on an H100: bytes. Each committed slot's k and v rows are read once
// (2·hs·2 bytes per slot and kv head in bf16) for ~4·g·hs flops, far under the ridge.
//
// What the design does: split-K flash decoding. Pass 1 gives each (kv head, 64-slot
// split) its own block; each of its 4 warps walks slots with an online-softmax
// (m, l, acc) carry in registers (lane = hs/32 contiguous dims), the warps merge in
// shared memory, and the block writes one partial (m, l, acc). Pass 2, one block per
// kv head, folds in the current token and merges the splits. Splits keep every SM busy
// at long windows where one block per head (32 heads at 7B) would use a quarter of
// the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;  // cache slots per pass-1 block
constexpr int kMaxG = 8;    // query heads per kv head
constexpr int kMaxD = 4;    // head dims per lane (hs <= 128)
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int g, int hs, int s_len, int end, size_t layer_off, float scale) {
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][kMaxD * 32];
  const int h = blockIdx.x;
  const int j = blockIdx.y;
  const int nsplit = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dims = hs / 32;

  float qr[kMaxG][kMaxD], m[kMaxG], l[kMaxG], acc[kMaxG][kMaxD];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      acc[gi][d] = 0.0f;
      qr[gi][d] = (gi < g && d < dims)
          ? q[(static_cast<size_t>(h) * g + gi) * hs + lane * dims + d] : 0.0f;
    }
  }

  const size_t head_off = layer_off + static_cast<size_t>(h) * s_len * hs;
  const T* kbase = kc + head_off;
  const T* vbase = vc + head_off;
  const int s0 = j * kSplit;
  const int s1 = min(end, s0 + kSplit);
  for (int s = s0 + warp; s < s1; s += kWarps) {
    float kv[kMaxD], vv[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      kv[d] = d < dims ? to_f(kbase[static_cast<size_t>(s) * hs + lane * dims + d]) : 0.0f;
      vv[d] = d < dims ? to_f(vbase[static_cast<size_t>(s) * hs + lane * dims + d]) : 0.0f;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        float part = 0.0f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) part += qr[gi][d] * kv[d];
        const float sc = warp_sum(part) * scale;
        const float mn = fmaxf(m[gi], sc);
        const float a = expf(m[gi] - mn);
        const float p = expf(sc - mn);
        l[gi] = l[gi] * a + p;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) acc[gi][d] = acc[gi][d] * a + p * vv[d];
        m[gi] = mn;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
      if (lane == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < dims) sm_acc[warp][gi][lane * dims + d] = acc[gi][d];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * hs; e += kThreads) {
    const int gi = e / hs;
    const int dd = e % hs;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][gi] - mx);
      lsum += sm_l[w][gi] * f;
      asum += sm_acc[w][gi][dd] * f;
    }
    const size_t pi = (static_cast<size_t>(h) * nsplit + j) * g + gi;
    part_acc[pi * hs + dd] = asum;
    if (dd == 0) {
      part_m[pi] = mx;
      part_l[pi] = lsum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_merge_kernel(const float* __restrict__ q, const T* __restrict__ k_new,
                  const T* __restrict__ v_new, const float* __restrict__ part_m,
                  const float* __restrict__ part_l, const float* __restrict__ part_acc,
                  float* __restrict__ out, int g, int hs, int nsplit, float scale) {
  __shared__ float s_new[kMaxG];
  const int h = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int gi = warp; gi < g; gi += kWarps) {
    float part = 0.0f;
    for (int d = lane; d < hs; d += 32)
      part += q[(static_cast<size_t>(h) * g + gi) * hs + d] *
              to_f(k_new[static_cast<size_t>(h) * hs + d]);
    part = warp_sum(part);
    if (lane == 0) s_new[gi] = part * scale;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * hs; e += kThreads) {
    const int gi = e / hs;
    const int dd = e % hs;
    const size_t p0 = static_cast<size_t>(h) * nsplit * g + gi;
    float mx = s_new[gi];
    for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, part_m[p0 + static_cast<size_t>(j) * g]);
    const float pn = expf(s_new[gi] - mx);
    float lsum = pn;
    float asum = pn * to_f(v_new[static_cast<size_t>(h) * hs + dd]);
    for (int j = 0; j < nsplit; ++j) {
      const size_t pi = p0 + static_cast<size_t>(j) * g;
      const float f = expf(part_m[pi] - mx);
      lsum += part_l[pi] * f;
      asum += part_acc[pi * hs + dd] * f;
    }
    out[(static_cast<size_t>(h) * g + gi) * hs + dd] = asum / lsum;
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* k_new,
           const void* v_new, void* part_m, void* part_l, void* part_acc, void* out,
           int hk, int g, int hs, int s_len, int layer, int end, float scale,
           cudaStream_t st) {
  const int nsplit = (end + kSplit - 1) / kSplit;
  const size_t layer_off = static_cast<size_t>(layer) * hk * s_len * hs;
  if (nsplit > 0) {
    attn_split_kernel<T><<<dim3(hk, nsplit), kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<float*>(part_m), static_cast<float*>(part_l),
        static_cast<float*>(part_acc), g, hs, s_len, end, layer_off, scale);
  }
  attn_merge_kernel<T><<<hk, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const float*>(part_acc),
      static_cast<float*>(out), g, hs, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (hk, g, hs) f32; kc/vc: (L, 1, hk, S, hs) in bf16 (cache_bf16=1) or f32;
// k_new/v_new: (hk, 1, hs) in the cache dtype; part_m/part_l: (hk, nsplit, g) f32 and
// part_acc: (hk, nsplit, g, hs) f32 scratch with nsplit = ceil(end / 64);
// out: (hk, g, hs) f32. end = min(pos, window). hs % 32 == 0, hs <= 128, g <= 8.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* k_new, const void* v_new, void* part_m,
                                void* part_l, void* part_acc, void* out, int cache_bf16,
                                int hk, int g, int hs, int s_len, int layer, int end,
                                float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_bf16)
    return launch<__nv_bfloat16>(q, kc, vc, k_new, v_new, part_m, part_l, part_acc, out,
                                 hk, g, hs, s_len, layer, end, scale, st);
  return launch<float>(q, kc, vc, k_new, v_new, part_m, part_l, part_acc, out, hk, g, hs,
                       s_len, layer, end, scale, st);
}

// Exported split width, so the wrapper sizes the scratch the same way.
extern "C" int decode_attention_split_slots() { return kSplit; }
