// prologue: the fused activation prologue of the decode matvecs. One activation row is
// (optionally rms-normalized and) quantized to Q80 in one pass:
//   rmsnorm_q80   ms = sum(x^2) / k, inv = 1 / sqrt(ms + eps), xb = (x * inv) * w
//   quantize_q80  xb = x
//   both:         xq[j] = round_half_even(xb[j] * (127 / absmax_b)), sx[b] = absmax_b / 127
// with x f32 or bf16 (widened exactly), w f32, every step in f32.
//
// Replaces distributed_llama_tpu/ops/pallas_prologue.py `_rmsnorm_q80`
// (`_rmsnorm_q80_kernel`) and `_quantize` (`_quantize_kernel`), whose shared epilogue is
// ops/pallas_q8.py `_quantize_row`.
//
// Bit-exactness: the quantize step depends only on each block's absmax, which does not
// depend on the order of a reduction, so quantize_q80 gives the plain version's xq and
// sx exactly. The divisions are true IEEE divisions and the square root is sqrtf (no
// fast-math, no rsqrtf, no __fdividef), as torch computes them; each square is rounded
// before it is summed (__fmul_rn), as torch's x*x is. Only the order of the sum of
// squares differs from torch.mean, so rmsnorm_q80 may move an element that sits within
// an ulp of a rounding tie by one step.
//
// What bounds it on an H100: launch latency. At k = 4096 it reads ~32 KB and writes
// ~4.6 KB, about 0.01 us at the memory rate; a launch costs microseconds. The design is
// one CTA of 1024 threads for the one row: a block reduction of the squares (warp
// shuffles, then one value per warp through shared memory), then each warp owns one
// 32-block at a time, takes its absmax with shuffles and stores the block's int8 values
// and its scale. The row is read twice, the second time from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_x(const void* x, int x_bf16, int j) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[j])
                : reinterpret_cast<const float*>(x)[j];
}

template <bool kNorm>
__global__ void __launch_bounds__(kThreads)
prologue_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ w,
                float eps, int8_t* __restrict__ xq, float* __restrict__ sx, int k) {
  __shared__ float partial[kWarps];
  __shared__ float inv_shared;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float inv = 1.f;
  if (kNorm) {
    float ss = 0.f;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      const float v = load_x(x, x_bf16, j);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = partial[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
      if (lane == 0) {
        const float ms = t / static_cast<float>(k);
        inv_shared = 1.0f / sqrtf(ms + eps);
      }
    }
    __syncthreads();
    inv = inv_shared;
  }
  const int nb = k / 32;
  for (int b = warp; b < nb; b += kWarps) {
    const int j = b * 32 + lane;
    float v = load_x(x, x_bf16, j);
    if (kNorm) v = __fmul_rn(__fmul_rn(v, inv), w[j]);
    float a = fabsf(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
    const float scale = a > 0.f ? 127.0f / a : 0.f;
    xq[j] = static_cast<int8_t>(__float2int_rn(v * scale));
    if (lane == 0) sx[b] = a / 127.0f;
  }
}

}  // namespace

// x: (k,) f32 or bf16 (x_bf16); w: (k,) f32 (unused when norm == 0); xq: (k,) int8;
// sx: (k/32,) f32. Requires k % 32 == 0. norm != 0: rmsnorm_q80, else quantize_q80.
extern "C" int prologue_q80(const void* x, int x_bf16, const void* w, float eps, int norm,
                            void* xq, void* sx, int k, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto wf = static_cast<const float*>(w);
  const auto q = static_cast<int8_t*>(xq);
  const auto s = static_cast<float*>(sx);
  if (norm) {
    prologue_kernel<true><<<1, kThreads, 0, st>>>(x, x_bf16, wf, eps, q, s, k);
  } else {
    prologue_kernel<false><<<1, kThreads, 0, st>>>(x, x_bf16, wf, eps, q, s, k);
  }
  return static_cast<int>(cudaGetLastError());
}
