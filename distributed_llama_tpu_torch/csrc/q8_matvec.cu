// q8_matvec: y = W·x for one activation row against weights in the int8-plane (i8)
// layout: W8 int8 (n, k) in natural column order, f32 block scales s (n, k/32).
//
// Replaces distributed_llama_tpu/ops/pallas_q8.py `_q8_matvec` (kernel bodies
// `_matvec_kernel` and the precise `_matvec_kernel_f32`) together with the Q80 row
// quantizer `_quantize_row` that feeds it, and `_q8_matvec_inline`
// (`_matvec_kernel_inline`), which takes the row the fused prologue quantized. Three
// entries over one row loop:
//   q8_matvec      x f32/bf16 is quantized to Q80 in the kernel:
//                    xq[j] = round_half_even(x[j] * (127 / absmax_b)), sx[b] = absmax_b/127
//   q8_matvec_q80  xq int8 and sx f32 come in already quantized
//   both:          P[n,b] = sum_{j in block b} W8[n,j] * xq[j]          (int32, exact)
//                  y[n]   = sum_b (s[n,b] * sx[b]) * P[n,b]              (f32)
//   q8_matvec_precise  x f32/bf16 stays unquantized, sx = 1:
//                  P[n,b] = sum_{j in block b} W8[n,j] * x[j]           (f32 sums)
//                  y[n]   = sum_b s[n,b] * P[n,b]
//
// What bounds it on an H100: bytes. One decode token streams every weight once at
// 1.125 B/weight (1 B of int8 plus a 4-byte scale per 32) and does 2 integer ops per
// weight, far below the int8 tensor-core rate, so the time floor is weight and scale
// bytes over the memory rate: twice the Q40 (i4p) floor for the same model.
//
// What the design does about it: one warp per output row, grid-strided over rows. Each
// lane reads 16 bytes of weights per load (a lane pair covers one 32-byte quant block),
// so a warp moves 512 contiguous bytes per load, and each lane issues two such loads
// before it uses either, to keep more bytes in flight. The block dot is __dp4a,
// signed x signed, against xq staged once per block in shared memory (K + 4·K/32 bytes)
// and read as 16-byte vectors, so only weights and scales come from device memory per
// row. The epilogue multiplies s[n,b]·sx[b] first, then P, in the TPU kernel's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kQuantize = 0, kPrequantized = 1, kPrecise = 2 };

__device__ __forceinline__ float load_x(const void* x, int x_bf16, int j) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[j])
                : reinterpret_cast<const float*>(x)[j];
}

// the int32 dot of 16 int8 weights with 16 int8 activations
__device__ __forceinline__ int dot16(const int4 w, const int4 a) {
  int p = __dp4a(w.x, a.x, 0);
  p = __dp4a(w.y, a.y, p);
  p = __dp4a(w.z, a.z, p);
  return __dp4a(w.w, a.w, p);
}

// the f32 dot of 16 int8 weights with 16 f32 activations, in index order
__device__ __forceinline__ float dot16f(const int4 w, const float* a) {
  const int words[4] = {w.x, w.y, w.z, w.w};
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float wv = static_cast<float>(static_cast<int8_t>(words[i] >> (8 * b)));
      p = fmaf(wv, a[4 * i + b], p);
    }
  }
  return p;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
q8_matvec_kernel(const void* __restrict__ x, int x_bf16,
                 const int8_t* __restrict__ xq_in, const float* __restrict__ sx_in,
                 const int8_t* __restrict__ w8, const float* __restrict__ ws,
                 float* __restrict__ y, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = k / 32;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);            // k bytes (int8 modes)
  float* sx = reinterpret_cast<float*>(smem + k);          // nb floats (int8 modes)
  float* xf = reinterpret_cast<float*>(smem);              // k floats (precise mode)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (kMode == kQuantize) {
    // Q80 quantization of the row, one warp per 32-block (ops/pallas_q8.py
    // _quantize_row): a true division for 127/absmax and absmax/127, round half to even
    for (int b = warp; b < nb; b += kWarps) {
      const int j = b * 32 + lane;
      const float v = load_x(x, x_bf16, j);
      float a = fabsf(v);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
      const float inv = a > 0.f ? 127.0f / a : 0.f;
      xq[j] = static_cast<int8_t>(__float2int_rn(v * inv));
      if (lane == 0) sx[b] = a / 127.0f;
    }
  } else if (kMode == kPrequantized) {
    for (int c = threadIdx.x; c < k / 16; c += kThreads)
      reinterpret_cast<int4*>(xq)[c] = reinterpret_cast<const int4*>(xq_in)[c];
    for (int b = threadIdx.x; b < nb; b += kThreads) sx[b] = sx_in[b];
  } else {
    for (int j = threadIdx.x; j < k; j += kThreads) xf[j] = load_x(x, x_bf16, j);
  }
  __syncthreads();

  const int sub = lane >> 1;         // block within the warp's 16-block load
  const int part = (lane & 1) * 16;  // which 16 bytes of the block this lane reads
  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const int8_t* wrow = w8 + static_cast<size_t>(row) * k;
    const float* srow = ws + static_cast<size_t>(row) * nb;
    float acc = 0.f;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      // two 16-block loads in flight per lane before either is used
      const int ba = b0 + sub, bb = b0 + 16 + sub;
      const bool va = ba < nb, vb = bb < nb;
      const int offa = ba * 32 + part, offb = bb * 32 + part;
      int4 wa = make_int4(0, 0, 0, 0), wb = make_int4(0, 0, 0, 0);
      if (va) wa = *reinterpret_cast<const int4*>(wrow + offa);
      if (vb) wb = *reinterpret_cast<const int4*>(wrow + offb);
      if (kMode == kPrecise) {
        float pa = va ? dot16f(wa, xf + offa) : 0.f;
        float pb = vb ? dot16f(wb, xf + offb) : 0.f;
        pa += __shfl_xor_sync(kFull, pa, 1);
        pb += __shfl_xor_sync(kFull, pb, 1);
        if (part == 0) {
          if (va) acc += srow[ba] * pa;
          if (vb) acc += srow[bb] * pb;
        }
      } else {
        int pa = va ? dot16(wa, *reinterpret_cast<const int4*>(xq + offa)) : 0;
        int pb = vb ? dot16(wb, *reinterpret_cast<const int4*>(xq + offb)) : 0;
        pa += __shfl_xor_sync(kFull, pa, 1);
        pb += __shfl_xor_sync(kFull, pb, 1);
        if (part == 0) {
          if (va) acc += (srow[ba] * sx[ba]) * static_cast<float>(pa);
          if (vb) acc += (srow[bb] * sx[bb]) * static_cast<float>(pb);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) y[row] = acc;
  }
}

size_t smem_bytes(int mode, int k) {
  return mode == kPrecise ? 4 * static_cast<size_t>(k)
                          : static_cast<size_t>(k) + 4 * static_cast<size_t>(k / 32);
}

}  // namespace

// x: (k,) f32 or bf16 (x_bf16); w8: (n, k) int8; ws: (n, k/32) f32; y: (n,) f32.
// precise != 0 takes x unquantized (sx = 1). Requires k % 32 == 0, a 16-byte aligned w8
// and, with precise, 4·k bytes of shared memory (k <= 12288). grid: blocks to launch.
extern "C" int q8_matvec(const void* x, int x_bf16, int precise, const void* w8,
                         const void* ws, void* y, int n, int k, int grid, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const int8_t*>(w8);
  const auto s = static_cast<const float*>(ws);
  const auto out = static_cast<float*>(y);
  if (precise) {
    q8_matvec_kernel<kPrecise><<<grid, kThreads, smem_bytes(kPrecise, k), st>>>(
        x, x_bf16, nullptr, nullptr, w, s, out, n, k);
  } else {
    q8_matvec_kernel<kQuantize><<<grid, kThreads, smem_bytes(kQuantize, k), st>>>(
        x, x_bf16, nullptr, nullptr, w, s, out, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq: (k,) int8, 16-byte aligned, and sx: (k/32,) f32, the Q80 row; the rest as
// q8_matvec.
extern "C" int q8_matvec_q80(const void* xq, const void* sx, const void* w8,
                             const void* ws, void* y, int n, int k, int grid,
                             void* stream) {
  q8_matvec_kernel<kPrequantized>
      <<<grid, kThreads, smem_bytes(kPrequantized, k), static_cast<cudaStream_t>(stream)>>>(
          nullptr, 0, static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
          static_cast<const int8_t*>(w8), static_cast<const float*>(ws),
          static_cast<float*>(y), n, k);
  return static_cast<int>(cudaGetLastError());
}
