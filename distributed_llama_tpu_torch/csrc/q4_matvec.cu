// q4_matvec: y = W·x for one activation row against Q40 weights in the i4p
// split-plane layout, with x quantized to Q80 inside the kernel (entry `q4_matvec`) or
// given already quantized as xq int8 + sx f32 block scales (entry `q4_matvec_q80`).
//
// Replaces distributed_llama_tpu/ops/pallas_q4.py `_q4_matvec` (kernel body
// `_matvec_kernel` -> `_unpack_dot_epilogue`) together with the Q80 row quantizer
// `_quantize_row` of ops/pallas_q8.py that feeds it, and `_q4_matvec_inline`
// (`_matvec_kernel_inline`), which takes the row the fused prologue quantized. The two
// entries share the row loop; only the staging of the row into shared memory differs.
//
// What it computes (the same numbers as the TPU kernel):
//   xq[j] = round_half_even(x[j] * (127 / absmax_b)), sx[b] = absmax_b / 127
//   P[n,b] = sum_{j in block b} (q[n,j] - 8) * xq[j]        (int32, exact)
//   y[n]   = sum_b (f16(s[n,b]) * sx[b]) * P[n,b]            (f32)
// where byte c of packed row n holds q[n,c] in its low nibble and q[n,c+K/2] in its
// high nibble. The -8 offset is removed through the block sums of xq.
//
// What bounds it on an H100: bytes. One decode token streams every weight once at
// 0.5625 B/weight and does ~2 integer ops per weight, far below the int8 tensor-core
// rate, so the time floor is packed bytes over the memory rate.
//
// What the design does about it: one warp per output row, each lane reading 16 packed
// bytes per step (a lane pair covers one 32-byte chunk = one quant block of each plane),
// so a warp moves 512 contiguous bytes per step; the block dot is __dp4a on nibbles
// masked straight out of the 32-bit words, with no unpacking to memory. The activation
// row is quantized once per block into shared memory (K + 8*K/32 bytes), so nothing but
// the weights and scales comes from device memory per row. Grid-strided rows keep a
// fixed number of resident blocks whatever N is.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// kPreq: the row arrives quantized (xq_in, sx_in) instead of as floats (x, x_bf16)
template <bool kPreq>
__global__ void __launch_bounds__(kThreads)
q4_matvec_kernel(const void* __restrict__ x, int x_bf16,
                 const int8_t* __restrict__ xq_in, const float* __restrict__ sx_in,
                 const uint8_t* __restrict__ wp, const __half* __restrict__ ws,
                 float* __restrict__ y, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = k / 32;
  const int kh = k / 2;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);                 // k bytes
  float* sx = reinterpret_cast<float*>(smem + k);               // nb floats
  int* ssum = reinterpret_cast<int*>(smem + k + 4 * nb);        // nb ints
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Q80 quantization of the row, one warp per 32-block (ops/pallas_q8.py _quantize_row);
  // a pre-quantized row is copied with its scales. Either way each block's sum of xq
  // goes to ssum for the nibble offset.
  for (int b = warp; b < nb; b += kWarps) {
    const int j = b * 32 + lane;
    if (kPreq) {
      const int q = xq_in[j];
      xq[j] = static_cast<int8_t>(q);
      int s = q;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) {
        sx[b] = sx_in[b];
        ssum[b] = s;
      }
      continue;
    }
    const float v = x_bf16
        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[j])
        : reinterpret_cast<const float*>(x)[j];
    float a = fabsf(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
    const float inv = a > 0.f ? 127.0f / a : 0.f;
    const int q = __float2int_rn(v * inv);
    xq[j] = static_cast<int8_t>(q);
    int s = q;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) {
      sx[b] = a / 127.0f;
      ssum[b] = s;
    }
  }
  __syncthreads();

  // chunk c of a packed row = bytes [32c, 32c+32): quant block c of the low plane and
  // block c + nb/2 of the high plane
  const int chunks = kh / 32;
  const int half_nb = nb / 2;
  const int sub = lane >> 1;        // chunk within the warp's 16-chunk step
  const int part = (lane & 1) * 16; // which 16 bytes of the chunk this lane reads
  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const uint8_t* wrow = wp + static_cast<size_t>(row) * kh;
    const __half* srow = ws + static_cast<size_t>(row) * nb;
    float acc = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += 16) {
      const int c = c0 + sub;
      int plo = 0, phi = 0;
      if (c < chunks) {
        const int off = c * 32 + part;
        const uint4 w = *reinterpret_cast<const uint4*>(wrow + off);
        const int* xlo = reinterpret_cast<const int*>(xq + off);
        const int* xhi = reinterpret_cast<const int*>(xq + kh + off);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          plo = __dp4a(static_cast<int>(words[i] & 0x0F0F0F0Fu), xlo[i], plo);
          phi = __dp4a(static_cast<int>((words[i] >> 4) & 0x0F0F0F0Fu), xhi[i], phi);
        }
      }
      plo += __shfl_xor_sync(kFull, plo, 1);
      phi += __shfl_xor_sync(kFull, phi, 1);
      if (c < chunks && part == 0) {
        const int blo = c, bhi = c + half_nb;
        const int p_lo = plo - 8 * ssum[blo];
        const int p_hi = phi - 8 * ssum[bhi];
        acc += (__half2float(srow[blo]) * sx[blo]) * static_cast<float>(p_lo);
        acc += (__half2float(srow[bhi]) * sx[bhi]) * static_cast<float>(p_hi);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) y[row] = acc;
  }
}

}  // namespace

static size_t smem_bytes(int k) {
  return static_cast<size_t>(k) + 8 * static_cast<size_t>(k / 32);
}

// x: (k,) f32 or bf16 (x_bf16); wp: (n, k/2) u8 i4p; ws: (n, k/32) f16; y: (n,) f32.
// Requires k % 64 == 0 and 16-byte aligned wp. grid: number of blocks to launch.
extern "C" int q4_matvec(const void* x, int x_bf16, const void* wp, const void* ws,
                         void* y, int n, int k, int grid, void* stream) {
  q4_matvec_kernel<false><<<grid, kThreads, smem_bytes(k),
                            static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, nullptr, nullptr, static_cast<const uint8_t*>(wp),
      static_cast<const __half*>(ws), static_cast<float*>(y), n, k);
  return static_cast<int>(cudaGetLastError());
}

// xq: (k,) int8 and sx: (k/32,) f32, the Q80 row; the rest as q4_matvec.
extern "C" int q4_matvec_q80(const void* xq, const void* sx, const void* wp,
                             const void* ws, void* y, int n, int k, int grid,
                             void* stream) {
  q4_matvec_kernel<true><<<grid, kThreads, smem_bytes(k),
                           static_cast<cudaStream_t>(stream)>>>(
      nullptr, 0, static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(wp), static_cast<const __half*>(ws),
      static_cast<float*>(y), n, k);
  return static_cast<int>(cudaGetLastError());
}
