// q4_gated_matmul: the FFN gate pair Y = act(X·dequant(W1)^T) · (X·dequant(W3)^T) for
// M > 1 activation rows against two Q40 weights in the i4p split-plane layout, with
// act = silu or tanh-GELU in f32.
//
// Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_gated_matmul` (kernel body
// `_gated_mm_kernel`: two accumulators over one x tile, the activation epilogue on the
// last K step; formulas `_act_f32`).
//
// What it computes (the same numbers as the TPU kernel): each weight decodes as
// bf16((q - 8) · f32(s)) exactly as csrc/q4_matmul.cu does, X is bf16, both products
// accumulate in f32, and the epilogue applies act to the FULL f32 sum of the gate
// product before multiplying by the up product: silu(a) = a / (1 + exp(-a)),
// gelu_tanh(a) = 0.5·a·(1 + tanh(c·a·(1 + 0.044715·a²))), c = sqrt(2/pi).
//
// What bounds it on an H100: the two weight streams. At the serving shapes (M = 8..512
// rows, 11008x4096 each at 7B) it moves ~0.56 B/weight for 2·M flop/weight: under the
// bf16 tensor-core ridge (~295 flop/byte) up to M ~ 80, so bytes bound it in decode and
// operations at the 64-token prefill chunks. The (M, N) intermediates never reach
// device memory: the gate and up products meet in shared memory.
//
// What the design does: one block owns a 32-column slice of BOTH weights. Each 64-byte
// K stage loads the x tile once, decodes the W1 and W3 nibble tiles into bf16 shared
// tiles, and four warps run WMMA 16x16x16 bf16 products with f32 accumulators: warps
// 0-1 on W1's two 16-column halves, warps 2-3 on W3's. The K range splits over
// `splits` blocks when the column tiles alone do not cover the card; the activation
// then runs in the second pass, on the fixed-order sum of the split partials, never on
// a partial. The M and N edges are masked; an M tile of 16 serves M <= 16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps: 2 per weight, 16 columns each
constexpr int kBN = 32;        // output columns per block (per weight)
constexpr int kBK = 64;        // packed bytes per stage = two quant blocks per plane
constexpr int kLd = kBK + 8;   // padded shared row (bf16 elements)
constexpr int kLdc = 2 * kBN + 4;  // staging row: [gate 32 | up 32 | pad]

__device__ __forceinline__ float act_f32(float a, int act) {
  if (act == 0) return a / (1.0f + expf(-a));
  const float c = 0.79788456080286535587989211986876f;  // sqrt(2/pi)
  return 0.5f * a * (1.0f + tanhf(c * a * (1.0f + 0.044715f * a * a)));
}

__device__ __forceinline__ void decode16(uint4 w, float s_lo, float s_hi,
                                         __nv_bfloat16* lo, __nv_bfloat16* hi) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned byte = (words[i] >> (8 * b)) & 0xFFu;
      lo[4 * i + b] = __float2bfloat16((static_cast<float>(byte & 15u) - 8.0f) * s_lo);
      hi[4 * i + b] = __float2bfloat16((static_cast<float>(byte >> 4) - 8.0f) * s_hi);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
gated_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w1p,
             const __half* __restrict__ w1s, const uint8_t* __restrict__ w3p,
             const __half* __restrict__ w3s, float* __restrict__ y,
             float* __restrict__ part, int m, int n, int k, int chunks_per_split, int act) {
  constexpr int kXSize = 2 * BM * kLd;       // bf16 elements of the two X planes
  constexpr int kWSize = 2 * 2 * kBN * kLd;  // [weight][plane][row][kLd]
  static_assert(BM * kLdc * 4 <= (kXSize + kWSize) * 2, "staging must fit the tiles");
  __shared__ __align__(32) unsigned char smem[(kXSize + kWSize) * 2];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsh = xs + kXSize;
  float* cs = reinterpret_cast<float*>(smem);  // [BM][kLdc], after the loop

  const int kh = k / 2;
  const int nb = k / 32;
  const int half_nb = nb / 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int c_begin = blockIdx.z * chunks_per_split * kBK;
  const int c_end = min(kh, c_begin + chunks_per_split * kBK);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wsel = warp >> 1;   // 0: W1 (gate), 1: W3 (up)
  const int wcol = warp & 1;    // which 16-column half

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

  constexpr int kWPer = 2 * kBN * kBK / 16 / kThreads;  // 16-byte weight loads / thread
  constexpr int kXPer = 2 * BM * kBK / 8 / kThreads;    // 16-byte X loads / thread
  for (int c0 = c_begin; c0 < c_end; c0 += kBK) {
    uint4 wv[kWPer], xv[kXPer];
    float slo[kWPer], shi[kWPer];
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int idx = tid + j * kThreads;
      const int wi = idx / (kBN * (kBK / 16));
      const int r = (idx / (kBK / 16)) % kBN;
      const int c = c0 + (idx % (kBK / 16)) * 16;
      const int row = n0 + r;
      wv[j] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      slo[j] = shi[j] = 0.0f;
      if (row < n && c < kh) {
        const uint8_t* wp = wi ? w3p : w1p;
        const __half* srow = (wi ? w3s : w1s) + static_cast<size_t>(row) * nb;
        wv[j] = *reinterpret_cast<const uint4*>(wp + static_cast<size_t>(row) * kh + c);
        slo[j] = __half2float(srow[c / 32]);
        shi[j] = __half2float(srow[half_nb + c / 32]);
      }
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int idx = tid + j * kThreads;
      const int p = idx / (BM * kBK / 8);
      const int r = (idx / (kBK / 8)) % BM;
      const int c = c0 + (idx % (kBK / 8)) * 8;
      const int row = m0 + r;
      xv[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < m && c < kh)
        xv[j] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * k + p * kh + c);
    }
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int idx = tid + j * kThreads;
      const int wi = idx / (kBN * (kBK / 16));
      const int r = (idx / (kBK / 16)) % kBN;
      const int c = (idx % (kBK / 16)) * 16;
      __nv_bfloat16* base = wsh + (wi * 2 * kBN) * kLd;
      decode16(wv[j], slo[j], shi[j], base + r * kLd + c, base + (kBN + r) * kLd + c);
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int idx = tid + j * kThreads;
      const int p = idx / (BM * kBK / 8);
      const int r = (idx / (kBK / 8)) % BM;
      const int c = (idx % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + (p * BM + r) * kLd + c) = xv[j];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, wsh + ((wsel * 2 + p) * kBN + wcol * 16) * kLd + kk, kLd);
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, xs + (p * BM + i * 16) * kLd + kk, kLd);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
    wmma::store_matrix_sync(cs + i * 16 * kLdc + warp * 16, acc[i], kLdc,
                            wmma::mem_row_major);
  __syncthreads();
  const size_t count = static_cast<size_t>(m) * n;
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    if (m0 + r < m && n0 + c < n) {
      const size_t o = static_cast<size_t>(m0 + r) * n + n0 + c;
      const float a1 = cs[r * kLdc + c];
      const float a3 = cs[r * kLdc + kBN + c];
      if (gridDim.z == 1) {
        y[o] = act_f32(a1, act) * a3;
      } else {  // split partials: [split][gate|up][m][n]
        part[(2 * static_cast<size_t>(blockIdx.z)) * count + o] = a1;
        part[(2 * static_cast<size_t>(blockIdx.z) + 1) * count + o] = a3;
      }
    }
  }
}

// second pass: fixed-order sums of the split partials, then the activation epilogue
__global__ void gated_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                                 int splits, size_t count, int act) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a1 = 0.0f, a3 = 0.0f;
    for (int z = 0; z < splits; ++z) {
      a1 += part[(2 * static_cast<size_t>(z)) * count + i];
      a3 += part[(2 * static_cast<size_t>(z) + 1) * count + i];
    }
    y[i] = act_f32(a1, act) * a3;
  }
}

}  // namespace

// x: (m, k) bf16, 16-byte aligned; w1p/w3p: (n, k/2) u8 i4p, 16-byte aligned;
// w1s/w3s: (n, k/32) f16; y: (m, n) f32; part: (splits, 2, m, n) f32 scratch when
// splits > 1 (unused otherwise); act: 0 silu, 1 gelu_tanh. k % 64 == 0.
extern "C" int q4_gated_matmul(const void* x, const void* w1p, const void* w1s,
                               const void* w3p, const void* w3s, void* y, void* part,
                               int m, int n, int k, int splits, int act, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* a = static_cast<const uint8_t*>(w1p);
  const auto* as = static_cast<const __half*>(w1s);
  const auto* b = static_cast<const uint8_t*>(w3p);
  const auto* bs = static_cast<const __half*>(w3s);
  const int chunks = (k / 2 + kBK - 1) / kBK;
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;  // no empty split
  float* yo = static_cast<float*>(y);
  float* po = static_cast<float*>(part);
  if (m <= 16) {
    const dim3 grid((n + kBN - 1) / kBN, (m + 15) / 16, splits);
    gated_kernel<16><<<grid, kThreads, 0, st>>>(xb, a, as, b, bs, yo, po, m, n, k,
                                                per_split, act);
  } else {
    const dim3 grid((n + kBN - 1) / kBN, (m + 63) / 64, splits);
    gated_kernel<64><<<grid, kThreads, 0, st>>>(xb, a, as, b, bs, yo, po, m, n, k,
                                                per_split, act);
  }
  if (splits > 1) {
    const size_t count = static_cast<size_t>(m) * n;
    const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
    gated_sum_kernel<<<blocks, 256, 0, st>>>(po, yo, splits, count, act);
  }
  return static_cast<int>(cudaGetLastError());
}
