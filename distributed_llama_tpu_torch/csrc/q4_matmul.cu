// q4_matmul: Y = X·dequant(W)^T for M > 1 activation rows (prefill chunks, batched
// serving steps) against Q40 weights in the i4p split-plane layout, and its residual
// launch mode q4_matmul_res: Y = R + X·dequant(W)^T.
//
// Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_matmul` (kernel body
// `_mm_kernel` -> `_tile_partial`) and `_q4_matmul_res` (`_mm_res_kernel`, the
// residual in the accumulator init).
//
// What it computes (the same numbers as the TPU kernel): each packed byte c of row n
// decodes to w[n,c] = bf16((lo - 8) * s[n, c/32]) and w[n,K/2+c] =
// bf16((hi - 8) * s[n, K/64 + c/32]), the scale f16 widened to f32 and the product
// rounded once to bf16; X is bf16; the products accumulate in f32.
//
// What bounds it on an H100: at the prefill chunks (M = 8, 64) the 7B projections move
// ~0.56 B/weight and do 2·M flop/weight, i.e. 28-230 flop/byte, under the bf16
// tensor-core ridge (~295 flop/byte): bytes bound it on paper at both M. With one block
// per 64 output columns, a 4096-wide projection fills only 64 of the 132 SMs, and a
// block that waits on each global load in turn is latency-bound long before that.
//
// What the design does: each stage, every thread first issues all of its 16-byte loads
// (packed weights, their f16 scales, X) into registers, then decodes the 64-byte
// column chunk of 64 weight rows into two bf16 shared tiles (the low-nibble and
// high-nibble planes, two quant blocks each) while X lands in two matching tiles, and
// four warps run bf16 tensor-core products (WMMA 16x16x16, f32 accumulate). The K range
// is split over `splits` blocks per output tile so the grid covers the card; each split
// writes an f32 partial and a second pass sums the splits in a fixed order
// (deterministic). The M and N edges and a trailing half chunk are masked; an M tile
// of 16 serves M <= 16.
//
// Residual mode: the residual R (f32 or bf16, (M, N)) is read once in the epilogue
// and added in f32 before the one f32 write: into the block's accumulator when there
// is one split, or as the first term of the fixed-order split sum otherwise. It costs
// one read of R and no extra pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps, each owning 16 of the tile's 64 columns
constexpr int kBN = 64;
constexpr int kBK = 64;        // packed bytes per stage = two quant blocks per plane
constexpr int kLd = kBK + 8;   // padded shared row (bf16 elements, 144 bytes)
constexpr int kLdc = kBN + 4;  // padded accumulator staging row (floats)

// residual element i: kind 0 none, 1 f32, 2 bf16
__device__ __forceinline__ float load_res(const void* res, int kind, size_t i) {
  if (kind == 1) return static_cast<const float*>(res)[i];
  if (kind == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i]);
  return 0.0f;
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
q4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
                 const __half* __restrict__ ws, float* __restrict__ part,
                 const void* __restrict__ res, int res_kind,
                 int m, int n, int k, int chunks_per_split) {
  constexpr int kXSize = 2 * BM * kLd;   // bf16 elements of the two X planes
  constexpr int kWSize = 2 * kBN * kLd;  // bf16 elements of the two W planes
  static_assert(BM * kLdc * 4 <= (kXSize + kWSize) * 2, "staging must fit the tiles");
  __shared__ __align__(32) unsigned char smem[(kXSize + kWSize) * 2];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][kLd]
  __nv_bfloat16* wsh = xs + kXSize;                            // [2][kBN][kLd]
  float* cs = reinterpret_cast<float*>(smem);                  // [BM][kLdc], after the loop

  const int kh = k / 2;
  const int nb = k / 32;
  const int half_nb = nb / 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int c_begin = blockIdx.z * chunks_per_split * kBK;
  const int c_end = min(kh, c_begin + chunks_per_split * kBK);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

  constexpr int kWPer = kBN * kBK / 16 / kThreads;  // 16-byte weight loads per thread
  constexpr int kXPer = 2 * BM * kBK / 8 / kThreads;  // 16-byte X loads per thread
  for (int c0 = c_begin; c0 < c_end; c0 += kBK) {
    uint4 wv[kWPer], xv[kXPer];
    float slo[kWPer], shi[kWPer];
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / (kBK / 16);
      const int c = c0 + (idx % (kBK / 16)) * 16;
      const int row = n0 + r;
      wv[j] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      slo[j] = shi[j] = 0.0f;
      if (row < n && c < kh) {
        wv[j] = *reinterpret_cast<const uint4*>(wp + static_cast<size_t>(row) * kh + c);
        const __half* srow = ws + static_cast<size_t>(row) * nb;
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
      const int r = idx / (kBK / 16);
      const int c = (idx % (kBK / 16)) * 16;
      decode16(wv[j], slo[j], shi[j], wsh + r * kLd + c, wsh + (kBN + r) * kLd + c);
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
        wmma::load_matrix_sync(bf, wsh + (p * kBN + warp * 16) * kLd + kk, kLd);
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
  float* out = part + static_cast<size_t>(blockIdx.z) * m * n;
  const int kind = gridDim.z == 1 ? res_kind : 0;  // split partials carry no residual
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    if (m0 + r < m && n0 + c < n) {
      const size_t o = static_cast<size_t>(m0 + r) * n + n0 + c;
      out[o] = load_res(res, kind, o) + cs[r * kLdc + c];
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                                  const void* __restrict__ res, int res_kind, int splits,
                                  size_t count) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = load_res(res, res_kind, i);
    for (int z = 0; z < splits; ++z) s += part[z * count + i];
    y[i] = s;
  }
}

int launch(const void* x, const void* wp, const void* ws, const void* res, int res_kind,
           void* y, void* part, int m, int n, int k, int splits, cudaStream_t st) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* s = static_cast<const __half*>(ws);
  const int chunks = (k / 2 + kBK - 1) / kBK;
  const int per_split = (chunks + splits - 1) / splits;
  splits = (chunks + per_split - 1) / per_split;  // no empty split
  float* out = static_cast<float*>(splits > 1 ? part : y);
  if (m <= 16) {
    const dim3 grid((n + kBN - 1) / kBN, (m + 15) / 16, splits);
    q4_matmul_kernel<16><<<grid, kThreads, 0, st>>>(xb, w, s, out, res, res_kind, m, n, k,
                                                    per_split);
  } else {
    const dim3 grid((n + kBN - 1) / kBN, (m + 63) / 64, splits);
    q4_matmul_kernel<64><<<grid, kThreads, 0, st>>>(xb, w, s, out, res, res_kind, m, n, k,
                                                    per_split);
  }
  if (splits > 1) {
    const size_t count = static_cast<size_t>(m) * n;
    const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
    sum_splits_kernel<<<blocks, 256, 0, st>>>(out, static_cast<float*>(y), res, res_kind,
                                              splits, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, k) bf16, 16-byte aligned; wp: (n, k/2) u8 i4p, 16-byte aligned;
// ws: (n, k/32) f16; y: (m, n) f32; part: (splits, m, n) f32 scratch when splits > 1
// (unused otherwise). k % 64 == 0. The K range splits into `splits` parts of whole
// 64-byte chunks.
extern "C" int q4_matmul(const void* x, const void* wp, const void* ws, void* y,
                         void* part, int m, int n, int k, int splits, void* stream) {
  return launch(x, wp, ws, nullptr, 0, y, part, m, n, k, splits,
                static_cast<cudaStream_t>(stream));
}

// As q4_matmul, plus res: (m, n) residual, f32 (res_bf16 = 0) or bf16 (res_bf16 = 1),
// added in f32: y = res + x·dequant(w)^T.
extern "C" int q4_matmul_res(const void* x, const void* wp, const void* ws, const void* res,
                             int res_bf16, void* y, void* part, int m, int n, int k,
                             int splits, void* stream) {
  return launch(x, wp, ws, res, res_bf16 ? 2 : 1, y, part, m, n, k, splits,
                static_cast<cudaStream_t>(stream));
}
