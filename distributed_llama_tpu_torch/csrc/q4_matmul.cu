// q4_matmul: Y = X·dequant(W)^T for M > 1 activation rows (prefill chunks, batched
// serving steps) against Q40 weights in the i4p split-plane layout, and its residual
// mode: Y = R + X·dequant(W)^T. One launch per call over the block body of
// q4_mm_tile.cuh with one weight stream.
//
// Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_matmul` (kernel body
// `_mm_kernel` -> `_tile_partial`) and `_q4_matmul_res` (`_mm_res_kernel`, the
// residual in the accumulator init).
//
// What it computes (the same numbers as the TPU kernel): w[n,c] = bf16((lo - 8) ·
// s[n, c/32]) and w[n,K/2+c] = bf16((hi - 8) · s[n, K/64 + c/32]) for packed byte c of
// row n, the f16 scale widened to f32 and the product rounded once; X bf16; f32 sums;
// the residual (f32 or bf16) added in f32 once, to the full sum; the result rounded once
// to the caller's dtype.
//
// What bounds it on an H100: at the decode and 8-token steps (M = 8, 64) the 7B
// projections move ~0.56 B per weight for 2·M flop per weight, under the bf16 ridge
// (~295 flop/byte): bytes. At M = 512 (1024 flop per weight byte) the tensor cores.
//
// What the design does (q4_mm_tile.cuh): the weights are decoded in registers straight
// into the MMA's A operand, once per block, with the activations as its 8-wide B side,
// behind a ring that the copy engine fills (tensor copies of X and weight boxes); K
// splits so that one wave of blocks covers the card, and the last split block of a tile
// sums the splits in order. Tiles by M (weight rows x activation rows, warps, chunks of
// 32 packed bytes per stage, stages, products), chosen on an H100 among the variants
// measured:
//   M <= 8:  64 x 8,   4 warps, 4, 4, mma.sync     M <= 16: 64 x 16, 4 warps, 4, 4, mma.sync
//   M <= 64: 64 x 64,  4 warps, 2, 3, wgmma n64    M > 64: 64 x 128, 4 warps, 2, 2, wgmma n128
// Above 64 rows an activation tile is 128 rows: a weight tile is decoded once per 128
// activation rows (4 times at M = 512), its bytes read from device memory once (the
// activation tiles of one weight tile are neighbouring items); a wider tile's f32
// accumulators or X boxes would cost the card its second and third resident blocks.

#include "q4_mm_tile.cuh"

namespace {

using C0 = q4mm::Cfg<1, 1, 1, 4, 1, 4, 4>;
using C1 = q4mm::Cfg<1, 1, 2, 4, 1, 4, 4>;
using C2 = q4mm::Cfg<1, 1, 8, 4, 1, 2, 3, 1>;
using C3 = q4mm::Cfg<1, 1, 16, 4, 1, 2, 2, 1>;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    q4_matmul_tc_kernel(const __grid_constant__ q4mm::Params p) {
  q4mm::run<C>(p);
}

}  // namespace

// x: (m, k) bf16; wp: (n, k/2) u8 i4p; ws: (n, k/32) f16; res: (m, n) f32 (res_kind 1)
// or bf16 (2), or null (0); y: (m, n) f32 (out_kind 0) or bf16 (1); part: the
// split workspace and counters: (tiles) int32, zero, left zero (both unused when
// splits == 1); cfg: the tile of the table above (0-3); splits of per_split chunks of
// 32 packed bytes; grid blocks. k % 64 == 0.
extern "C" int q4_matmul(const void* x, const void* wp, const void* ws, const void* res,
                         int res_kind, void* y, int out_kind, void* part, void* counters,
                         int m, int n, int k, int cfg, int splits, int per_split, int grid,
                         void* stream) {
  q4mm::Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp[0] = p.wp[1] = static_cast<const uint8_t*>(wp);
  p.ws[0] = p.ws[1] = static_cast<const __half*>(ws);
  p.res = res;
  p.y = y;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.n = n;
  p.k = k;
  p.res_kind = res_kind;
  p.out_kind = out_kind;
  p.splits = splits;
  p.per_split = per_split;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return q4mm::launch<C0>(q4_matmul_tc_kernel<C0>, p, grid, st);
    case 1: return q4mm::launch<C1>(q4_matmul_tc_kernel<C1>, p, grid, st);
    case 2: return q4mm::launch<C2>(q4_matmul_tc_kernel<C2>, p, grid, st);
    case 3: return q4mm::launch<C3>(q4_matmul_tc_kernel<C3>, p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of tile `cfg` one SM holds at once (the launch is sized to one wave of them).
extern "C" int q4_matmul_blocks_per_sm(int cfg) {
  switch (cfg) {
    case 0: return q4mm::blocks_per_sm<C0>(q4_matmul_tc_kernel<C0>);
    case 1: return q4mm::blocks_per_sm<C1>(q4_matmul_tc_kernel<C1>);
    case 2: return q4mm::blocks_per_sm<C2>(q4_matmul_tc_kernel<C2>);
    case 3: return q4mm::blocks_per_sm<C3>(q4_matmul_tc_kernel<C3>);
    default: return -1;
  }
}
