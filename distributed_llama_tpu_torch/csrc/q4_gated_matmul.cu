// q4_gated_matmul: the FFN gate pair Y = act(X·dequant(W1)^T) · (X·dequant(W3)^T) for
// M > 1 activation rows against two Q40 weights in the i4p split-plane layout, with
// act = silu or tanh-GELU in f32. One launch per call over the block body of
// q4_mm_tile.cuh with two weight streams.
//
// Replaces distributed_llama_tpu/ops/pallas_q4_mm.py `_q4_gated_matmul` (kernel body
// `_gated_mm_kernel`: two accumulators over one x tile, the activation epilogue on the
// last K step; formulas `_act_f32`).
//
// What it computes (the same numbers as the TPU kernel): each weight decodes as
// bf16((q - 8) · f32(s)) exactly as q4_matmul.cu does, X is bf16, both products
// accumulate in f32, and the epilogue applies act to the FULL f32 sum of the gate
// product before multiplying by the up product: silu(a) = a / (1 + exp(-a)),
// gelu_tanh(a) = 0.5·a·(1 + tanh(c·a·(1 + 0.044715·a²))), c = sqrt(2/pi); the result is
// rounded once to the caller's dtype.
//
// What bounds it on an H100: the two weight streams. At 11008 x 4096 each it moves
// ~0.56 B per weight for 2·M flop per weight: bytes at M = 8 and 64, the tensor cores at
// M = 512.
//
// What the design does (q4_mm_tile.cuh): a block owns the same weight rows of W1 and W3;
// each stage lands one X tile and both weights' chunks, and every warp decodes its rows
// of both in registers and runs both products on each X fragment or box, so the gate and up
// sums of one output element meet in the same thread's registers and the (M, N)
// intermediates never leave them. With K split, the activation runs in the last split
// block, on the ordered sum of the splits' fragments, never on a partial. Tiles by M
// (weight rows of each stream x activation rows, warps, chunks per stage, stages,
// products):
//   M <= 8:  64 x 8,  4 warps, 4, 3, mma.sync      M <= 16: 64 x 16, 4 warps, 4, 3, mma.sync
//   M <= 64: 64 x 64, 4 warps, 2, 2, wgmma n64     M > 64: 64 x 128, 4 warps, 2, 2, wgmma n128

#include "q4_mm_tile.cuh"

namespace {

using C0 = q4mm::Cfg<2, 1, 1, 4, 1, 4, 3>;
using C1 = q4mm::Cfg<2, 1, 2, 4, 1, 4, 3>;
using C2 = q4mm::Cfg<2, 1, 8, 4, 1, 2, 2, 1>;
using C3 = q4mm::Cfg<2, 1, 16, 4, 1, 2, 2, 1>;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    q4_gated_tc_kernel(const __grid_constant__ q4mm::Params p) {
  q4mm::run<C>(p);
}

}  // namespace

// x: (m, k) bf16; w1p/w3p: (n, k/2) u8 i4p; w1s/w3s: (n, k/32) f16; y: (m, n) f32
// (out_kind 0) or bf16 (1); act: 0 silu, 1 gelu_tanh; part, counters, cfg,
// splits, per_split and grid as q4_matmul's. k % 64 == 0.
extern "C" int q4_gated_matmul(const void* x, const void* w1p, const void* w1s,
                               const void* w3p, const void* w3s, void* y, int out_kind,
                               void* part, void* counters, int m, int n, int k, int act,
                               int cfg, int splits, int per_split, int grid, void* stream) {
  q4mm::Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp[0] = static_cast<const uint8_t*>(w1p);
  p.wp[1] = static_cast<const uint8_t*>(w3p);
  p.ws[0] = static_cast<const __half*>(w1s);
  p.ws[1] = static_cast<const __half*>(w3s);
  p.y = y;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.n = n;
  p.k = k;
  p.out_kind = out_kind;
  p.act = act;
  p.splits = splits;
  p.per_split = per_split;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return q4mm::launch<C0>(q4_gated_tc_kernel<C0>, p, grid, st);
    case 1: return q4mm::launch<C1>(q4_gated_tc_kernel<C1>, p, grid, st);
    case 2: return q4mm::launch<C2>(q4_gated_tc_kernel<C2>, p, grid, st);
    case 3: return q4mm::launch<C3>(q4_gated_tc_kernel<C3>, p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int q4_gated_matmul_blocks_per_sm(int cfg) {
  switch (cfg) {
    case 0: return q4mm::blocks_per_sm<C0>(q4_gated_tc_kernel<C0>);
    case 1: return q4mm::blocks_per_sm<C1>(q4_gated_tc_kernel<C1>);
    case 2: return q4mm::blocks_per_sm<C2>(q4_gated_tc_kernel<C2>);
    case 3: return q4mm::blocks_per_sm<C3>(q4_gated_tc_kernel<C3>);
    default: return -1;
  }
}
