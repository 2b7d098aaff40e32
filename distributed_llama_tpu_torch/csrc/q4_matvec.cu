// q4_matvec: y = W·x for one activation row against Q40 weights in the i4p
// split-plane layout, with x quantized to Q80 inside the kernel (entry `q4_matvec`; entry
// `q4_matvec_expert` against one expert of a layer's stack, chosen by an index in device
// memory) or given already quantized as xq int8 + sx f32 block scales (entry
// `q4_matvec_q80`).
//
// Replaces distributed_llama_tpu/ops/pallas_q4.py `_q4_matvec` (kernel body
// `_matvec_kernel` -> `_unpack_dot_epilogue`) together with the Q80 row quantizer
// `_quantize_row` of ops/pallas_q8.py that feeds it, and `_q4_matvec_inline`
// (`_matvec_kernel_inline`), which takes the row the fused prologue quantized.
//
// What it computes (the same numbers as the TPU kernel):
//   xq[j] = round_half_even(x[j] * (127 / absmax_b)), sx[b] = absmax_b / 127
//   P[n,b] = sum_{j in block b} (q[n,j] - 8) * xq[j]        (int32, exact)
//   y[n]   = sum_b (f16(s[n,b]) * sx[b]) * P[n,b]            (f32, written f32 or bf16)
// where byte c of packed row n holds q[n,c] in its low nibble and q[n,c+K/2] in its
// high nibble. The -8 offset is removed through the block sums of xq.
//
// What bounds it on an H100: bytes. One decode token streams every weight once at
// 0.5625 B/weight and does ~2 integer ops per weight, far below the int8 tensor-core
// rate, so the time floor is packed bytes over the memory rate.
//
// What the design does about it: the block body of matvec_stream.cuh — each block's
// contiguous row range streams through a ring of bulk copies while the row is
// quantized, nibbles go to __dp4a straight from the 32-bit words, one wave of blocks,
// one launch per call in the caller's dtype.

#include "matvec_stream.cuh"

namespace {

template <int MODE, bool kXB, int CPL>
__global__ void __launch_bounds__(mvs::kThreads, 2) q4_matvec_kernel(const mvs::Params p) {
  mvs::run<mvs::kI4p, MODE, kXB, CPL>(p);
}

template <int MODE, bool kXB>
struct Entry {
  template <int CPL>
  static constexpr auto kernel = q4_matvec_kernel<MODE, kXB, CPL>;
};

}  // namespace

// x: (k,) f32 or bf16 (x_bf16), 16-byte aligned; wp: (n, k/2) u8 i4p, 16-byte aligned;
// ws: (n, k/32) f16, 4-byte aligned; y: (n,) f32 or bf16 (out_bf16). k % 64 == 0.
// rs rows per ring slot, `stages` slots, gw warps per row, grid blocks (ops/mv_plan.py).
extern "C" int q4_matvec(const void* x, int x_bf16, const void* wp, const void* ws, void* y,
                         int out_bf16, int n, int k, int rs, int stages, int gw, int grid,
                         void* stream) {
  const mvs::Params p = mvs::make_params(x, nullptr, nullptr, wp, ws, y, out_bf16, n, k, rs,
                                         stages, gw);
  const auto st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? mvs::launch<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, true>>(
                      p, grid, st)
                : mvs::launch<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, false>>(
                      p, grid, st);
}

// The expert entry: wp (n_experts, n, k/2) and ws (n_experts, n, k/32), one layer's
// stack; e: one int64 in device memory, the expert (clamped into [0, n_experts)); the
// rest as q4_matvec, computed against matrix e of the stack.
extern "C" int q4_matvec_expert(const void* x, int x_bf16, const void* wp, const void* ws,
                                const void* e, int n_experts, void* y, int out_bf16, int n,
                                int k, int rs, int stages, int gw, int grid, void* stream) {
  mvs::Params p = mvs::make_params(x, nullptr, nullptr, wp, ws, y, out_bf16, n, k, rs,
                                   stages, gw);
  p.e = static_cast<const long long*>(e);
  p.n_experts = n_experts;
  const auto st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? mvs::launch<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, true>>(
                      p, grid, st)
                : mvs::launch<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, false>>(
                      p, grid, st);
}

// xq: (k,) int8, 16-byte aligned, and sx: (k/32,) f32, the Q80 row the fused prologue
// wrote; the rest as q4_matvec. Launched with programmatic stream serialization: each
// block issues `pre` (1..stages) slots of weights before griddepcontrol.wait, then
// loads the row (matvec_stream.cuh); a launch the card refuses returns its error.
extern "C" int q4_matvec_q80(const void* xq, const void* sx, const void* wp, const void* ws,
                             void* y, int out_bf16, int n, int k, int rs, int stages, int gw,
                             int pre, int grid, void* stream) {
  const mvs::Params p = mvs::make_params(nullptr, xq, sx, wp, ws, y, out_bf16, n, k, rs,
                                         stages, gw, pre);
  return mvs::launch<mvs::kI4p, mvs::kPrequantized, Entry<mvs::kPrequantized, false>>(
      p, grid, static_cast<cudaStream_t>(stream));
}

// Blocks of one entry (mode 0 the float row, 1 pre-quantized) one SM holds at once with
// this ring.
extern "C" int q4_matvec_blocks_per_sm(int mode, int x_bf16, int k, int rs, int stages,
                                       int gw) {
  if (mode == mvs::kPrequantized)
    return mvs::blocks_per_sm<mvs::kI4p, mvs::kPrequantized, Entry<mvs::kPrequantized, false>>(
        k, rs, stages, gw);
  return x_bf16 ? mvs::blocks_per_sm<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, true>>(
                      k, rs, stages, gw)
                : mvs::blocks_per_sm<mvs::kI4p, mvs::kQuantize, Entry<mvs::kQuantize, false>>(
                      k, rs, stages, gw);
}
