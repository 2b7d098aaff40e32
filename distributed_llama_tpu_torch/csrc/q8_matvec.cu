// q8_matvec: y = W·x for one activation row against weights in the int8-plane (i8)
// layout: W8 int8 (n, k) in natural column order, f32 block scales s (n, k/32).
//
// Replaces distributed_llama_tpu/ops/pallas_q8.py `_q8_matvec` (kernel bodies
// `_matvec_kernel` and the precise `_matvec_kernel_f32`) together with the Q80 row
// quantizer `_quantize_row` that feeds it, and `_q8_matvec_inline`
// (`_matvec_kernel_inline`), which takes the row the fused prologue quantized. Three
// entries over one block body, and an expert entry:
//   q8_matvec      x f32/bf16 is quantized to Q80 in the kernel:
//                    xq[j] = round_half_even(x[j] * (127 / absmax_b)), sx[b] = absmax_b/127
//   q8_matvec_q80  xq int8 and sx f32 come in already quantized
//   both:          P[n,b] = sum_{j in block b} W8[n,j] * xq[j]          (int32, exact)
//                  y[n]   = sum_b (s[n,b] * sx[b]) * P[n,b]              (f32)
//   q8_matvec(precise)  x f32/bf16 stays unquantized, sx = 1:
//                  P[n,b] = sum_{j in block b} W8[n,j] * x[j]           (f32 sums)
//                  y[n]   = sum_b s[n,b] * P[n,b]
// y is written as f32 or bf16 (rounded once). q8_matvec_expert is q8_matvec (quantized
// row) against one expert of the (n_local, n, k) stack of experts a rank holds, chosen
// by an index in device memory; an expert outside that window gives zeros.
//
// What bounds it on an H100: bytes. One decode token streams every weight once at
// 1.125 B/weight (1 B of int8 plus a 4-byte scale per 32) and does 2 integer ops per
// weight, far below the int8 tensor-core rate, so the time floor is weight and scale
// bytes over the memory rate: twice the Q40 (i4p) floor for the same model.
//
// What the design does about it: the block body of matvec_stream.cuh — each block's
// contiguous row range streams through a ring of bulk copies while the row is quantized
// (or staged), __dp4a signed x signed against xq in shared memory (the precise body: f32
// FMAs against the f32 row), one wave of blocks, one launch per call in the caller's
// dtype.

#include "matvec_stream.cuh"

namespace {

template <int MODE, bool kXB, int CPL>
__global__ void __launch_bounds__(mvs::kThreads, 2) q8_matvec_kernel(const mvs::Params p) {
  mvs::run<mvs::kI8, MODE, kXB, CPL>(p);
}

template <int MODE, bool kXB>
struct Entry {
  template <int CPL>
  static constexpr auto kernel = q8_matvec_kernel<MODE, kXB, CPL>;
};

template <int MODE>
int launch_mode(const mvs::Params& p, int x_bf16, int grid, cudaStream_t st) {
  return x_bf16 ? mvs::launch<mvs::kI8, MODE, Entry<MODE, true>>(p, grid, st)
                : mvs::launch<mvs::kI8, MODE, Entry<MODE, false>>(p, grid, st);
}

template <int MODE>
int fit_mode(int x_bf16, int k, int rs, int stages, int gw) {
  return x_bf16 ? mvs::blocks_per_sm<mvs::kI8, MODE, Entry<MODE, true>>(k, rs, stages, gw)
                : mvs::blocks_per_sm<mvs::kI8, MODE, Entry<MODE, false>>(k, rs, stages, gw);
}

}  // namespace

// x: (k,) f32 or bf16 (x_bf16), 16-byte aligned; w8: (n, k) int8, 16-byte aligned; ws:
// (n, k/32) f32; y: (n,) f32 or bf16 (out_bf16). precise != 0 takes x unquantized
// (sx = 1). k % 32 == 0. rs rows per ring slot, `stages` slots, gw warps per row, grid
// blocks (ops/mv_plan.py).
extern "C" int q8_matvec(const void* x, int x_bf16, int precise, const void* w8,
                         const void* ws, void* y, int out_bf16, int n, int k, int rs,
                         int stages, int gw, int grid, void* stream) {
  const mvs::Params p = mvs::make_params(x, nullptr, nullptr, w8, ws, y, out_bf16, n, k, rs,
                                         stages, gw);
  const auto st = static_cast<cudaStream_t>(stream);
  return precise ? launch_mode<mvs::kPrecise>(p, x_bf16, grid, st)
                 : launch_mode<mvs::kQuantize>(p, x_bf16, grid, st);
}

// The expert entry: w8 (n_local, n, k) and ws (n_local, n, k/32), the experts
// [e_lo, e_lo + n_local) of one layer's stack (the owner window; (0, E) on one card);
// e: one int64 in device memory, the expert. Inside the window y is computed as
// q8_matvec with the row quantized, against local matrix e - e_lo, and *owned (an
// int32 in device memory, or null) gains one; outside it y is zeros and no weight or
// scale byte is read.
extern "C" int q8_matvec_expert(const void* x, int x_bf16, const void* w8, const void* ws,
                                const void* e, int e_lo, int n_local, void* owned, void* y,
                                int out_bf16, int n, int k, int rs, int stages, int gw,
                                int grid, void* stream) {
  mvs::Params p = mvs::make_params(x, nullptr, nullptr, w8, ws, y, out_bf16, n, k, rs,
                                   stages, gw);
  p.e = static_cast<const long long*>(e);
  p.e_lo = e_lo;
  p.n_local = n_local;
  p.owned = static_cast<int*>(owned);
  return launch_mode<mvs::kQuantize>(p, x_bf16, grid, static_cast<cudaStream_t>(stream));
}

// xq: (k,) int8, 16-byte aligned, and sx: (k/32,) f32, the Q80 row the fused prologue
// wrote; the rest as q8_matvec. Launched with programmatic stream serialization: each
// block issues `pre` (1..stages) slots of weights before griddepcontrol.wait, then
// loads the row (matvec_stream.cuh); a launch the card refuses returns its error.
extern "C" int q8_matvec_q80(const void* xq, const void* sx, const void* w8, const void* ws,
                             void* y, int out_bf16, int n, int k, int rs, int stages, int gw,
                             int pre, int grid, void* stream) {
  const mvs::Params p = mvs::make_params(nullptr, xq, sx, w8, ws, y, out_bf16, n, k, rs,
                                         stages, gw, pre);
  return mvs::launch<mvs::kI8, mvs::kPrequantized, Entry<mvs::kPrequantized, false>>(
      p, grid, static_cast<cudaStream_t>(stream));
}

// Blocks of one mode (0 the float row, 1 pre-quantized, 2 precise) one SM holds at once
// with this ring.
extern "C" int q8_matvec_blocks_per_sm(int mode, int x_bf16, int k, int rs, int stages,
                                       int gw) {
  switch (mode) {
    case mvs::kQuantize: return fit_mode<mvs::kQuantize>(x_bf16, k, rs, stages, gw);
    case mvs::kPrequantized:
      return mvs::blocks_per_sm<mvs::kI8, mvs::kPrequantized, Entry<mvs::kPrequantized, false>>(
          k, rs, stages, gw);
    case mvs::kPrecise: return fit_mode<mvs::kPrecise>(x_bf16, k, rs, stages, gw);
    default: return -1;
  }
}
