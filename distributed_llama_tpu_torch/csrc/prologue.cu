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
// before it is summed (__fmul_rn, __fadd_rn: no contraction), as torch's x*x is. The sum
// of squares runs in one fixed order — each thread's pieces in order, the lanes of a
// warp by xor shuffles, the warps in order, the CTAs of a cluster in rank order — so a
// call repeats bit for bit; only that order differs from torch.mean, so rmsnorm_q80 may
// move an element that sits within an ulp of a rounding tie by one step.
//
// What bounds it on an H100: latency. At k = 4096 it reads ~32 KB and writes ~4.6 KB,
// about 0.01 us at the memory rate; what costs is the chain of round trips and barriers
// from launch to the last store.
//
// What the design does about it:
// - One read of the row, every load in flight at once. The row is cut into 16-byte
//   pieces (4 f32 or 8 bf16 values); thread t of CTA c holds pieces
//   c·T·L + i·T + t, i < L, and issues all of its loads (and the norm weight's) before
//   it uses any. The values stay in registers for the sum of squares and the
//   quantization: one memory round trip, no second pass over the row.
// - The lanes holding one 32-block (8 for f32, 4 for bf16) take its absmax by
//   width-limited shuffles; each stores its 4 or 8 xq bytes, the group's first lane sx.
// - The launch shape (T threads, L pieces a thread, C CTAs) comes from
//   ops/prologue_plan.py. A row larger than one CTA holds is split over C <= 8 CTAs: for
//   quantize_q80 a plain grid (the blocks are independent); for rmsnorm_q80 one thread
//   block cluster, whose CTAs push their partial sums of squares into every CTA's
//   shared memory (mapa + st.shared::cluster) between two cluster barriers. The first
//   barrier's arrival is made at entry and waited on only before the remote stores, so
//   its latency hides behind the loads. No second launch, no grid-wide sync, no atomics.
//
// Programmatic dependent launch (PDL): the kernel runs griddepcontrol.launch_dependents
// at entry, so a consumer launched with programmatic stream serialization (the
// pre-quantized matvecs, csrc/matvec_stream.cuh) is scheduled at once and may stream its
// weights while this kernel runs; the consumer's griddepcontrol.wait still waits for
// this whole grid to finish and its writes to become visible. This kernel is launched
// with the attribute too: before its own griddepcontrol.wait it reads nothing
// another kernel writes and writes no global memory (its predecessor, a torch add, cast
// or the attention kernel, may still be running, and a freed buffer it still reads may
// be the one this kernel's outputs were allocated in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCtas = 8;  // the portable cluster size

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the grids this one depends on have finished and their writes are visible
// (returns at once when the launch was not programmatic)
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into `local`'s counterpart in the shared memory of cluster CTA `rank`
__device__ __forceinline__ void store_remote(float* local, unsigned rank, float v) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// the values of one 16-byte piece of the row, widened to f32
template <bool kXB>
__device__ __forceinline__ void widen(const uint4& v, float (&f)[kXB ? 8 : 4]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kXB) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    } else {
      f[j] = __uint_as_float(u[j]);
    }
  }
}

// T threads, L pieces a thread; the CTAs of the grid take consecutive slices of T·L
// pieces (one cluster for the norm when the grid has more than one CTA)
template <int T, int L, bool kXB, bool kNorm>
__global__ void __launch_bounds__(T)
prologue_kernel(const void* __restrict__ x, const float* __restrict__ w, float eps,
                int8_t* __restrict__ xq, float* __restrict__ sx, int k) {
  constexpr int kVals = kXB ? 8 : 4;  // values of a piece
  constexpr int kLanes = 32 / kVals;  // lanes of a 32-block
  constexpr int kWarps = T / 32;
  __shared__ float warp_ss[kWarps];
  __shared__ float cta_ss[kMaxCtas];
  launch_dependents();
  const bool clustered = kNorm && gridDim.x > 1;
  // every CTA of the cluster has started once this phase completes, so its shared
  // memory may take the remote stores below
  if (clustered) cluster_arrive_relaxed();
  wait_for_predecessor();

  const int tid = threadIdx.x, lane = tid & 31;
  const int pieces = k / kVals;
  const int base = blockIdx.x * T * L;
  uint4 xv[L];
  float4 wv[kNorm ? L : 1][kNorm ? kVals / 4 : 1];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int pc = base + i * T + tid;
    const bool in = pc < pieces;
    xv[i] = in ? __ldcg(reinterpret_cast<const uint4*>(x) + pc) : make_uint4(0, 0, 0, 0);
    if constexpr (kNorm) {
#pragma unroll
      for (int q = 0; q < kVals / 4; ++q)
        wv[i][q] = in ? __ldcg(reinterpret_cast<const float4*>(w) + pc * (kVals / 4) + q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float inv = 1.f;
  if constexpr (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float f[kVals];
      widen<kXB>(xv[i], f);
#pragma unroll
      for (int j = 0; j < kVals; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
    if (kWarps > 1) {
      if (lane == 0) warp_ss[tid >> 5] = ss;
      __syncthreads();
      ss = warp_ss[0];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) ss = __fadd_rn(ss, warp_ss[q]);
    }
    if (clustered) {
      cluster_wait();
      if (tid < static_cast<int>(gridDim.x)) store_remote(&cta_ss[blockIdx.x], tid, ss);
      cluster_arrive_release();
      cluster_wait();
      ss = cta_ss[0];
      for (int r = 1; r < static_cast<int>(gridDim.x); ++r) ss = __fadd_rn(ss, cta_ss[r]);
    }
    inv = 1.0f / sqrtf(__fadd_rn(ss / static_cast<float>(k), eps));
  }

#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (base + i * T >= pieces) break;  // CTA-uniform
    const int pc = base + i * T + tid;
    float f[kVals];
    widen<kXB>(xv[i], f);
    if constexpr (kNorm) {
#pragma unroll
      for (int q = 0; q < kVals / 4; ++q) {
        const float4 wq = wv[i][q];
        f[4 * q] = __fmul_rn(__fmul_rn(f[4 * q], inv), wq.x);
        f[4 * q + 1] = __fmul_rn(__fmul_rn(f[4 * q + 1], inv), wq.y);
        f[4 * q + 2] = __fmul_rn(__fmul_rn(f[4 * q + 2], inv), wq.z);
        f[4 * q + 3] = __fmul_rn(__fmul_rn(f[4 * q + 3], inv), wq.w);
      }
    }
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kVals; ++j) a = fmaxf(a, fabsf(f[j]));
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
    const float scale = a > 0.f ? 127.0f / a : 0.f;
    unsigned packed[kVals / 4];
#pragma unroll
    for (int j = 0; j < kVals / 4; ++j) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= (static_cast<unsigned>(__float2int_rn(f[4 * j + b] * scale)) & 0xffu)
                << (8 * b);
      packed[j] = word;
    }
    if (pc < pieces) {
      if constexpr (kXB)
        reinterpret_cast<uint2*>(xq)[pc] = make_uint2(packed[0], packed[1]);
      else
        reinterpret_cast<unsigned*>(xq)[pc] = packed[0];
      if ((lane & (kLanes - 1)) == 0) sx[pc / kLanes] = a / 127.0f;
    }
  }
}

struct Args {
  const void* x;
  const float* w;
  float eps;
  int8_t* xq;
  float* sx;
  int k, ctas;
};

template <int T, int L, bool kXB, bool kNorm>
cudaError_t launch_one(const Args& a, cudaStream_t st) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  unsigned n = 1;
  if (kNorm && a.ctas > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = a.ctas;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, prologue_kernel<T, L, kXB, kNorm>, a.x, a.w, a.eps, a.xq,
                            a.sx, a.k);
}

template <int T, bool kXB, bool kNorm>
cudaError_t by_pieces(const Args& a, int per_thread, cudaStream_t st) {
  switch (per_thread) {
    case 1: return launch_one<T, 1, kXB, kNorm>(a, st);
    case 2: return launch_one<T, 2, kXB, kNorm>(a, st);
    case 4: return launch_one<T, 4, kXB, kNorm>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kXB, bool kNorm>
cudaError_t by_threads(const Args& a, int threads, int per_thread, cudaStream_t st) {
  switch (threads) {
    case 128: return by_pieces<128, kXB, kNorm>(a, per_thread, st);
    case 256: return by_pieces<256, kXB, kNorm>(a, per_thread, st);
    case 512: return by_pieces<512, kXB, kNorm>(a, per_thread, st);
    case 1024: return by_pieces<1024, kXB, kNorm>(a, per_thread, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (k,) f32 or bf16 (x_bf16), 16-byte aligned; w: (k,) f32, 16-byte aligned (unused
// when norm == 0); xq: (k,) int8; sx: (k/32,) f32. norm != 0: rmsnorm_q80, else
// quantize_q80. The launch shape from ops/prologue_plan.py: `threads` a CTA (128, 256,
// 512 or 1024), `per_thread` 16-byte pieces a thread (1, 2 or 4), `ctas` CTAs (1-8)
// whose slices of threads·per_thread pieces cover the row, none empty. Launched with
// programmatic stream serialization. Returns the launch's CUDA error; a shape or
// attribute the card refuses is an error, never a fallback.
extern "C" int prologue_q80(const void* x, int x_bf16, const void* w, float eps, int norm,
                            void* xq, void* sx, int k, int threads, int per_thread, int ctas,
                            void* stream) {
  const int pieces = k / (x_bf16 ? 8 : 4);
  const long long slice = static_cast<long long>(threads) * per_thread;
  if (k < 32 || k % 32 || ctas < 1 || ctas > kMaxCtas || slice < 1 ||
      ctas * slice < pieces || (ctas - 1) * slice >= pieces)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(w), eps, static_cast<int8_t*>(xq),
               static_cast<float*>(sx), k, ctas};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (norm)
    e = x_bf16 ? by_threads<true, true>(a, threads, per_thread, st)
               : by_threads<false, true>(a, threads, per_thread, st);
  else
    e = x_bf16 ? by_threads<true, false>(a, threads, per_thread, st)
               : by_threads<false, false>(a, threads, per_thread, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
