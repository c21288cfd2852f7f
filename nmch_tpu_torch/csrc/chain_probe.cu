// The element-op chain of the bf16-vs-f32 issue-rate probe on Hopper
// (sm_90a).
//
// Replaces benchmarks/bf16_probe.py::_chain_kernel (K8, behind chain,
// bf16_probe.py:78): K iterations of an 8-op mul/add/abs chain, then a
// tail (abs, an IEEE square root, or a reciprocal square root), on a
// (rows, 128) tile that stays resident for all K iterations. The TPU kept
// the tile in vector registers; here each thread keeps its share in
// registers:
//   * float32: one element per thread. The chain is 8 FP32 instructions
//     per iteration (-fmad=false keeps x * c + d as two roundings; the abs
//     folds into the next instruction's operand); the tail is fabsf,
//     sqrtf (IEEE: MUFU.RSQ and a correction on the FP32 pipe) or rsqrtf
//     (MUFU.RSQ).
//   * bf16: two elements per thread as one packed bf16x2 word, the card's
//     counterpart of the probe's question (does packed bf16 double the
//     elementwise rate?). The probe's constants 1 +- 2^-10 round to 1.0
//     in bf16 (its "exactly representable" holds for float32 only), as
//     they do in nmch_tpu's kernel. Each op is one PTX bf16x2 instruction with
//     explicit round-to-nearest (mul.rn/add.rn/sub.rn.bf16x2: no
//     contraction into fma), abs clears the two sign bits, and the tail's
//     bf16x2 form takes sqrt.approx.f32 or rsqrt.approx.f32 (MUFU) of each
//     half and packs the pair with cvt.rn.bf16x2.f32.
//
// Numerics: the float32 ALU and sqrt chains equal the plain version
// (nmch_tpu_torch/ops/chain.py::chain_plain) bitwise, and so do the bf16
// ALU ops (each is the correctly rounded result, as torch's); rsqrtf and
// the approximate bf16 tails are MUFU approximations, within an ulp of
// the dtype of torch's.
//
// Both loops are unrolled by 4, so the SASS loop body is four iterations
// (chip_smoke.py reads its instruction count).
//
// What bounds it on an H100: instruction issue, or the latency of one
// element's chain of dependent instructions. At the probe's tiles (128 x
// 128 float32, 256 x 128 bf16) the grid is 128 blocks of 128 threads, less
// than one block per SM, so each SM runs one warp per scheduler and the
// time is the chain's latency, not the issue rate; a tile of many rows
// fills the card and is bound by the FP32 pipe (128 ops per SM and clock),
// the bf16x2 pipe (the same instruction rate, two elements each) or the
// MUFU unit (16 per SM and clock) for the square-root tails.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAbs = 0;
constexpr int kSqrt = 1;
constexpr int kRsqrt = 2;

template <int Tail>
__global__ void __launch_bounds__(kThreads)
    chain_f32(const float* __restrict__ x, float* __restrict__ out, int64_t n,
              int K) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float one = 1.0f;
  const float c = 1.0009765625f;
  const float d = 0.9990234375f;
  float v = x[i];
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    v = v * c;
    v = v + d;
    v = v * d;
    v = fabsf(v - one);
    v = v * c + d;
    v = v * d;
    v = v - one;
    if (Tail == kAbs) {
      v = fabsf(v);
    } else {
      const float ax = fabsf(v) + one;
      v = Tail == kSqrt ? sqrtf(ax) : rsqrtf(ax);
    }
  }
  out[i] = v;
}

// packed bf16x2 ops (two bf16 in one 32-bit word, low half first)
__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// f rounded to nearest bf16, in both halves
__device__ __forceinline__ uint32_t bpack(float f) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(d) : "f"(f));
  return d;
}

__device__ __forceinline__ uint32_t babs(uint32_t a) {
  return a & 0x7FFF7FFFu;
}

// the tail's bf16x2 form: each half widened to f32 (exact), the MUFU
// approximation, both rounded to nearest bf16 and packed
template <int Tail>
__device__ __forceinline__ uint32_t btail(uint32_t a) {
  float lo = __uint_as_float(a << 16);
  float hi = __uint_as_float(a & 0xFFFF0000u);
  if (Tail == kSqrt) {
    asm("sqrt.approx.f32 %0, %0;" : "+f"(lo));
    asm("sqrt.approx.f32 %0, %0;" : "+f"(hi));
  } else {
    asm("rsqrt.approx.f32 %0, %0;" : "+f"(lo));
    asm("rsqrt.approx.f32 %0, %0;" : "+f"(hi));
  }
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

template <int Tail>
__global__ void __launch_bounds__(kThreads)
    chain_bf16x2(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t n2, int K) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  // the probe's constants rounded to bf16, as jnp.asarray(c, bfloat16)
  // rounds them: 1 + 2^-10 and 1 - 2^-10 both become 1.0
  const uint32_t one = bpack(1.0f);
  const uint32_t c = bpack(1.0009765625f);
  const uint32_t d = bpack(0.9990234375f);
  uint32_t v = x[i];
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    v = bmul(v, c);
    v = badd(v, d);
    v = bmul(v, d);
    v = babs(bsub(v, one));
    v = badd(bmul(v, c), d);
    v = bmul(v, d);
    v = bsub(v, one);
    v = Tail == kAbs ? babs(v) : btail<Tail>(badd(babs(v), one));
  }
  out[i] = v;
}

template <int Tail>
cudaError_t launch(int dtype, const void* x, void* out, int64_t n, int K,
                   cudaStream_t st) {
  if (dtype == 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    chain_f32<Tail><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, K);
  } else {
    const int64_t n2 = n / 2;
    const int64_t blocks = (n2 + kThreads - 1) / kThreads;
    chain_bf16x2<Tail><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n2, K);
  }
  return cudaGetLastError();
}

}  // namespace

// K chain iterations on the n elements of x into out (device, contiguous;
// dtype 0 = float32, 1 = bf16 with n even and 4-byte aligned pointers;
// tail 0 = abs, 1 = sqrt, 2 = rsqrt). Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 on success);
// nothing is launched for invalid arguments.
extern "C" int nmch_chain(const void* x, void* out, int64_t n, int dtype,
                          int tail, int K, void* stream) {
  const int64_t per_thread = dtype == 1 ? 2 : 1;
  if (n < 1 || (dtype != 0 && dtype != 1) || n % per_thread != 0 ||
      (n / per_thread + kThreads - 1) / kThreads > 0x7FFFFFFF || K < 0 ||
      (dtype == 1 && (reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
                      reinterpret_cast<uintptr_t>(out) % 4 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tail) {
    case kAbs: return (int)launch<kAbs>(dtype, x, out, n, K, st);
    case kSqrt: return (int)launch<kSqrt>(dtype, x, out, n, K, st);
    case kRsqrt: return (int)launch<kRsqrt>(dtype, x, out, n, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
