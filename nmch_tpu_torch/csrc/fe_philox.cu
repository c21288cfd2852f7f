// Forward-Euler Heston paths on Hopper (sm_90a): Philox4x32-10 draws,
// half-circle Box-Muller normals and Euler steps, one thread per path,
// followed by a deterministic two-pass float64 sum of payoff and payoff^2.
//
// Replaces nmch_tpu/ops/fe_pallas.py::_fe_kernel with rng="philox", rot=1,
// box="hc" (the kernel behind fe_moments_pallas, fe_pallas.py:317).
//
// What bounds it on an H100: the SMs' arithmetic pipes. A path carries two
// floats of state (S, v) and a few loop-invariant constants, and touches
// memory only to write its payoff. Per counter block (two Euler steps) it
// spends 10 Philox rounds (two 32-bit mul.hi and two mul.lo each) and about
// 70 FP32 operations of polynomials and steps plus three IEEE square roots.
// What the design does about it: one thread per path with everything in
// registers for all N steps, no shared or global memory inside the time
// loop, and the cross-path sum left to the end (reduce.cuh: a shared-memory
// tree per block, then one block over the per-block partials).
//
// Numerics: built with -fmad=false and without --use_fast_math, every float
// operation is the one the plain PyTorch version (nmch_tpu_torch/ops/fe.py)
// performs, in the same order, with IEEE sqrtf and division. A path's payoff
// is therefore bitwise the plain version's; the moments differ from it only
// by the order of the float64 sums. No float atomics: the sums are in a
// fixed order, so equal arguments give bitwise-equal moments.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;
using nmch::philox4x32_10;

// float32 constants of nmch_tpu/rng/normal.py; tests/test_torch_normal.py
// parses this table and holds each literal to the JAX package's value.
__constant__ float kSinHc[4] = {9.999966e-01f, -1.6664828e-01f,
                                8.306325e-03f, -1.8363653e-04f};
__constant__ float kCosHc[5] = {9.9999994e-01f, -4.9999905e-01f,
                                4.1663583e-02f, -1.3853704e-03f,
                                2.315393e-05f};
__constant__ float kNeg2Log[8] = {-1.9999996e+00f, 9.999481e-01f,
                                  -6.655095e-01f, 4.8990867e-01f,
                                  -3.549032e-01f, 2.15361e-01f,
                                  -8.81775e-02f, 1.707792e-02f};
constexpr float kNeg2Ln2 = -1.3862944e+00f;
constexpr float kC254Ln2 = 1.7605939e+02f;
constexpr float kPi = 3.1415927e+00f;
constexpr float kPi1p5 = 4.712389e+00f;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

struct FeArgs {
  float T, S_0, v_0, r, k, rho, theta, sigma;
  uint32_t k0, k1, epoch, base_path;
  int N;
};

struct FeConsts {
  float A, B, C, rho_sd, rhoc_sd, one_rdt;
};

// -2 ln(u) for u in (0, 1], from u's bits (rng/normal.py::neg2log)
__device__ __forceinline__ float neg2log(float u) {
  const uint32_t b = __float_as_uint(u);
  const float ebf = __uint_as_float((b >> 23) | 0x4B400000u) - kMagic;
  const float m = __uint_as_float((b & 0x007FFFFFu) | 0x3F800000u);
  const float t = m - 1.0f;
  float p = kNeg2Log[7];
#pragma unroll
  for (int i = 6; i >= 0; --i) p = p * t + kNeg2Log[i];
  const float q = ebf * kNeg2Ln2 + kC254Ln2 + t * p;
  return fmaxf(q, 0.0f);
}

// two u32 words -> two N(0,1) (rng/normal.py::normal_pair_hc)
__device__ __forceinline__ void normal_pair_hc(uint32_t w_r, uint32_t w_p,
                                               float& ga, float& gb) {
  const float u = 2.0f - __uint_as_float((w_r >> 9) | 0x3F800000u);
  const float q = neg2log(u);
  const float R =
      __uint_as_float(__float_as_uint(sqrtf(q)) ^ (w_p & 0x80000000u));
  const float f = __uint_as_float((w_p & 0x007FFFFFu) | 0x3F800000u);
  const float z = f * kPi - kPi1p5;
  const float z2 = z * z;
  float s = kSinHc[3];
#pragma unroll
  for (int i = 2; i >= 0; --i) s = s * z2 + kSinHc[i];
  s = s * z;
  float c = kCosHc[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) c = c * z2 + kCosHc[i];
  ga = R * c;
  gb = R * s;
}

// one Euler step (ops/fe.py::fe_step)
__device__ __forceinline__ void fe_step(float& S, float& v, float g1, float g2,
                                        const FeConsts& c) {
  const float sqv = sqrtf(v);
  const float zc = c.rho_sd * g1 + c.rhoc_sd * g2;
  S = S * (c.one_rdt + sqv * zc);
  v = fabsf(c.B * v + c.A + sqv * (c.C * g1));
}

__global__ void __launch_bounds__(kPathThreads)
    fe_philox_paths(FeArgs a, double* __restrict__ partials) {
  // ops/fe.py::fe_terminal's constants, in its order
  const float dt = a.T / (float)a.N;
  const float sqrt_dt = sqrtf(dt);
  const float sqrt_rho_c = sqrtf(1.0f - a.rho * a.rho);
  FeConsts c;
  c.A = a.k * a.theta * dt;
  c.B = 1.0f - a.k * dt;
  c.C = a.sigma * sqrt_dt;
  c.rho_sd = a.rho * sqrt_dt;
  c.rhoc_sd = sqrt_rho_c * sqrt_dt;
  c.one_rdt = 1.0f + a.r * dt;

  const uint32_t path =
      a.base_path + blockIdx.x * kPathThreads + threadIdx.x;
  float S = a.S_0;
  float v = a.v_0;
  const uint32_t N = (uint32_t)a.N;
  const uint32_t n_blocks = (N + 1) / 2;
  for (uint32_t j = 0; j < n_blocks; ++j) {
    uint32_t w0 = j, w1 = a.epoch, w2 = path, w3 = 0u;
    philox4x32_10(w0, w1, w2, w3, a.k0, a.k1);
    float g0, g1, g2, g3;
    normal_pair_hc(w0, w1, g0, g1);
    normal_pair_hc(w2, w3, g2, g3);
    fe_step(S, v, g0, g1, c);
    if (2 * j + 1 < N) fe_step(S, v, g2, g3, c);
  }

  nmch::block_sum_to_partials(fmaxf(S - a.S_0, 0.0f), partials);
}

}  // namespace

// (E[X], E[X^2]) of n_paths FE paths into out[0..1] (float64, device).
// partials: float64[2 * n_paths / 128] scratch on the device. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the
// launches (0 on success); nothing is launched for invalid sizes.
extern "C" int nmch_fe_philox_moments(float T, float S_0, float v_0, float r,
                                      float k, float rho, float theta,
                                      float sigma, uint32_t k0, uint32_t k1,
                                      uint32_t epoch, uint32_t base_path,
                                      int64_t N, int64_t n_paths,
                                      double* partials, double* out,
                                      void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_paths < kPathThreads ||
      n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const FeArgs a{T, S_0, v_0, r, k, rho, theta, sigma,
                 k0, k1, epoch, base_path, (int)N};
  const int64_t n_blocks = n_paths / kPathThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fe_philox_paths<<<(unsigned)n_blocks, kPathThreads, 0, st>>>(a, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out, st);
}

extern "C" const char* nmch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
