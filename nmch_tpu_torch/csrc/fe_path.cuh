// One forward-Euler Heston path per thread: the device half of fe.cu (K1)
// and sweep.cu (K3); fe_stateful.cu (K5) and qmc.cu (K6) take its steps.
//
// Operation for operation the plain PyTorch version (nmch_tpu_torch/ops/
// fe.py): counter block j of a path's stream gives 4 u32 words, the words
// become 4 half-circle Box-Muller normals (rng/normal.py::normal_pair_hc),
// and the normals drive Euler steps 2j and 2j + 1 (the second is skipped
// when 2j + 1 >= N). The stream is Philox4x32-10 or Threefry-4x32-12
// (counter_rng.cuh), chosen by the template parameter R.
//
// Numerics: built with -fmad=false and without --use_fast_math, every float
// operation is the plain version's, in its order, with IEEE sqrtf and
// division, so a path's payoff is bitwise the plain version's.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace nmch {
namespace {

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

struct FeParams {
  float T, S_0, v_0, r, k, rho, theta, sigma;
};

struct FeConsts {
  float A, B, C, rho_sd, rhoc_sd, one_rdt;
};

// ops/fe.py::fe_consts at step dt with normals scaled by sqrt_dt, in its
// order (the QMC kernel passes sqrt_dt = 1: its increments carry sqrt(dt))
__device__ __forceinline__ FeConsts fe_consts(const FeParams& p, float dt,
                                              float sqrt_dt) {
  const float sqrt_rho_c = sqrtf(1.0f - p.rho * p.rho);
  FeConsts c;
  c.A = p.k * p.theta * dt;
  c.B = 1.0f - p.k * dt;
  c.C = p.sigma * sqrt_dt;
  c.rho_sd = p.rho * sqrt_dt;
  c.rhoc_sd = sqrt_rho_c * sqrt_dt;
  c.one_rdt = 1.0f + p.r * dt;
  return c;
}

// ops/fe.py::euler_paths's constants: dt = T / N, sqrt_dt = sqrt(dt)
__device__ __forceinline__ FeConsts fe_consts(const FeParams& p, int N) {
  const float dt = p.T / (float)N;
  return fe_consts(p, dt, sqrtf(dt));
}

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

// S_T of path `path` of the stream (key (k0, k1), epoch): N steps from
// (S_0, v_0) with the constants c (ops/fe.py::fe_terminal).
template <int R>
__device__ __forceinline__ float fe_path(const FeParams& p, const FeConsts& c,
                                         uint32_t k0, uint32_t k1,
                                         uint32_t epoch, uint32_t path,
                                         int N) {
  float S = p.S_0;
  float v = p.v_0;
  const uint32_t n = (uint32_t)N;
  const uint32_t n_blocks = (n + 1) / 2;
  for (uint32_t j = 0; j < n_blocks; ++j) {
    uint32_t w0 = j, w1 = epoch, w2 = path, w3 = 0u;
    counter_block<R>(w0, w1, w2, w3, k0, k1);
    float g0, g1, g2, g3;
    normal_pair_hc(w0, w1, g0, g1);
    normal_pair_hc(w2, w3, g2, g3);
    fe_step(S, v, g0, g1, c);
    if (2 * j + 1 < n) fe_step(S, v, g2, g3, c);
  }
  return S;
}

}  // namespace
}  // namespace nmch
