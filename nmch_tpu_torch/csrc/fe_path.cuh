// One forward-Euler Heston path group per thread: the device half of fe.cu
// and fe_device.cu (K1) and sweep.cu (K3); fe_stateful.cu (K5) and qmc.cu
// (K6) take its steps, and em_path.cuh (K2, K4) its uniforms and the turns
// Box-Muller.
//
// Operation for operation the plain PyTorch version (nmch_tpu_torch/ops/
// fe.py::fe_moments_kernel_plain): counter block j of a path's stream gives
// 4 u32 words (3 with the device generator's packed boxes), the words
// become 4 normals (rng/normal.py: half-circle hc, turns, or the packed
// hc16/hc16f, hc16f on shorter polynomials), and the normals drive Euler
// steps 2j and 2j + 1 (the second is skipped when 2j + 1 >= N) of the Rot
// coupled copies of the group, copy t on ops/fe.py::rotation_images(g0,
// g1, Rot)[t]. The generator (counter_rng.cuh), Rot, the box and fast_sqrt
// are template parameters.
//
// Numerics: built with -fmad=false and without --use_fast_math, every float
// operation is the plain version's, in its order, with IEEE sqrtf and
// division, so a group's payoff is bitwise the plain version's. The
// transcendentals are libdevice's logf, expf and rsqrtf (nm_* below), the
// functions torch's CUDA ops call for float32.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace nmch {
namespace {

// float32 constants of nmch_tpu/rng/normal.py and ops/fe.py;
// tests/test_torch_normal.py parses these tables and holds each literal to
// the JAX package's value.
__constant__ float kSinHc[4] = {9.999966e-01f, -1.6664828e-01f,
                                8.306325e-03f, -1.8363653e-04f};
__constant__ float kCosHc[5] = {9.9999994e-01f, -4.9999905e-01f,
                                4.1663583e-02f, -1.3853704e-03f,
                                2.315393e-05f};
__constant__ float kNeg2Log[8] = {-1.9999996e+00f, 9.999481e-01f,
                                  -6.655095e-01f, 4.8990867e-01f,
                                  -3.549032e-01f, 2.15361e-01f,
                                  -8.81775e-02f, 1.707792e-02f};
// the shorter polynomials of box hc16f (rng/normal.py::_SIN_F, _COS_F,
// _NEG2LOG_F)
__constant__ float kSinF[3] = {9.996968e-01f, -1.6567308e-01f,
                               7.514376e-03f};
__constant__ float kCosF[4] = {9.999933e-01f, -4.9991244e-01f,
                               4.1487746e-02f, -1.2712093e-03f};
__constant__ float kNeg2LogF[5] = {-1.9998865e+00f, 9.939551e-01f,
                                   -6.125991e-01f, 3.1485003e-01f,
                                   -8.26138e-02f};
constexpr float kNeg2Ln2 = -1.3862944e+00f;
constexpr float kC254Ln2 = 1.7605939e+02f;
constexpr float kPi = 3.1415927e+00f;
constexpr float kPi1p5 = 4.712389e+00f;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr float kScaleFloor = 1e-35f;  // with_scale's divisor floor
// ops/fe.py::radius_antithetic_scale
constexpr float kSixth = 1.6666667e-01f;
constexpr float kM24th = -4.1666668e-02f;
constexpr float kTaylorMax = 1e-02f;
constexpr float kAsymptoteMin = 1e+01f;
constexpr float kTFloor = 1e-35f;
constexpr float kLogFloor = 1e-38f;
constexpr float kRsqrtFloor = 1e-35f;  // fast_sqrt's rsqrt argument floor
// sincos_2pi: cos((pi/2) r) through r^8, sin((pi/2) r)/r through r^7
// (tests/test_torch_em.py holds these)
constexpr float kScCos0 = 0.00091926026f;
constexpr float kScCos1 = -0.02086348f;
constexpr float kScCos2 = 0.2536695f;
constexpr float kScCos3 = -1.2337005f;
constexpr float kScCos4 = 1.0f;
constexpr float kScSin0 = -0.004681754f;
constexpr float kScSin1 = 0.079692625f;
constexpr float kScSin2 = -0.6459641f;
constexpr float kScSin3 = 1.5707964f;

// The normal construction of a counter block (ops/fe.py::BOXES order, the
// C entry point's `box`): 4 words (hc, turns) or 3 (hc16, hc16f).
enum NormalBox { kHc = 0, kTurns = 1, kHc16 = 2, kHc16f = 3 };

__device__ __forceinline__ float nm_log(float x) { return logf(x); }
__device__ __forceinline__ float nm_exp(float x) { return expf(x); }
__device__ __forceinline__ float nm_rsqrt(float x) { return rsqrtf(x); }

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

// ops/fe.py::fe_params_consts: dt = T / N, sqrt_dt = sqrt(dt)
__device__ __forceinline__ FeConsts fe_consts(const FeParams& p, int N) {
  const float dt = p.T / (float)N;
  return fe_consts(p, dt, sqrtf(dt));
}

__device__ __forceinline__ float uniform_open01(uint32_t w) {
  return 2.0f - __uint_as_float((w >> 9) | 0x3F800000u);
}

__device__ __forceinline__ float uniform_halfopen01(uint32_t w) {
  return __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f;
}

// -2 ln(u) for u in (0, 1], from u's bits (rng/normal.py::neg2log; Fast:
// the degree-4 polynomial)
template <bool Fast = false>
__device__ __forceinline__ float neg2log(float u) {
  const uint32_t b = __float_as_uint(u);
  const float ebf = __uint_as_float((b >> 23) | 0x4B400000u) - kMagic;
  const float m = __uint_as_float((b & 0x007FFFFFu) | 0x3F800000u);
  const float t = m - 1.0f;
  float p;
  if (Fast) {
    p = kNeg2LogF[4];
#pragma unroll
    for (int i = 3; i >= 0; --i) p = p * t + kNeg2LogF[i];
  } else {
    p = kNeg2Log[7];
#pragma unroll
    for (int i = 6; i >= 0; --i) p = p * t + kNeg2Log[i];
  }
  const float q = ebf * kNeg2Ln2 + kC254Ln2 + t * p;
  return fmaxf(q, 0.0f);
}

// rng/normal.py::_halfcircle_pair: radius word w_r, phase carrier f in
// [1, 2), the pair's sign in bit 31 of `sign`; WithScale also gives the
// pair's radius-antithetic scale sqrt(-2 ln(1-u) / max(-2 ln u, 1e-35))
template <bool Fast, bool WithScale>
__device__ __forceinline__ void halfcircle_pair(uint32_t w_r, float f,
                                                uint32_t sign, float& ga,
                                                float& gb, float& scale) {
  const float u = uniform_open01(w_r);
  const float q = neg2log<Fast>(u);
  const float R = __uint_as_float(__float_as_uint(sqrtf(q)) ^ sign);
  const float z = f * kPi - kPi1p5;
  const float z2 = z * z;
  float s, c;
  if (Fast) {
    s = kSinF[2];
#pragma unroll
    for (int i = 1; i >= 0; --i) s = s * z2 + kSinF[i];
    c = kCosF[3];
#pragma unroll
    for (int i = 2; i >= 0; --i) c = c * z2 + kCosF[i];
  } else {
    s = kSinHc[3];
#pragma unroll
    for (int i = 2; i >= 0; --i) s = s * z2 + kSinHc[i];
    c = kCosHc[4];
#pragma unroll
    for (int i = 3; i >= 0; --i) c = c * z2 + kCosHc[i];
  }
  s = s * z;
  ga = R * c;
  gb = R * s;
  if (WithScale) {
    const float l2 = neg2log<Fast>(1.0f - u);
    scale = sqrtf(l2 / fmaxf(q, kScaleFloor));
  }
}

// two u32 words -> two N(0,1) (rng/normal.py::normal_pair_hc)
__device__ __forceinline__ void normal_pair_hc(uint32_t w_r, uint32_t w_p,
                                               float& ga, float& gb) {
  const float f = __uint_as_float((w_p & 0x007FFFFFu) | 0x3F800000u);
  float unused;
  halfcircle_pair<false, false>(w_r, f, w_p & 0x80000000u, ga, gb, unused);
}

// (cos(2 pi u), sin(2 pi u)), u in (0, 1] (rng/normal.py::sincos_2pi)
__device__ __forceinline__ void sincos_2pi(float u, float& cos_out,
                                           float& sin_out) {
  const float x = u * 4.0f;
  const float q = floorf(x + 0.5f);
  const float r = x - q;
  const int qi = (int)q;
  const float r2 = r * r;
  float c = kScCos0;
  c = c * r2 + kScCos1;
  c = c * r2 + kScCos2;
  c = c * r2 + kScCos3;
  c = c * r2 + kScCos4;
  float s = kScSin0;
  s = s * r2 + kScSin1;
  s = s * r2 + kScSin2;
  s = s * r2 + kScSin3;
  s = s * r;
  const float cos_base = (qi & 1) ? s : c;
  const float sin_base = (qi & 1) ? c : s;
  cos_out = ((qi + 1) & 2) ? -cos_base : cos_base;
  sin_out = (qi & 2) ? -sin_base : sin_base;
}

// rng/normal.py::boxmuller: two uniforms in (0, 1] -> two N(0,1),
// r = sqrt(-2 ln u1), (r cos, r sin)(2 pi u2)
__device__ __forceinline__ void boxmuller(float u1, float u2, float& g1,
                                          float& g2) {
  const float r = sqrtf(-2.0f * nm_log(u1));
  float c, s;
  sincos_2pi(u2, c, s);
  g1 = r * c;
  g2 = r * s;
}

// The 4 normals of one counter block from its words w (Box: 4 words, or 3
// for hc16/hc16f, rng/normal.py::normal4_from_bits3: pair 0's phase and
// sign in bits 0-15 of w[2], pair 1's in bits 16-31); WithScale also gives
// each pair's radius-antithetic scale in sc.
template <int Box, bool WithScale>
__device__ __forceinline__ void block_normals(const uint32_t* w, float g[4],
                                              float sc[2]) {
  if (Box == kHc) {
    normal_pair_hc(w[0], w[1], g[0], g[1]);
    normal_pair_hc(w[2], w[3], g[2], g[3]);
  } else if (Box == kTurns) {
    boxmuller(uniform_open01(w[0]), uniform_open01(w[1]), g[0], g[1]);
    boxmuller(uniform_open01(w[2]), uniform_open01(w[3]), g[2], g[3]);
  } else {
    constexpr bool kFast = Box == kHc16f;
    const uint32_t ph = w[2];
    const float f0 = __uint_as_float(((ph & 0x7FFFu) << 8) | 0x3F800000u);
    const float f1 = __uint_as_float(((ph >> 8) & 0x007FFF00u) | 0x3F800000u);
    halfcircle_pair<kFast, WithScale>(w[0], f0, (ph << 16) & 0x80000000u,
                                      g[0], g[1], sc[0]);
    halfcircle_pair<kFast, WithScale>(w[1], f1, ph & 0x80000000u, g[2], g[3],
                                      sc[1]);
  }
}

// one Euler step (ops/fe.py::fe_step)
__device__ __forceinline__ void fe_step(float& S, float& v, float g1, float g2,
                                        const FeConsts& c) {
  const float sqv = sqrtf(v);
  const float zc = c.rho_sd * g1 + c.rhoc_sd * g2;
  S = S * (c.one_rdt + sqv * zc);
  v = fabsf(c.B * v + c.A + sqv * (c.C * g1));
}

// s with (s a, s b) the radius-antithetic image of (a, b)
// (ops/fe.py::radius_antithetic_scale)
__device__ __forceinline__ float radius_antithetic_scale(float a, float b) {
  const float t = fmaxf((a * a + b * b) * 0.5f, kTFloor);
  const float emt = nm_exp(-t);
  const float em =
      t < kTaylorMax ? t * (1.0f + t * (-0.5f + t * (kSixth + t * kM24th)))
                     : 1.0f - emt;
  const float lg = t > kAsymptoteMin ? emt : -nm_log(fmaxf(em, kLogFloor));
  return sqrtf(lg / t);
}

// One Euler step of the Rot copies from the pair (a, b) (ops/fe.py::
// fe_rot_group_step): za, zs, ca, cb once per pair, copy t's signed (and,
// from t = 4 on, scaled by s) share of them. At Rot = 1 this is fe_step,
// operation for operation.
template <int Rot, bool FastSqrt>
__device__ __forceinline__ void rot_group_step(float S[Rot], float v[Rot],
                                               float a, float b, float s,
                                               const FeConsts& c) {
  const float za = c.rho_sd * a + c.rhoc_sd * b;
  const float ca = c.C * a;
  float zs = 0.0f, cb = 0.0f, sza = 0.0f, sca = 0.0f, szs = 0.0f, scb = 0.0f;
  if (Rot > 2) {
    zs = c.rho_sd * b - c.rhoc_sd * a;
    cb = c.C * b;
  }
  if (Rot > 4) {
    sza = s * za;
    sca = s * ca;
    szs = s * zs;
    scb = s * cb;
  }
#pragma unroll
  for (int t = 0; t < Rot; ++t) {
    const bool swap = (t & 2) != 0;
    const float zc = t < 4 ? (swap ? zs : za) : (swap ? szs : sza);
    const float cg = t < 4 ? (swap ? cb : ca) : (swap ? scb : sca);
    const float sqv =
        FastSqrt ? v[t] * nm_rsqrt(fmaxf(v[t], kRsqrtFloor)) : sqrtf(v[t]);
    if ((t & 1) == 0) {
      S[t] = S[t] * (c.one_rdt + sqv * zc);
      v[t] = fabsf(c.B * v[t] + c.A + sqv * cg);
    } else {
      S[t] = S[t] * (c.one_rdt - sqv * zc);
      v[t] = fabsf(c.B * v[t] + c.A - sqv * cg);
    }
  }
}

// S_T of the Rot copies of group `path` of generator R's stream (key (k0,
// k1), epoch): N steps from (S_0, v_0) with the constants c
// (ops/fe.py::fe_moments_kernel_plain). The packed boxes take 3 words a
// block: 3 draws of the stream (4 words each, in order) feed 4 blocks, and
// at Rot > 4 they supply each pair's scale; other Rot = 8 groups take
// radius_antithetic_scale of the pair.
template <int R, int Rot, int Box, bool FastSqrt>
__device__ __forceinline__ void fe_group_path(const FeParams& p,
                                              const FeConsts& c, uint32_t k0,
                                              uint32_t k1, uint32_t epoch,
                                              uint32_t path, int N,
                                              float S[Rot]) {
  constexpr bool kPacked = Box == kHc16 || Box == kHc16f;
  static_assert(!kPacked || R == kDevice,
                "the packed boxes belong to the device generator");
  static_assert(!FastSqrt || R == kDevice,
                "fast_sqrt belongs to the device generator");
  constexpr bool kWithScale = kPacked && Rot > 4;
  constexpr int kWords = kPacked ? 3 : 4;     // words per counter block
  constexpr int kGroup = kPacked ? 4 : 1;     // counter blocks per iteration
  float v[Rot];
#pragma unroll
  for (int t = 0; t < Rot; ++t) {
    S[t] = p.S_0;
    v[t] = p.v_0;
  }
  const uint32_t n = (uint32_t)N;
  const uint32_t n_blocks = (n + 1) / 2;
#pragma unroll 1
  for (uint32_t j0 = 0; j0 < n_blocks; j0 += kGroup) {
    uint32_t w[kWords * kGroup];
#pragma unroll
    for (int d = 0; d < kWords * kGroup / 4; ++d) {
      // draw d of this iteration: call j0 (4 words a block) or 3 j0 / 4 + d
      uint32_t* o = w + 4 * d;
      o[0] = kPacked ? 3u * (j0 / 4u) + (uint32_t)d : j0;
      o[1] = epoch;
      o[2] = path;
      o[3] = 0u;
      counter_block<R>(o[0], o[1], o[2], o[3], k0, k1);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const uint32_t j = j0 + (uint32_t)i;
      if (kGroup > 1 && j >= n_blocks) break;
      float g[4], sc[2] = {0.0f, 0.0f};
      block_normals<Box, kWithScale>(w + kWords * i, g, sc);
      const float s0 =
          Rot > 4 && !kWithScale ? radius_antithetic_scale(g[0], g[1]) : sc[0];
      rot_group_step<Rot, FastSqrt>(S, v, g[0], g[1], s0, c);
      if (2 * j + 1 < n) {
        const float s1 = Rot > 4 && !kWithScale
                             ? radius_antithetic_scale(g[2], g[3])
                             : sc[1];
        rot_group_step<Rot, FastSqrt>(S, v, g[2], g[3], s1, c);
      }
    }
  }
}

}  // namespace
}  // namespace nmch
