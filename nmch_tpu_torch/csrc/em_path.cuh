// One Broadie-Kaya exact-scheme path per thread: the device half of em.cu.
//
// Operation for operation the plain PyTorch version (nmch_tpu_torch/ops/
// em.py and ops/sampling.py), itself the counter-rng half of nmch_tpu/ops/
// em.py and ops/sampling.py. The JAX package runs the Poisson and Gamma
// rejection samplers as masked rounds over a tile of lanes; here each
// thread loops over its own rounds, which gives the same draws: a lane draws
// one 4-word block per round at its own counter, the counter advancing only
// while the lane is active, under the same caps (Poisson 64 rounds, Gamma
// 32) and the same straggler fallbacks. A thread computes only the Poisson
// regime it takes (the JAX code computes all three and selects).
//
// Numerics: every float operation is the plain version's, in its order
// (built with -fmad=false, no --use_fast_math; IEEE sqrtf and division).
// The transcendentals are libdevice's logf, expf, log1pf and rsqrtf, the
// functions torch's CUDA ops call for float32 (nm_* here and in
// fe_path.cuh), so that a path's counter and payoff equal the plain
// version's on the card.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "fe_path.cuh"

namespace nmch {
namespace {

// Loop constants, in the order of ops/em.py::EmConsts (float32, computed
// once on the host), then the stream coordinates and the step count.
struct EmArgs {
  float v_0, S_0, lam_const, d, vfac, half_dt, log_S0, m0, rho_s, ktT, k,
      one_m_rho2, poisson_cut;
  uint32_t k0, k1, epoch, base_path;
  int N;
};
constexpr int kEmConsts = 13;

// float32 literals of nmch_tpu/ops/sampling.py and ops/em.py (shortest
// round-trip decimal of each float32 value); tests/test_torch_em.py parses
// this table (and fe_path.cuh's sincos_2pi constants) and holds each
// literal to the JAX package's value.
constexpr float kPoissonSmall = 10.0f;
constexpr int kPoissonMaxRounds = 64;
constexpr int kGammaMaxRounds = 32;
// PTRS (Hörmann 1993)
constexpr float kPtrsB0 = 0.931f;
constexpr float kPtrsB1 = 2.53f;
constexpr float kPtrsA0 = -0.059f;
constexpr float kPtrsA1 = 0.02483f;
constexpr float kPtrsInvAlpha0 = 1.1239f;
constexpr float kPtrsInvAlpha1 = 1.1328f;
constexpr float kPtrsInvAlpha2 = 3.4f;
constexpr float kPtrsVr0 = 0.9277f;
constexpr float kPtrsVr1 = 3.6224f;
constexpr float kPtrsK = 0.43f;
constexpr float kPtrsUsSqueeze = 0.07f;
constexpr float kPtrsUsReject = 0.013f;
// Stirling series of lgamma
constexpr float kHalfLn2Pi = 0.9189385f;
constexpr float kStirling12 = 0.083333336f;
constexpr float kStirling360 = 0.0027777778f;
constexpr float kStirling1260 = 0.0007936508f;
// Marsaglia-Tsang
constexpr float kThird = 0.33333334f;
constexpr float kMtSqueeze = 0.0331f;
constexpr float kMtLogFloor = 1e-37f;
// Abramowitz-Stegun 7.1.26 normal CDF
constexpr float kAsP = 0.2316419f;
constexpr float kAsB0 = 0.31938154f;
constexpr float kAsB1 = -0.35656378f;
constexpr float kAsB2 = 1.7814779f;
constexpr float kAsB3 = -1.8212559f;
constexpr float kAsB4 = 1.3302745f;
constexpr float kInvSqrt2Pi = 0.3989423f;
constexpr float kSigFloor = 1e-12f;

__device__ __forceinline__ float nm_log1p(float x) { return log1pf(x); }

// The block of 4 words at counter `ctr` of path `path`'s stream.
template <int R>
__device__ __forceinline__ void draw4(uint32_t ctr, const EmArgs& a,
                                      uint32_t path, uint32_t w[4]) {
  w[0] = ctr;
  w[1] = a.epoch;
  w[2] = path;
  w[3] = 0u;
  counter_block<R>(w[0], w[1], w[2], w[3], a.k0, a.k1);
}

__device__ __forceinline__ float cos_2pi(float u) {
  float c, s;
  sincos_2pi(u, c, s);
  return c;
}

// First output of rng/normal.py::boxmuller(uniform_open01(w0),
// uniform_open01(w1)): sqrt(-2 ln u1) cos(2 pi u2)
__device__ __forceinline__ float normal_bm(uint32_t w0, uint32_t w1) {
  const float r = sqrtf(-2.0f * nm_log(uniform_open01(w0)));
  return r * cos_2pi(uniform_open01(w1));
}

__device__ __forceinline__ float stirling_corr(float zz) {
  const float i2 = (1.0f / zz) * (1.0f / zz);
  const float c = kStirling12 - i2 * (kStirling360 - i2 * kStirling1260);
  return c / zz;
}

// ops/sampling.py::ptrs_log_accept_rhs
__device__ __forceinline__ float ptrs_log_accept_rhs(float kf, float lam,
                                                     float loglam) {
  const float z = kf + 1.0f;
  const bool shift = z < 3.0f;
  const float logm = shift ? nm_log(z * (z + 1.0f)) : 0.0f;
  const float w = shift ? z + 2.0f : z;
  const float t = (w - lam) / lam;
  return -(w - 0.5f) * nm_log1p(t) + (kf - w + 0.5f) * loglam + (w - lam) -
         kHalfLn2Pi - stirling_corr(w) + logm;
}

// N_p ~ Poisson(lam) (ops/sampling.py::poisson_from_stream); advances ctr.
template <int R>
__device__ float poisson(float lam, uint32_t& ctr, const EmArgs& a,
                         uint32_t path) {
  uint32_t w[4];
  if (lam < kPoissonSmall) {
    // Knuth: multiply uniforms until the product drops below e^{-lam}
    const float target = nm_exp(-lam);
    float t = 1.0f, cnt = 0.0f;
    for (int rnd = 0; rnd < kPoissonMaxRounds; ++rnd) {
      draw4<R>(ctr, a, path, w);
      ++ctr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t >= target) {
          t = t * uniform_open01(w[j]);
          cnt = cnt + 1.0f;
        }
      }
      if (t < target) return fmaxf(cnt - 1.0f, 0.0f);
    }
    return floorf(lam + 0.5f);
  }
  const float sqrt_lam = sqrtf(lam);
  if (lam >= a.poisson_cut) {
    // continuity-corrected normal approximation: one round, always done
    draw4<R>(ctr, a, path, w);
    ++ctr;
    const float g = normal_bm(w[0], w[1]);
    return fmaxf(floorf(lam + sqrt_lam * g + 0.5f), 0.0f);
  }
  // PTRS: transformed rejection with squeeze
  const float b = kPtrsB0 + kPtrsB1 * sqrt_lam;
  const float aa = kPtrsA0 + kPtrsA1 * b;
  const float invalpha =
      kPtrsInvAlpha0 + kPtrsInvAlpha1 / (b - kPtrsInvAlpha2);
  const float vr = kPtrsVr0 - kPtrsVr1 / (b - 2.0f);
  const float loglam = nm_log(lam);
  for (int rnd = 0; rnd < kPoissonMaxRounds; ++rnd) {
    draw4<R>(ctr, a, path, w);
    ++ctr;
    const float U = uniform_halfopen01(w[0]) - 0.5f;
    const float V = uniform_halfopen01(w[1]);
    const float us = 0.5f - fabsf(U);
    const float kf = floorf((2.0f * aa / us + b) * U + lam + kPtrsK);
    if (us >= kPtrsUsSqueeze && V <= vr) return fmaxf(kf, 0.0f);
    const bool rej = kf < 0.0f || (us < kPtrsUsReject && V > us);
    if (!rej) {
      const float logacc = nm_log(V * invalpha / (aa / (us * us) + b));
      if (logacc <= ptrs_log_accept_rhs(kf, lam, loglam)) {
        return fmaxf(kf, 0.0f);
      }
    }
  }
  return floorf(lam + 0.5f);
}

// Gamma(alpha0, 1) by Marsaglia-Tsang (ops/sampling.py::
// gamma_ms_from_stream); advances ctr.
template <int R>
__device__ float gamma_ms(float alpha0, uint32_t& ctr, const EmArgs& a,
                          uint32_t path) {
  const bool need_boost = alpha0 < 1.0f;
  const float alpha = alpha0 + (need_boost ? 1.0f : 0.0f);
  const float d = alpha - kThird;
  const float cmul = nm_rsqrt(9.0f * d);
  float C = 1.0f;
  uint32_t w[4];
  for (int rnd = 0; rnd < kGammaMaxRounds; ++rnd) {
    draw4<R>(ctr, a, path, w);
    ++ctr;
    const float x = normal_bm(w[0], w[1]);
    const float v1 = 1.0f + cmul * x;
    const float v = v1 * v1 * v1;
    const float u = uniform_open01(w[2]);
    const float x2 = x * x;
    // boost factor U^(1/alpha0), drawn once, in the first round
    if (rnd == 0 && need_boost) {
      C = nm_exp(nm_log(uniform_open01(w[3])) / alpha0);
    }
    if (v > 0.0f) {
      bool ok = u < 1.0f - kMtSqueeze * x2 * x2;
      if (!ok) {
        const float logv = nm_log(fmaxf(v, kMtLogFloor));
        ok = nm_log(u) < 0.5f * x2 + d * (1.0f - v + logv);
      }
      if (ok) return d * v * C;
    }
  }
  return alpha * C;
}

// ops/em.py::norm_cdf_vec
__device__ __forceinline__ float norm_cdf(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + kAsP * ax);
  float poly = kAsB4 * t + kAsB3;
  poly = poly * t + kAsB2;
  poly = poly * t + kAsB1;
  poly = poly * t + kAsB0;
  poly = poly * t;
  const float phi = kInvSqrt2Pi * nm_exp(-0.5f * ax * ax);
  const float nd = 1.0f - phi * poly;
  return x >= 0.0f ? nd : 1.0f - nd;
}

// One path: its payoff (ops/em.py::em_payoffs) and its final counter.
template <int R, bool kConditional>
__device__ float em_path(const EmArgs& a, uint32_t path, uint32_t& ctr) {
  float Vt = a.v_0;
  float vI = 0.0f;
  ctr = 0u;
  for (int i = 0; i < a.N; ++i) {
    const float lam = a.lam_const * Vt;
    const float n_p = poisson<R>(lam, ctr, a, path);
    const float gam = gamma_ms<R>(a.d + n_p, ctr, a, path);
    const float v_next = a.vfac * gam;
    vI = vI + (Vt + v_next);  // dt/2 applied once after the loop
    Vt = v_next;
  }
  vI = vI * a.half_dt;
  const float m =
      a.m0 - 0.5f * vI + a.rho_s * (Vt - a.v_0 - a.ktT + a.k * vI);
  const float sig_eff = sqrtf(a.one_m_rho2 * vI);
  if (kConditional) {
    // E[(S_T - K)^+ | variance path], K = S_0 (em_conditional_payoff)
    const float s = fmaxf(sig_eff, kSigFloor);
    const float dd = (a.log_S0 - m) / s;
    return nm_exp(m + 0.5f * s * s) * norm_cdf(s - dd) -
           a.S_0 * norm_cdf(-dd);
  }
  // terminal draw: one more block
  uint32_t w[4];
  draw4<R>(ctr, a, path, w);
  ++ctr;
  const float g = normal_bm(w[0], w[1]);
  return fmaxf(nm_exp(m + sig_eff * g) - a.S_0, 0.0f);
}

}  // namespace
}  // namespace nmch
