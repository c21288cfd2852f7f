// One Broadie-Kaya exact-scheme path per thread: the device half of em.cu
// (K2) and sweep.cu (K4).
//
// Operation for operation the plain PyTorch version (nmch_tpu_torch/ops/
// em.py and ops/sampling.py), itself the counter-rng half of nmch_tpu/ops/
// em.py and ops/sampling.py. A path's draws are 4-word blocks at its
// counters 0, 1, 2, ...: in each step the Poisson sampler's rounds (Knuth
// below lam = 10, the one-round normal approximation at and above the cut,
// PTRS between), then the Marsaglia-Tsang (MT) Gamma rounds, and after the
// last step the terminal normal (none with `conditional`); the caps
// (Poisson 64 rounds, Gamma 32) and the straggler fallbacks are the plain
// version's. A path's counter and payoff are a function of its own stream
// alone, so two schedules of the same draws give the same bits:
//
// - The step schedule (em_path_steps): a thread runs each sampler's own
//   loop, and the warp runs a sampler's rounds until its slowest lane is
//   done, once per Poisson regime its lanes are in, then the next step.
//   Where every lane takes the one-round normal branch (the CLI's default,
//   cut 128 at default parameters) a warp idles only on the rare second MT
//   round, and these tight loops are the fastest code found.
// - The round schedule (em_path_rounds): one loop in which a lane carries
//   its stage (a Poisson sampler, MT or the terminal), round and the
//   stage's constants in registers (EmLane), and each iteration the phase
//   that holds more of the warp's lanes draws, one block for each of its
//   lanes: the Gamma phase (an MT round) or the step phase (a Poisson round
//   of any regime, or the terminal draw). A lane that ends a stage runs the
//   next stage's set-up in the same iteration and draws again when its
//   phase is next chosen. So a lane that needs another PTRS, Knuth or MT
//   round no longer holds the warp's other lanes: they go on with their
//   next step and meet it again in the same phase; and a warp of mixed
//   Poisson regimes runs the phase's samplers side by side. The counter
//   block runs once per iteration for the warp (it sits outside the
//   phase's stage branches), and the Box-Muller normal's logf shares one
//   call with PTRS's acceptance logf (a selected argument: the same
//   libdevice function on the same float gives the same bits).
//
// The schedule is picked per point, on the host, from the share of steps
// that leave the normal branch (em_rounds_pay, the one place that decides):
// em.cu launches K2 built for that schedule alone, and K4 reads each
// point's decision from its dispatch table (nmch_em_schedule). On
// an H100 the round loop costs ~15% more than the step loops at an equal
// schedule (votes, stage tests, state kept across iterations); it took
// 0.77-0.95x their time where over ~7% of steps leave the normal branch
// and 1.07-1.21x below that (K2 on each of explore's points).
//
// Both schedules draw through a counter of one of two types (Counter). The
// plain counter is the path's uint32_t. Under one wave a launch runs at
// the pace of one path's chain of dependent instructions, not of issue,
// and each round's counter block (~20 dependent integer operations) heads
// that chain: a short hash in its place took K2 12.4% faster at explore's
// 40 blocks on an H100. The lookahead counter (AheadCounter, K2's
// em_paths in em.cu) takes the block off the chain: it holds the next
// block and computes the one after it while the float math of the block
// just handed out runs. That took the same launches 7.7% faster (11.5% on the
// step loops; 3.0% on the round schedule, where a lane's draw is followed
// by its stage's branches, which leave little float math in the same
// basic block to issue beside the block). Starting the refill later in the
// round's step phase, after its PTRS set-up, gained nothing more. A
// second block of lookahead was not tried: a warp issues in order, so a
// block started two draws ahead would issue its chain beside the same
// float math as one started one draw ahead. At full load, where issue
// bounds K2, it cost nothing either (1-6% less time at 2^18 paths, with
// 39-44 registers against the plain counter's 31-39). The law build, K4
// and K2-LRM keep the plain counter.
//
// Numerics: every float operation of a lane is the plain version's, in its
// order (built with -fmad=false, no --use_fast_math; IEEE sqrtf and
// division). The transcendentals are libdevice's logf, expf, log1pf and
// rsqrtf, the functions torch's CUDA ops call for float32 (nm_* here and in
// fe_path.cuh), so that a path's counter and payoff equal the plain
// version's on the card.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "fe_path.cuh"
#include "reduce.cuh"

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

// The C entries' size checks: at least one block of paths, whole blocks.
inline bool em_bad_sizes(int64_t N, int64_t n_paths) {
  return N < 1 || N > (int64_t(1) << 30) || n_paths < kPathThreads ||
         n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32);
}

// EmArgs from the kEmConsts float32 constants (host memory) and the stream
// coordinates.
inline EmArgs em_args(const float* c, uint32_t k0, uint32_t k1,
                      uint32_t epoch, uint32_t base_path, int64_t N) {
  static_assert(kEmConsts == 13, "EmArgs takes 13 constants");
  return EmArgs{c[0], c[1], c[2], c[3],  c[4],  c[5],  c[6],
                c[7], c[8], c[9], c[10], c[11], c[12],
                k0,   k1,   epoch, base_path, (int)N};
}

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

// The block of 4 words at counter `ctr` of path `path`'s stream; advances
// ctr.
template <int R>
__device__ __forceinline__ void draw4(uint32_t& ctr, const EmArgs& a,
                                      uint32_t path, uint32_t w[4]) {
  w[0] = ctr;
  w[1] = a.epoch;
  w[2] = path;
  w[3] = 0u;
  counter_block<R>(w[0], w[1], w[2], w[3], a.k0, a.k1);
  ++ctr;
}

// A path's counter as the samplers draw from it, of one of two types. The
// plain counter is the uint32_t ctr itself: draw() is draw4. The lookahead
// counter (K2's em_paths) holds, beside the count, the block at it in
// registers: draw() hands that block out and at once starts the next.
// A path draws its blocks at 0, 1, 2, ... whichever sampler takes them, so
// that block's integer chain (Philox's 10 rounds of multiply and xor, or
// Threefry's 12 of add, rotate and xor) depends on no float result, and is
// issued beside the float math of the block just handed out instead of
// ahead of it on one round's chain. The same blocks in the same order and
// every float operation as with the plain counter; it computes one block
// past the last one drawn, which blocks_drawn() leaves out.
template <int R>
struct AheadCounter {
  uint32_t n;        // the blocks handed out
  uint32_t held[4];  // the block at counter n
};

template <int R, bool kAhead>
using Counter = std::conditional_t<kAhead, AheadCounter<R>, uint32_t>;

template <int R>
__device__ __forceinline__ void start(uint32_t& ctr, const EmArgs&,
                                      uint32_t) {
  ctr = 0u;
}

template <int R>
__device__ __forceinline__ void start(AheadCounter<R>& c, const EmArgs& a,
                                      uint32_t path) {
  c.n = 0u;
  uint32_t at = 0u;
  draw4<R>(at, a, path, c.held);
}

// The block at the path's counter into w; advances the counter.
template <int R>
__device__ __forceinline__ void draw(uint32_t& ctr, const EmArgs& a,
                                     uint32_t path, uint32_t w[4]) {
  draw4<R>(ctr, a, path, w);
}

template <int R>
__device__ __forceinline__ void draw(AheadCounter<R>& c, const EmArgs& a,
                                     uint32_t path, uint32_t w[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = c.held[j];
  ++c.n;
  uint32_t at = c.n;
  draw4<R>(at, a, path, c.held);
}

__device__ __forceinline__ uint32_t blocks_drawn(uint32_t ctr) { return ctr; }

template <int R>
__device__ __forceinline__ uint32_t blocks_drawn(const AheadCounter<R>& c) {
  return c.n;
}

__device__ __forceinline__ float cos_2pi(float u) {
  float c, s;
  sincos_2pi(u, c, s);
  return c;
}

// rng/normal.py::boxmuller's first output from the log of its first
// uniform: sqrt(-2 ln u1) cos(2 pi u2)
__device__ __forceinline__ float normal_from_log(float log_u1, uint32_t w1) {
  return sqrtf(-2.0f * log_u1) * cos_2pi(uniform_open01(w1));
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

// ln S_T ~ N(m, sig_eff^2) given the variance path: v_T and the running sum
// of (v_t + v_{t+dt}) (ops/em.py::path_law_from_consts's tail)
__device__ __forceinline__ void path_law(const EmArgs& a, float Vt,
                                         float vI_sum, float& m,
                                         float& sig_eff) {
  const float vI = vI_sum * a.half_dt;
  m = a.m0 - 0.5f * vI + a.rho_s * (Vt - a.v_0 - a.ktT + a.k * vI);
  sig_eff = sqrtf(a.one_m_rho2 * vI);
}

// E[(S_T - K)^+ | variance path], K = S_0 (em_conditional_payoff)
__device__ __forceinline__ float conditional_payoff(const EmArgs& a, float m,
                                                    float sig_eff) {
  const float s = fmaxf(sig_eff, kSigFloor);
  const float dd = (a.log_S0 - m) / s;
  return nm_exp(m + 0.5f * s * s) * norm_cdf(s - dd) -
         a.S_0 * norm_cdf(-dd);
}

// (S_T - K)^+ with the terminal normal g
__device__ __forceinline__ float terminal_payoff(const EmArgs& a, float m,
                                                 float sig_eff, float g) {
  return fmaxf(nm_exp(m + sig_eff * g) - a.S_0, 0.0f);
}

// ---- The step schedule ----------------------------------------------------

// N_p ~ Poisson(lam) (ops/sampling.py::poisson_from_stream), drawn through
// the path's counter (Counter).
template <int R, class Ctr>
__device__ float poisson(float lam, Ctr& ctr, const EmArgs& a,
                         uint32_t path) {
  uint32_t w[4];
  if (lam < kPoissonSmall) {
    // Knuth: multiply uniforms until the product drops below e^{-lam}
    const float target = nm_exp(-lam);
    float t = 1.0f, cnt = 0.0f;
    for (int rnd = 0; rnd < kPoissonMaxRounds; ++rnd) {
      draw<R>(ctr, a, path, w);
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
    draw<R>(ctr, a, path, w);
    const float g = normal_from_log(nm_log(uniform_open01(w[0])), w[1]);
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
    draw<R>(ctr, a, path, w);
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
// gamma_ms_from_stream), drawn through the path's counter (Counter).
template <int R, class Ctr>
__device__ float gamma_ms(float alpha0, Ctr& ctr, const EmArgs& a,
                          uint32_t path) {
  const bool need_boost = alpha0 < 1.0f;
  const float alpha = alpha0 + (need_boost ? 1.0f : 0.0f);
  const float d = alpha - kThird;
  const float cmul = nm_rsqrt(9.0f * d);
  float C = 1.0f;
  uint32_t w[4];
  for (int rnd = 0; rnd < kGammaMaxRounds; ++rnd) {
    draw<R>(ctr, a, path, w);
    const float x = normal_from_log(nm_log(uniform_open01(w[0])), w[1]);
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

// What a path reports beside its payoff. Both schedules call end() with v_T
// and the running sum of (v_t + v_{t+dt}); a report with kPerStep also gets
// step() once a step, in step order, after the step's Gamma draw (the step
// i, v_t, lam = lam_const v_t, the Poisson index n, the Gamma shape alpha =
// d + n and the Gamma draw g). The pricing builds report nothing: NoReport's
// empty calls compile away, and the round schedule keeps n for step() only
// where kPerStep asks for it, so those builds keep their registers.
struct NoReport {
  static constexpr bool kPerStep = false;
  __device__ void step(const EmArgs&, int, float, float, float, float,
                       float) {}
  __device__ void end(const EmArgs&, float, float) {}
};

// The law build's report (em.cu): the values of ops/em.py::
// path_law_from_consts, v_T and vI = the running sum times dt/2.
struct LawReport {
  static constexpr bool kPerStep = false;
  float v_T = 0.0f, vI = 0.0f;
  __device__ void step(const EmArgs&, int, float, float, float, float,
                       float) {}
  __device__ void end(const EmArgs& a, float Vt, float vI_sum) {
    v_T = Vt;
    vI = vI_sum * a.half_dt;
  }
};

// The step schedule on a counter of either type (Counter).
template <int R, bool kConditional, class Ctr, class Report>
__device__ __forceinline__ float path_steps(const EmArgs& a, uint32_t path,
                                            Ctr& ctr, Report& rep) {
  float Vt = a.v_0;
  float vI = 0.0f;
  start<R>(ctr, a, path);
  for (int i = 0; i < a.N; ++i) {
    const float lam = a.lam_const * Vt;
    const float n_p = poisson<R>(lam, ctr, a, path);
    const float alpha = a.d + n_p;
    const float gam = gamma_ms<R>(alpha, ctr, a, path);
    rep.step(a, i, Vt, lam, n_p, alpha, gam);
    const float v_next = a.vfac * gam;
    vI = vI + (Vt + v_next);  // dt/2 applied once after the loop
    Vt = v_next;
  }
  rep.end(a, Vt, vI);
  float m, sig_eff;
  path_law(a, Vt, vI, m, sig_eff);
  if (kConditional) return conditional_payoff(a, m, sig_eff);
  // terminal draw: one more block
  uint32_t w[4];
  draw<R>(ctr, a, path, w);
  return terminal_payoff(a, m, sig_eff,
                         normal_from_log(nm_log(uniform_open01(w[0])), w[1]));
}

// kAhead: the lookahead counter (AheadCounter), else the plain one; ctr
// receives the blocks drawn.
template <int R, bool kConditional, bool kAhead = false,
          class Report = NoReport>
__device__ float em_path_steps(const EmArgs& a, uint32_t path, uint32_t& ctr,
                               Report&& rep = Report()) {
  if constexpr (kAhead) {
    AheadCounter<R> c;
    const float payoff = path_steps<R, kConditional>(a, path, c, rep);
    ctr = blocks_drawn(c);
    return payoff;
  } else {
    return path_steps<R, kConditional>(a, path, ctr, rep);
  }
}

// ---- The round schedule ---------------------------------------------------

// A lane's stage: kStageGamma is the Gamma phase, the stages before it and
// kStageTerminal the step phase.
enum EmStage : int {
  kStageKnuth = 0,     // Poisson(lam), lam < 10: Knuth's product
  kStagePtrs = 1,      // Poisson(lam) below the cut: a PTRS round
  kStageNormal = 2,    // Poisson(lam) at and above the cut: one round
  kStageGamma = 3,     // Gamma(alpha0): an MT round
  kStageTerminal = 4,  // the terminal normal
  kStageDone = 5,
};

// A path's state between iterations. The stage's constants share six
// slots q0..q5:
//   Knuth     q0 lam, q1 target = e^-lam, q2 the product t, q3 its count
//   PTRS      q0 lam, q1 b, q2 a, q3 1/alpha, q4 v_r, q5 ln lam
//   normal    q0 lam, q1 sqrt(lam)
//   Gamma     q0 alpha0, q1 d, q2 1/sqrt(9 d), q3 the boost factor C,
//             q4 the step's Poisson index (for a per-step report)
//   terminal  q0 m, q1 sig_eff
// Ctr: the path's counter (Counter).
template <class Ctr>
struct EmLane {
  float Vt, vI;  // v_t and the running sum of (v_t + v_{t+dt})
  float q0, q1, q2, q3, q4, q5;
  Ctr ctr;       // the next block's counter
  int i;         // the step
  int stage, rnd;
};

// Enter step s.i: lam, its Poisson regime and the regime's constants, as
// poisson() sets them up; after the last step, the terminal stage, or with
// kConditional the payoff.
template <bool kConditional, class Lane>
__device__ __forceinline__ void begin_step(Lane& s, const EmArgs& a,
                                           float& payoff) {
  s.rnd = 0;
  if (s.i < a.N) {
    const float lam = a.lam_const * s.Vt;
    s.q0 = lam;
    if (lam < kPoissonSmall) {
      s.stage = kStageKnuth;
      s.q1 = nm_exp(-lam);
      s.q2 = 1.0f;
      s.q3 = 0.0f;
      return;
    }
    const float sqrt_lam = sqrtf(lam);
    if (lam >= a.poisson_cut) {
      s.stage = kStageNormal;
      s.q1 = sqrt_lam;
      return;
    }
    s.stage = kStagePtrs;
    const float b = kPtrsB0 + kPtrsB1 * sqrt_lam;
    s.q1 = b;
    s.q2 = kPtrsA0 + kPtrsA1 * b;
    s.q3 = kPtrsInvAlpha0 + kPtrsInvAlpha1 / (b - kPtrsInvAlpha2);
    s.q4 = kPtrsVr0 - kPtrsVr1 / (b - 2.0f);
    s.q5 = nm_log(lam);
    return;
  }
  float m, sig_eff;
  path_law(a, s.Vt, s.vI, m, sig_eff);
  if (kConditional) {
    payoff = conditional_payoff(a, m, sig_eff);
    s.stage = kStageDone;
  } else {
    s.stage = kStageTerminal;
    s.q0 = m;
    s.q1 = sig_eff;
  }
}

// What the round schedule counts of its warp's draws (Count): iteration()
// once an iteration of its loop, which every lane of the warp runs and in
// which the warp draws one block for the lanes of its phase. NoCount's
// iteration() compiles away (K4, the law build, K2-LRM); K2 counts (em.cu).
// The step loops count nothing: every count tried there (a vote or an add
// in their rarer rounds, a vote at the end of each step, shared-memory
// slots) took K2's philox step build at cut 128 from ~5.0 to 5.2-6.1 ms on
// an H100 (ptxas moved Philox's round keys off the uniform datapath, or the
// build passed 40 registers, 12 blocks an SM).
struct NoCount {
  __device__ void iteration() {}
};

// kAhead and Report: as em_path_steps; a lane reports its steps in order,
// each when its Gamma phase settles the draw (accepted, or the
// kGammaMaxRounds fallback). With the lookahead counter a lane of the
// chosen phase takes its held block and starts the next before the
// stage's float math.
template <int R, bool kConditional, bool kAhead = false,
          class Report = NoReport, class Count = NoCount>
__device__ float em_path_rounds(const EmArgs& a, uint32_t path, uint32_t& ctr,
                                Report&& rep = Report(),
                                Count&& tally = Count()) {
  constexpr bool kPerStep = std::remove_reference_t<Report>::kPerStep;
  constexpr unsigned kWarpAll = 0xFFFFFFFFu;
  EmLane<Counter<R, kAhead>> s;
  s.Vt = a.v_0;
  s.vI = 0.0f;
  start<R>(s.ctr, a, path);
  s.i = 0;
  float payoff = 0.0f;
  begin_step<kConditional>(s, a, payoff);
  for (;;) {
    // the phase with more lanes draws; ties go to the step phase
    const bool active = s.stage != kStageDone;
    const bool gamma = s.stage == kStageGamma;
    const unsigned in_gamma = __ballot_sync(kWarpAll, gamma);
    const unsigned in_step = __ballot_sync(kWarpAll, active && !gamma);
    if ((in_gamma | in_step) == 0u) break;
    tally.iteration();
    uint32_t w[4];
    if (__popc(in_gamma) > __popc(in_step)) {
      // the Gamma phase: an MT round
      if (!gamma) continue;
      draw<R>(s.ctr, a, path, w);
      const float x = normal_from_log(nm_log(uniform_open01(w[0])), w[1]);
      const float v1 = 1.0f + s.q2 * x;
      const float v = v1 * v1 * v1;
      const float u = uniform_open01(w[2]);
      const float x2 = x * x;
      // boost factor U^(1/alpha0), drawn once, in the first round
      if (s.rnd == 0 && s.q0 < 1.0f) {
        s.q3 = nm_exp(nm_log(uniform_open01(w[3])) / s.q0);
      }
      bool ok = false;
      if (v > 0.0f) {
        ok = u < 1.0f - kMtSqueeze * x2 * x2;
        if (!ok) {
          const float logv = nm_log(fmaxf(v, kMtLogFloor));
          ok = nm_log(u) < 0.5f * x2 + s.q1 * (1.0f - v + logv);
        }
      }
      float gam;
      if (ok) {
        gam = s.q1 * v * s.q3;
      } else if (++s.rnd == kGammaMaxRounds) {
        gam = (s.q0 + (s.q0 < 1.0f ? 1.0f : 0.0f)) * s.q3;  // alpha * C
      } else {
        continue;
      }
      if constexpr (kPerStep) {
        // em_path_steps' report: lam is the same float product
        rep.step(a, s.i, s.Vt, a.lam_const * s.Vt, s.q4, s.q0, gam);
      }
      const float v_next = a.vfac * gam;
      s.vI = s.vI + (s.Vt + v_next);  // dt/2 applied once after the loop
      s.Vt = v_next;
      ++s.i;
      begin_step<kConditional>(s, a, payoff);
      continue;
    }
    // the step phase: a Poisson round of the lane's regime, or the
    // terminal draw
    if (!active || gamma) continue;
    draw<R>(s.ctr, a, path, w);
    // PTRS takes w0, w1 as half-open uniforms; its acceptance logf and the
    // Box-Muller radius's logf are one call
    float larg = uniform_open01(w[0]);
    float V = 0.0f, us = 0.0f, kf = 0.0f;
    if (s.stage == kStagePtrs) {
      const float U = uniform_halfopen01(w[0]) - 0.5f;
      V = uniform_halfopen01(w[1]);
      us = 0.5f - fabsf(U);
      kf = floorf((2.0f * s.q2 / us + s.q1) * U + s.q0 + kPtrsK);
      larg = V * s.q3 / (s.q2 / (us * us) + s.q1);
    }
    const float lg = nm_log(larg);
    float n_p;
    if (s.stage == kStageKnuth) {
      // 4 uniforms a round, multiplied in until t drops below e^-lam
      float t = s.q2, cnt = s.q3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t >= s.q1) {
          t = t * uniform_open01(w[j]);
          cnt = cnt + 1.0f;
        }
      }
      s.q2 = t;
      s.q3 = cnt;
      if (t < s.q1) {
        n_p = fmaxf(cnt - 1.0f, 0.0f);
      } else if (++s.rnd == kPoissonMaxRounds) {
        n_p = floorf(s.q0 + 0.5f);
      } else {
        continue;
      }
    } else if (s.stage == kStagePtrs) {
      // transformed rejection with squeeze; lg is the log of the ratio
      bool ok = us >= kPtrsUsSqueeze && V <= s.q4;
      if (!ok && !(kf < 0.0f || (us < kPtrsUsReject && V > us))) {
        ok = lg <= ptrs_log_accept_rhs(kf, s.q0, s.q5);
      }
      if (ok) {
        n_p = fmaxf(kf, 0.0f);
      } else if (++s.rnd == kPoissonMaxRounds) {
        n_p = floorf(s.q0 + 0.5f);
      } else {
        continue;
      }
    } else if (s.stage == kStageNormal) {
      // continuity-corrected normal approximation: one round
      n_p = fmaxf(floorf(s.q0 + s.q1 * normal_from_log(lg, w[1]) + 0.5f),
                  0.0f);
    } else {
      payoff = terminal_payoff(a, s.q0, s.q1, normal_from_log(lg, w[1]));
      s.stage = kStageDone;
      continue;
    }
    // Gamma(d + N_p), as gamma_ms() sets it up
    const float alpha0 = a.d + n_p;
    const bool need_boost = alpha0 < 1.0f;
    const float alpha = alpha0 + (need_boost ? 1.0f : 0.0f);
    const float d = alpha - kThird;
    s.q0 = alpha0;
    s.q1 = d;
    s.q2 = nm_rsqrt(9.0f * d);
    s.q3 = 1.0f;
    if constexpr (kPerStep) s.q4 = n_p;
    s.stage = kStageGamma;
    s.rnd = 0;
  }
  rep.end(a, s.Vt, s.vI);
  ctr = blocks_drawn(s.ctr);
  return payoff;
}

// ---- The choice -----------------------------------------------------------

// Whether the round schedule pays for these constants: the share of steps
// whose Poisson draw leaves the normal branch, estimated as P(v < cut /
// lam_const) for v_{T/2} given v_0 under a Gamma law with the CIR process's
// mean and variance, is at least 7%. (On an H100, K2 philox at 2^18 x 1000
// over explore's 200 points and eight cuts at default parameters: the round
// schedule took 0.77-0.95x the step schedule's time above ~7%, and
// 1.07-1.21x below it. Not measured for threefry4, whose block costs more
// instructions, so its break-even share may be lower.) Its series is that of the
// regularized lower incomplete gamma function; where it would not converge
// quickly (x >= the shape + 1), the share is above a half. Host code only:
// one float32 evaluation (the host's expf, logf and lgammaf) decides for K2
// and K4 alike.
inline bool em_rounds_pay(const EmArgs& a) {
  const float T = 2.0f * (float)a.N * a.half_dt;
  const float theta = a.ktT / (a.k * T);
  const float sig2 = 2.0f * a.k * a.vfac / (1.0f - a.lam_const * a.vfac);
  const float e = expf(-0.5f * a.k * T);
  const float mean = theta + (a.v_0 - theta) * e;
  const float var =
      sig2 * (1.0f - e) * (a.v_0 * e + 0.5f * theta * (1.0f - e)) / a.k;
  const float shape = mean * mean / var;
  const float x = a.poisson_cut / a.lam_const * mean / var;
  if (!(x < shape + 1.0f)) return true;
  float term = 1.0f / shape, sum = term;
  for (int n = 1; n < 64 && term > 1e-7f * sum; ++n) {
    term *= x / (shape + (float)n);
    sum += term;
  }
  return sum * expf(shape * logf(x) - x - lgammaf(shape)) >= 0.07f;
}

}  // namespace
}  // namespace nmch
