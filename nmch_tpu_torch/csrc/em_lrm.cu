// K2-LRM: the score-function (likelihood-ratio) variant of the EM path kernel
// on Hopper (sm_90a). One thread per path runs K2's own path code
// (em_path.cuh: the Poisson and Marsaglia-Tsang samplers on the path's
// counter stream), on the schedule K2 would take for these constants
// (em_rounds_pay: the step loops or the round schedule, one build each), and
// the schedule's per-step report (LrmReport) adds the scores of the step's
// joint density of (Poisson index n, next variance v') with respect to (T,
// v_0, k, theta, sigma):
//
//   d log Pois  = (n / max(lam, 1e-37) - 1) (v_t J_lam + [t = 0] lam_c e_v0)
//   d log Gamma = J_d (log max(g, 1e-37) - digamma(alpha))
//                 + J_vfac (g - alpha) / vfac,       g = v' / vfac,
//
// J = d(lam_c, d, vfac) / d(T, v_0, k, theta, sigma), passed by argument
// (ops/em_lrm.py: torch.func.jacfwd on the host). It writes per path v_T,
// vI_rest (the trapezoid's sum less v_0) and the five scores; the explicit
// derivative of the conditional payoff and the mean control variate stay a
// torch epilogue on those tensors (ops/em_lrm.py::em_greeks_lrm).
//
// Replaces, on the card, the score loop that nmch_tpu/ops/em_lrm.py
// (em_greeks_lrm, em_lrm.py:97) runs as an XLA fori_loop; the JAX package
// has no Pallas kernel for it. The floors 1e-37 on lam and g keep a lane
// whose Gamma draw underflowed (small shapes d << 1) finite, as there.
//
// What bounds it on an H100: instruction issue, as K2: the samplers' rounds,
// plus per step the report: a logf, two divisions, the five scores and
// digamma(d + n). Within a launch digamma(d + n) depends on the integer n
// alone, so a first kernel tabulates it for n < n_psi (lrm_psi_table, the
// same device function) and the report reads the table through L1; only
// n >= n_psi calls digamma (at most 6 reciprocals of its recurrence, a logf
// and the series), kept out of line so that the sampler loop stays small.
// At the strict cut (4000) most steps leave the normal branch and the round
// schedule keeps ~0.9 of a warp's lanes drawing against ~0.5 on the step
// loops; either schedule gives every path the same draws, so the scores are
// the same.
//
// Numerics: built with -fmad=false, every float operation is the plain
// version's (ops/em_lrm.py::lrm_scores_plain) in its order, with libdevice
// logf and IEEE division, so each path's outputs are bitwise the plain
// version's on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "em_path.cuh"

namespace {

using nmch::EmArgs;
using nmch::kPathThreads;

constexpr int kLrm = 5;                    // T, v_0, k, theta, sigma
constexpr float kLamFloor = 1e-37f;
constexpr float kGammaLogFloor = 1e-37f;
// digamma: the recurrence lifts z to at least kDgShift, then the
// asymptotic series (ops/em_lrm.py::digamma)
constexpr float kDgShift = 6.0f;
constexpr int kDgSteps = 6;
constexpr float kDg12 = 0.083333336f;      // 1/12
constexpr float kDg120 = 0.008333334f;     // 1/120
constexpr float kDg252 = 0.003968254f;     // 1/252
constexpr float kDg240 = 0.004166667f;     // 1/240
constexpr float kDg132 = 0.007575758f;     // 1/132

// rows lam_c, d, vfac; columns T, v_0, k, theta, sigma
struct LrmJac {
  float j[3][kLrm];
};

// psi(z), z > 0 (ops/em_lrm.py::digamma, operation for operation)
__device__ __noinline__ float digamma(float z) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kDgSteps; ++i) {
    if (z < kDgShift) {
      acc = acc + 1.0f / z;
      z = z + 1.0f;
    }
  }
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float series =
      zi2 * (kDg12 - zi2 * (kDg120 - zi2 * (kDg252 - zi2 * (kDg240 -
                                                            zi2 * kDg132))));
  return nmch::nm_log(z) - 0.5f * zi - series - acc;
}

// psi[n] = digamma(d + n), n < n_psi: the values the report would compute
// for alpha = d + n (the same float sum and function, so the same bits).
__global__ void __launch_bounds__(kPathThreads)
    lrm_psi_table(float d, int n_psi, float* __restrict__ psi) {
  const int n = blockIdx.x * kPathThreads + threadIdx.x;
  if (n < n_psi) psi[n] = digamma(d + (float)n);
}

// K2's schedules report each step here: the scores, summed per path, and
// at the end v_T and vI_rest.
struct LrmReport {
  static constexpr bool kPerStep = true;
  const LrmJac& J;
  const float* psi;  // lrm_psi_table
  float n_psi;
  float sc[kLrm] = {};
  float v_T = 0.0f, vI_rest = 0.0f;

  __device__ void step(const EmArgs& a, int i, float Vt, float lam,
                       float n_p, float alpha, float g) {
    const float pois_fac = n_p / fmaxf(lam, kLamFloor) - 1.0f;
    const float psi_alpha =
        n_p < n_psi ? __ldg(psi + (int)n_p) : digamma(alpha);
    const float gam_d = nmch::nm_log(fmaxf(g, kGammaLogFloor)) - psi_alpha;
    const float gam_v = (g - alpha) / a.vfac;
#pragma unroll
    for (int q = 0; q < kLrm; ++q) {
      float s = pois_fac * (Vt * J.j[0][q]);
      // v_0: the first transition's rate is lam_c * v_0
      if (q == 1 && i == 0) s = s + pois_fac * a.lam_const;
      s = s + J.j[1][q] * gam_d + J.j[2][q] * gam_v;
      sc[q] = sc[q] + s;
    }
  }
  __device__ void end(const EmArgs& a, float Vt, float vI_sum) {
    v_T = Vt;
    vI_rest = vI_sum - a.v_0;
  }
};

// kRounds: the round schedule, else the step loops (one build each, as K2)
template <int R, bool kRounds>
__global__ void __launch_bounds__(kPathThreads)
    em_lrm_paths(EmArgs a, LrmJac J, const float* __restrict__ psi,
                 float n_psi, float* __restrict__ out, int64_t n_paths) {
  const uint32_t idx = blockIdx.x * kPathThreads + threadIdx.x;
  uint32_t ctr;
  LrmReport rep{J, psi, n_psi};
  if constexpr (kRounds) {
    nmch::em_path_rounds<R, true>(a, a.base_path + idx, ctr, rep);
  } else {
    nmch::em_path_steps<R, true>(a, a.base_path + idx, ctr, rep);
  }
  out[idx] = rep.v_T;
  out[n_paths + idx] = rep.vI_rest;
#pragma unroll
  for (int q = 0; q < kLrm; ++q) out[(2 + q) * n_paths + idx] = rep.sc[q];
}

template <int R>
cudaError_t launch_lrm(const EmArgs& a, const LrmJac& J, bool rounds,
                       const float* psi, int n_psi, int64_t n_paths,
                       float* out, cudaStream_t st) {
  const unsigned g = (unsigned)(n_paths / kPathThreads);
  if (rounds) {
    em_lrm_paths<R, true><<<g, kPathThreads, 0, st>>>(a, J, psi, (float)n_psi,
                                                       out, n_paths);
  } else {
    em_lrm_paths<R, false><<<g, kPathThreads, 0, st>>>(
        a, J, psi, (float)n_psi, out, n_paths);
  }
  return cudaGetLastError();
}

}  // namespace

// Per path of n_paths EM paths, into out (float32[7 * n_paths], device; row
// q at out[q * n_paths]): v_T, vI_rest = sum_t (v_t + v_{t+1}) - v_0, and
// the five scores sum_t d log p_t / d(T, v_0, k, theta, sigma). consts: the
// 13 float32 values of ops/em.py::EmConsts and jac: float32[3 * 5]
// (row-major d(lam_c, d, vfac) / d(T, v_0, k, theta, sigma)), both on the
// host. rng: 0 = philox, 1 = threefry4. schedule: -1 the one K2 takes for
// these constants (em_rounds_pay), 0 the step loops, 1 the round schedule.
// psi: float32[n_psi] scratch on the device, 0 <= n_psi <= 2^24 (the
// digamma table; 0 computes every digamma in the report). Launches on
// `stream` and does not synchronise. Returns the launches' cudaError_t (0
// on success); nothing is launched for invalid arguments.
extern "C" int nmch_em_lrm(const float* consts, const float* jac, uint32_t k0,
                           uint32_t k1, uint32_t epoch, uint32_t base_path,
                           int64_t N, int64_t n_paths, int rng, int schedule,
                           float* psi, int64_t n_psi, float* out,
                           void* stream) {
  if (nmch::em_bad_sizes(N, n_paths) || out == nullptr || schedule < -1 ||
      schedule > 1 || n_psi < 0 || n_psi > (int64_t(1) << 24) ||
      (n_psi > 0 && psi == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const EmArgs a = nmch::em_args(consts, k0, k1, epoch, base_path, N);
  LrmJac J;
  for (int i = 0; i < 3; ++i) {
    for (int q = 0; q < kLrm; ++q) J.j[i][q] = jac[kLrm * i + q];
  }
  if (rng != nmch::kPhilox && rng != nmch::kThreefry4) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_psi > 0) {
    lrm_psi_table<<<(unsigned)((n_psi + kPathThreads - 1) / kPathThreads),
                    kPathThreads, 0, st>>>(a.d, (int)n_psi, psi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool rounds = schedule < 0 ? nmch::em_rounds_pay(a) : schedule == 1;
  return (int)(rng == nmch::kPhilox
                   ? launch_lrm<nmch::kPhilox>(a, J, rounds, psi, (int)n_psi,
                                               n_paths, out, st)
                   : launch_lrm<nmch::kThreefry4>(a, J, rounds, psi,
                                                  (int)n_psi, n_paths, out,
                                                  st));
}
