// K2-LRM: the score-function (likelihood-ratio) variant of the EM path kernel
// on Hopper (sm_90a). One thread per path runs K2's step loops themselves
// (em_path.cuh::em_path_steps: the Poisson and Marsaglia-Tsang samplers on
// the path's counter stream, the same draws as K2 under either schedule),
// and the loops' per-step report (LrmReport) adds the scores of the step's
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
// What bounds it on an H100: instruction issue, as K2's step loops: the
// samplers' rounds, plus per step a digamma (at most 6 reciprocals of its
// recurrence, a logf and the asymptotic series), a logf, two divisions and
// the five scores (~100 FP32 instructions). The schedule is the step
// loops: the round schedule moves no draw, so the scores are the same.
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
__device__ __forceinline__ float digamma(float z) {
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

// K2's step loops report each step here: the scores, summed per path, and
// at the end v_T and vI_rest.
struct LrmReport {
  static constexpr bool kPerStep = true;
  const LrmJac& J;
  float sc[kLrm] = {};
  float v_T = 0.0f, vI_rest = 0.0f;

  __device__ void step(const EmArgs& a, int i, float Vt, float lam,
                       float n_p, float alpha, float g) {
    const float pois_fac = n_p / fmaxf(lam, kLamFloor) - 1.0f;
    const float gam_d =
        nmch::nm_log(fmaxf(g, kGammaLogFloor)) - digamma(alpha);
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

template <int R>
__global__ void __launch_bounds__(kPathThreads)
    em_lrm_paths(EmArgs a, LrmJac J, float* __restrict__ out,
                 int64_t n_paths) {
  const uint32_t idx = blockIdx.x * kPathThreads + threadIdx.x;
  uint32_t ctr;
  LrmReport rep{J};
  nmch::em_path_steps<R, true>(a, a.base_path + idx, ctr, rep);
  out[idx] = rep.v_T;
  out[n_paths + idx] = rep.vI_rest;
#pragma unroll
  for (int q = 0; q < kLrm; ++q) out[(2 + q) * n_paths + idx] = rep.sc[q];
}

template <int R>
cudaError_t launch_lrm(const EmArgs& a, const LrmJac& J, int64_t n_paths,
                       float* out, cudaStream_t st) {
  em_lrm_paths<R><<<(unsigned)(n_paths / kPathThreads), kPathThreads, 0,
                    st>>>(a, J, out, n_paths);
  return cudaGetLastError();
}

}  // namespace

// Per path of n_paths EM paths, into out (float32[7 * n_paths], device; row
// q at out[q * n_paths]): v_T, vI_rest = sum_t (v_t + v_{t+1}) - v_0, and
// the five scores sum_t d log p_t / d(T, v_0, k, theta, sigma). consts: the
// 13 float32 values of ops/em.py::EmConsts and jac: float32[3 * 5]
// (row-major d(lam_c, d, vfac) / d(T, v_0, k, theta, sigma)), both on the
// host. rng: 0 = philox, 1 = threefry4. Launches on `stream` and does not
// synchronise. Returns the launch's cudaError_t (0 on success); nothing is
// launched for invalid arguments.
extern "C" int nmch_em_lrm(const float* consts, const float* jac, uint32_t k0,
                           uint32_t k1, uint32_t epoch, uint32_t base_path,
                           int64_t N, int64_t n_paths, int rng, float* out,
                           void* stream) {
  if (nmch::em_bad_sizes(N, n_paths) || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const EmArgs a = nmch::em_args(consts, k0, k1, epoch, base_path, N);
  LrmJac J;
  for (int i = 0; i < 3; ++i) {
    for (int q = 0; q < kLrm; ++q) J.j[i][q] = jac[kLrm * i + q];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rng) {
    case nmch::kPhilox:
      return (int)launch_lrm<nmch::kPhilox>(a, J, n_paths, out, st);
    case nmch::kThreefry4:
      return (int)launch_lrm<nmch::kThreefry4>(a, J, n_paths, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
