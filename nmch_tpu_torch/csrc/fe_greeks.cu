// G1: pathwise Greeks of the forward-Euler Heston price on Hopper (sm_90a),
// in forward mode. One thread per path runs K1's time loop (fe_path.cuh:
// the counter generator's block, the half-circle normals, Rot = 1) and
// carries beside (S, v) their tangents with respect to the 8 parameters
// (T, S_0, v_0, r, k, rho, theta, sigma); at maturity the payoff (S_T -
// K)^+ and its 8 tangents go into a deterministic two-pass float64 sum.
//
// Replaces, on the card, what nmch_tpu/ops/greeks.py gets from jax.grad
// through its lax.scan of the FE steps (fe_price_and_greeks, greeks.py:88,
// and the scan _fe_price_scan, greeks.py:45), which XLA compiles into a
// forward and a reverse loop over a tape of every step. The JAX package has
// no Pallas kernel here; the port's reverse-mode golden (ops/greeks.py)
// is plain torch and far too slow at the CLI's 2^18 x 1000.
//
// What bounds it on an H100: instruction issue, as K1. Reverse mode would
// store or recompute every step's state per path; forward mode needs only
// the tangents, in registers: S has 8 (one per parameter), v has 5 (v does
// not depend on S_0, r or rho), and each loop constant depends on two or
// three parameters, so a step adds ~80 FP32 operations and one division to
// K1's ~15 (~160 a counter block against K1's 226 SASS instructions). What
// the design does about it: everything in registers for all N steps, the
// structurally zero terms dropped at compile time (the dependency masks
// below), the constants' Jacobian computed once on the host and passed by
// argument, no memory traffic inside the loop, and one float64 partial of
// the 9 sums per block (no float atomics).
//
// Numerics: built with -fmad=false, every float operation is the plain
// version's (nmch_tpu_torch/ops/fe_greeks.py::fe_greeks_plain), in its
// order, with IEEE sqrtf and division, so each path's payoff and tangents
// are bitwise the plain version's; the means differ from it only by the
// order of the float64 sums. The tangent of the payoff at S_T == K is 0
// (jax.grad's is 1/2; a tie has probability zero), and that of |u| at u ==
// 0 is 0, as jax.grad's.

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::FeConsts;
using nmch::FeParams;
using nmch::kPathThreads;
using nmch::kReduceThreads;

constexpr int kParams = 8;             // ops/greeks.py::PARAM_NAMES order
constexpr int kOut = 1 + kParams;      // payoff and its 8 tangents
constexpr int kS0Dir = 1, kV0Dir = 2;  // S_0 and v_0
// Bit d set: the quantity depends on parameter d (ops/fe_greeks.py::V_DIRS
// and _DEPS): v on T, v_0, k, theta, sigma; A on T, k, theta; B on T, k; C
// on T, sigma; rho_sd and rhoc_sd on T, rho; one_rdt on T, r.
constexpr unsigned kDepV = 0xD5u;
constexpr unsigned kDepA = 0x51u;
constexpr unsigned kDepB = 0x11u;
constexpr unsigned kDepC = 0x81u;
constexpr unsigned kDepRho = 0x21u;
constexpr unsigned kDepR = 0x09u;

__host__ __device__ constexpr bool dep(unsigned mask, int d) {
  return ((mask >> d) & 1u) != 0u;
}

// d(A, B, C, rho_sd, rhoc_sd, one_rdt) / d(params), row per constant
// (ops/fe_greeks.py::consts_jacobian)
struct ConstsJac {
  float j[6][kParams];
};
enum ConstRow { kA = 0, kB = 1, kC = 2, kRhoSd = 3, kRhocSd = 4, kOneRdt = 5 };

// One Euler step of (S, v) and their tangents (ops/fe_greeks.py::
// tangent_step); dv[d] is used for the directions of kDepV only.
__device__ __forceinline__ void tangent_step(float& S, float dS[kParams],
                                             float& v, float dv[kParams],
                                             float g1, float g2,
                                             const FeConsts& c,
                                             const ConstsJac& J) {
  const float sqv = sqrtf(v);
  const float zc = c.rho_sd * g1 + c.rhoc_sd * g2;
  const float f = c.one_rdt + sqv * zc;
  const float cg = c.C * g1;
  const float u = c.B * v + c.A + sqv * cg;
  const float h = 0.5f / sqv;
  const float sg = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  float dsqv[kParams];
#pragma unroll
  for (int d = 0; d < kParams; ++d) {
    if (dep(kDepV, d)) dsqv[d] = dv[d] * h;
  }
#pragma unroll
  for (int d = 0; d < kParams; ++d) {
    const bool r = dep(kDepR, d), w = dep(kDepV, d), z = dep(kDepRho, d);
    float inner = 0.0f;
    if (r) inner = J.j[kOneRdt][d];
    if (w) {
      const float t = dsqv[d] * zc;
      inner = r ? inner + t : t;
    }
    if (z) {
      const float t = sqv * (J.j[kRhoSd][d] * g1 + J.j[kRhocSd][d] * g2);
      inner = r || w ? inner + t : t;
    }
    dS[d] = r || w || z ? dS[d] * f + S * inner : dS[d] * f;
  }
#pragma unroll
  for (int d = 0; d < kParams; ++d) {
    if (!dep(kDepV, d)) continue;
    float du = c.B * dv[d];
    if (dep(kDepB, d)) du = J.j[kB][d] * v + du;
    if (dep(kDepA, d)) du = du + J.j[kA][d];
    du = du + dsqv[d] * cg;
    if (dep(kDepC, d)) du = du + sqv * (J.j[kC][d] * g1);
    dv[d] = sg * du;
  }
  S = S * f;
  v = fabsf(u);
}

// Called by all kPathThreads threads of a block with their path's kOut
// values; writes the block's kOut float64 sums to partials[kOut *
// blockIdx.x ...] (a fixed tree, as reduce.cuh's).
__device__ __forceinline__ void block_sums_to_partials(const float x[kOut],
                                                       double* partials) {
  __shared__ double sh[kOut][kPathThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kOut; ++q) sh[q][t] = (double)x[q];
  __syncthreads();
#pragma unroll
  for (int s = kPathThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int q = 0; q < kOut; ++q) sh[q][t] += sh[q][t + s];
    }
    __syncthreads();
  }
  if (t < kOut) partials[kOut * (int64_t)blockIdx.x + t] = sh[t][0];
}

// One block: out[q] = (sum of the blocks' partials q) / n_paths, thread t
// taking blocks t, t + 256, ... in order, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
    sum_greek_partials(const double* __restrict__ partials, int64_t n_blocks,
                       int64_t n_paths, double* __restrict__ out) {
  __shared__ double sh[kOut][kReduceThreads];
  const int t = threadIdx.x;
  double acc[kOut];
#pragma unroll
  for (int q = 0; q < kOut; ++q) acc[q] = 0.0;
  for (int64_t i = t; i < n_blocks; i += kReduceThreads) {
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[q] += partials[kOut * i + q];
  }
#pragma unroll
  for (int q = 0; q < kOut; ++q) sh[q][t] = acc[q];
  __syncthreads();
#pragma unroll
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int q = 0; q < kOut; ++q) sh[q][t] += sh[q][t + w];
    }
    __syncthreads();
  }
  if (t < kOut) out[t] = sh[t][0] / (double)n_paths;
}

template <int R>
__global__ void __launch_bounds__(kPathThreads)
    fe_greeks_paths(FeParams p, ConstsJac J, uint32_t k0, uint32_t k1,
                    uint32_t epoch, uint32_t base_path, int N, int fix_strike,
                    double* __restrict__ partials,
                    float* __restrict__ per_path, int64_t n_paths) {
  const FeConsts c = nmch::fe_consts(p, N);
  const uint32_t idx = blockIdx.x * kPathThreads + threadIdx.x;
  const uint32_t path = base_path + idx;
  float S = p.S_0, v = p.v_0;
  float dS[kParams], dv[kParams];
#pragma unroll
  for (int d = 0; d < kParams; ++d) {
    dS[d] = d == kS0Dir ? 1.0f : 0.0f;
    dv[d] = d == kV0Dir ? 1.0f : 0.0f;
  }
  const uint32_t n = (uint32_t)N;
  const uint32_t n_blocks = (n + 1) / 2;
#pragma unroll 1
  for (uint32_t j = 0; j < n_blocks; ++j) {
    uint32_t w[4] = {j, epoch, path, 0u};
    nmch::counter_block<R>(w[0], w[1], w[2], w[3], k0, k1);
    float g[4], sc[2];
    nmch::block_normals<nmch::kHc, false>(w, g, sc);
    tangent_step(S, dS, v, dv, g[0], g[1], c, J);
    if (2 * j + 1 < n) tangent_step(S, dS, v, dv, g[2], g[3], c, J);
  }
  // the payoff and its tangents, 1{S_T > K} (S_T' - K'), K' = e_{S_0}
  // unless fix_strike
  const bool itm = S > p.S_0;
  float x[kOut];
  x[0] = fmaxf(S - p.S_0, 0.0f);
#pragma unroll
  for (int d = 0; d < kParams; ++d) {
    const float t = d == kS0Dir && fix_strike == 0 ? dS[d] - 1.0f : dS[d];
    x[1 + d] = itm ? t : 0.0f;
  }
  if (per_path != nullptr) {
#pragma unroll
    for (int q = 0; q < kOut; ++q) per_path[q * n_paths + idx] = x[q];
  }
  block_sums_to_partials(x, partials);
}

template <int R>
cudaError_t launch_greeks(const FeParams& p, const ConstsJac& J, uint32_t k0,
                          uint32_t k1, uint32_t epoch, uint32_t base_path,
                          int N, int fix_strike, int64_t n_paths,
                          double* partials, float* per_path,
                          cudaStream_t st) {
  fe_greeks_paths<R><<<(unsigned)(n_paths / kPathThreads), kPathThreads, 0,
                       st>>>(p, J, k0, k1, epoch, base_path, N, fix_strike,
                             partials, per_path, n_paths);
  return cudaGetLastError();
}

}  // namespace

// The FE price and its 8 pathwise Greeks over n_paths paths into out[0..8]
// (float64, device): out[0] the mean payoff, out[1 + d] the mean of its
// tangent in parameter d (T, S_0, v_0, r, k, rho, theta, sigma). params:
// float32[8] and jac: float32[6 * 8] (row-major d(A, B, C, rho_sd, rhoc_sd,
// one_rdt) / d(params)), both on the host. rng: 0 = philox, 1 = threefry4,
// 2 = threefry; fix_strike: 0 (K = S_0 moves with S_0) or 1. partials:
// float64[9 * n_paths / 128] scratch on the device; per_path: null or
// float32[9 * n_paths] on the device, row q of which receives value q of
// every path. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launches (0 on success); nothing is launched for
// invalid arguments.
extern "C" int nmch_fe_greeks(const float* params, const float* jac,
                              uint32_t k0, uint32_t k1, uint32_t epoch,
                              uint32_t base_path, int64_t N, int64_t n_paths,
                              int rng, int fix_strike, double* partials,
                              double* out, float* per_path, void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_paths < kPathThreads ||
      n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32) ||
      (fix_strike != 0 && fix_strike != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const FeParams p{params[0], params[1], params[2], params[3],
                   params[4], params[5], params[6], params[7]};
  ConstsJac J;
  for (int i = 0; i < 6; ++i) {
    for (int d = 0; d < kParams; ++d) J.j[i][d] = jac[kParams * i + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rng) {
    case nmch::kPhilox:
      err = launch_greeks<nmch::kPhilox>(p, J, k0, k1, epoch, base_path,
                                         (int)N, fix_strike, n_paths,
                                         partials, per_path, st);
      break;
    case nmch::kThreefry4:
      err = launch_greeks<nmch::kThreefry4>(p, J, k0, k1, epoch, base_path,
                                            (int)N, fix_strike, n_paths,
                                            partials, per_path, st);
      break;
    case nmch::kThreefry:
      err = launch_greeks<nmch::kThreefry>(p, J, k0, k1, epoch, base_path,
                                           (int)N, fix_strike, n_paths,
                                           partials, per_path, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  sum_greek_partials<<<1, kReduceThreads, 0, st>>>(
      partials, n_paths / kPathThreads, n_paths, out);
  return (int)cudaGetLastError();
}
