// Forward-Euler Heston paths driven by precomputed Brownian increments on
// Hopper (sm_90a): the path simulator of the QMC engine.
//
// Replaces nmch_tpu/ops/fe_qmc.py::_qmc_sim_kernel (K6, behind
// qmc_payoff_sums_pallas, fe_qmc.py:465). Inputs: dW1 and dW2, float32
// (N, M) row-major, M = n_shifts * n paths laid out replicate-major (path m
// belongs to replicate m / n). Each path runs N Euler steps of
// fe_path.cuh::fe_step from (S_0, v_0), step t driven by (dW1[t, m],
// dW2[t, m]), with the constants built at sqrt_dt = 1 as the TPU kernel
// builds them (the increments already carry sqrt(dt)). Outputs: each
// replicate's (sum payoff, sum payoff^2), payoff = max(S_N - S_0, 0).
//
// What bounds it on an H100: device memory. A path-step reads 8 bytes (one
// float of each factor) and does 9 FP32 operations and one IEEE square
// root, so the 8 N M bytes of dW1 and dW2 over 3.35 TB/s take longer than
// the operations at the issue rate. What the design does about it: one
// thread per path, S and v in registers for all N steps; a warp reads 32
// neighbouring paths of a row, so each load is one coalesced 128-byte line
// per factor and each byte is read once; the time loop is unrolled so that
// several steps' loads are in flight in each thread. The grid is
// (ceil(n / 128), n_shifts): no block straddles two replicates, and the
// ragged last block of a replicate (n = n_paths / 8 is only a multiple of
// 16 at the CLI's sizes) gives its idle threads a payoff of 0. The TPU
// kernel's 1024-path tiles have no counterpart here: any n runs.
//
// Reduction: each block writes one float64 (sum, sum_sq) partial to its
// replicate's row (reduce.cuh), and the second pass runs one block per
// replicate. No float atomics: equal inputs give bitwise-equal sums.
//
// Numerics: -fmad=false and IEEE sqrtf, as in fe.cu: a path's payoff is
// bitwise the plain version's (nmch_tpu_torch/ops/fe_qmc.py::
// qmc_payoff_sums_plain); the sums differ from it only by the order of the
// float64 additions.

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;

constexpr int64_t kMaxShifts = 65535;          // gridDim.y
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;     // gridDim.x

__global__ void __launch_bounds__(kPathThreads)
    qmc_sim_paths(nmch::FeParams p, const float* __restrict__ dW1,
                  const float* __restrict__ dW2, int N, int64_t M, int64_t n,
                  double* __restrict__ partials) {
  const nmch::FeConsts c = nmch::fe_consts(p, p.T / (float)N, 1.0f);
  const int64_t i = (int64_t)blockIdx.x * kPathThreads + threadIdx.x;
  float payoff = 0.0f;
  if (i < n) {
    const int64_t m = (int64_t)blockIdx.y * n + i;
    const float* a = dW1 + m;
    const float* b = dW2 + m;
    float S = p.S_0;
    float v = p.v_0;
#pragma unroll 4
    for (int t = 0; t < N; ++t) {
      nmch::fe_step(S, v, __ldg(a), __ldg(b), c);
      a += M;
      b += M;
    }
    payoff = fmaxf(S - p.S_0, 0.0f);
  }
  nmch::block_sum_to_partials(payoff,
                              partials + 2 * (int64_t)gridDim.x * blockIdx.y);
}

}  // namespace

// Per-replicate (sum payoff, sum payoff^2) of the M = n_shifts * n paths
// driven by dW1, dW2 (float32 (N, M) row-major, device) into out[2r],
// out[2r + 1] (float64, device). partials: float64[2 * n_shifts *
// ceil(n / 128)] scratch on the device. Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launches (0 on success);
// nothing is launched for invalid arguments.
extern "C" int nmch_qmc_payoff_sums(float T, float S_0, float v_0, float r,
                                    float k, float rho, float theta,
                                    float sigma, const float* dW1,
                                    const float* dW2, int64_t N, int64_t M,
                                    int64_t n_shifts, double* partials,
                                    double* out, void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_shifts < 1 ||
      n_shifts > kMaxShifts || M < n_shifts || M % n_shifts != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = M / n_shifts;
  const int64_t n_blocks = (n + kPathThreads - 1) / kPathThreads;
  if (n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const nmch::FeParams p{T, S_0, v_0, r, k, rho, theta, sigma};
  const dim3 grid((unsigned)n_blocks, (unsigned)n_shifts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qmc_sim_paths<<<grid, kPathThreads, 0, st>>>(p, dW1, dW2, (int)N, M, n,
                                               partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // n_paths = 1: the second pass writes the sums themselves
  return (int)nmch::launch_sum_partials(partials, n_blocks, 1, out, st,
                                        n_shifts);
}
