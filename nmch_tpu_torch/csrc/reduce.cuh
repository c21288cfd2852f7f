// Deterministic float64 sum of (payoff, payoff^2) over all paths, shared by
// the path kernels (fe.cu, em.cu, sweep.cu).
//
// Replaces the TPU kernels' compensated sum across the sequential grid
// (nmch_tpu/ops/fe_pallas.py::_kahan_add, sweep_pallas.py::_kahan_row_add).
// Hopper's blocks run in any order, so the sum is two passes in a fixed
// order, with no float atomics:
//   1. block_sum_to_partials: each 128-thread block sums its paths in a
//      shared-memory float64 tree and writes one (sum, sum_sq) partial;
//   2. sum_partials: one 256-thread block per point sums that point's
//      partials, thread t taking partials t, t + 256, ... in order, then a
//      fixed tree, and writes (sum / n_paths, sum_sq / n_paths).
// A sweep of P points keeps point p's partials at [p][block] and launches
// P blocks in the second pass; each point's sum is then the order of a
// single-point run, so equal inputs give bitwise-equal moments in both.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nmch {
namespace {

constexpr int kPathThreads = 128;    // paths per block (n_paths % 128 == 0)
constexpr int kReduceThreads = 256;  // threads of each point's partials block

// Called by all kPathThreads threads of a block, each with its path's payoff;
// writes partials[2 * blockIdx.x] and partials[2 * blockIdx.x + 1] (a sweep
// passes its point's row of partials).
__device__ __forceinline__ void block_sum_to_partials(float payoff,
                                                      double* partials) {
  __shared__ double sh_sum[kPathThreads];
  __shared__ double sh_sq[kPathThreads];
  const int t = threadIdx.x;
  sh_sum[t] = (double)payoff;
  sh_sq[t] = (double)(payoff * payoff);
  __syncthreads();
#pragma unroll
  for (int s = kPathThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sh_sum[t] += sh_sum[t + s];
      sh_sq[t] += sh_sq[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    partials[2 * blockIdx.x] = sh_sum[0];
    partials[2 * blockIdx.x + 1] = sh_sq[0];
  }
}

// Block p sums the n_blocks partials of point p into out[2p], out[2p + 1].
__global__ void __launch_bounds__(kReduceThreads)
    sum_partials(const double* __restrict__ partials, int64_t n_blocks,
                 int64_t n_paths, double* __restrict__ out) {
  partials += 2 * n_blocks * (int64_t)blockIdx.x;
  out += 2 * (int64_t)blockIdx.x;
  __shared__ double sh_sum[kReduceThreads];
  __shared__ double sh_sq[kReduceThreads];
  const int t = threadIdx.x;
  double s = 0.0, s2 = 0.0;
  for (int64_t i = t; i < n_blocks; i += kReduceThreads) {
    s += partials[2 * i];
    s2 += partials[2 * i + 1];
  }
  sh_sum[t] = s;
  sh_sq[t] = s2;
  __syncthreads();
#pragma unroll
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      sh_sum[t] += sh_sum[t + w];
      sh_sq[t] += sh_sq[t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = sh_sum[0] / (double)n_paths;
    out[1] = sh_sq[0] / (double)n_paths;
  }
}

// Second pass for n_points points on `st`; returns the launch's
// cudaError_t.
inline cudaError_t launch_sum_partials(const double* partials,
                                       int64_t n_blocks, int64_t n_paths,
                                       double* out, cudaStream_t st,
                                       int64_t n_points = 1) {
  sum_partials<<<(unsigned)n_points, kReduceThreads, 0, st>>>(
      partials, n_blocks, n_paths, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nmch
