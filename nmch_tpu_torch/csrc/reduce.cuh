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
// K2 (em.cu) sums two counts of its work beside the payoffs in the same
// passes (block_sums_to_partials<4>, sum_counted_partials): integers, exact
// in float64 below 2^53.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nmch {
namespace {

constexpr int kPathThreads = 128;    // paths per block (n_paths % 128 == 0)
constexpr int kReduceThreads = 256;  // threads of each point's partials block

// Called by all kPathThreads threads of a block, each with its path's kW
// values; writes the block's sum of each, in a fixed tree, to
// partials[kW * blockIdx.x + j], j < kW (a sweep passes its point's row of
// partials).
template <int kW>
__device__ __forceinline__ void block_sums_to_partials(const double (&v)[kW],
                                                       double* partials) {
  __shared__ double sh[kW][kPathThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kW; ++j) sh[j][t] = v[j];
  __syncthreads();
#pragma unroll
  for (int s = kPathThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int j = 0; j < kW; ++j) sh[j][t] += sh[j][t + s];
    }
    __syncthreads();
  }
  if (t < kW) partials[kW * blockIdx.x + t] = sh[t][0];
}

// The (sum, sum_sq) partial of the paths' payoffs: partials[2 * blockIdx.x]
// and partials[2 * blockIdx.x + 1].
__device__ __forceinline__ void block_sum_to_partials(float payoff,
                                                      double* partials) {
  const double v[2] = {(double)payoff, (double)(payoff * payoff)};
  block_sums_to_partials<2>(v, partials);
}

// One point's n_blocks partials of kW values (the payoffs' sum and sum of
// squares, then kW - 2 counts) into out[0 .. kW): the first two divided by
// n_paths (the moments), the counts as they are.
template <int kW>
__device__ __forceinline__ void sum_point_partials(
    const double* __restrict__ partials, int64_t n_blocks, int64_t n_paths,
    double* __restrict__ out) {
  __shared__ double sh[kW][kReduceThreads];
  const int t = threadIdx.x;
  double s[kW] = {};
  for (int64_t i = t; i < n_blocks; i += kReduceThreads) {
#pragma unroll
    for (int j = 0; j < kW; ++j) s[j] += partials[kW * i + j];
  }
#pragma unroll
  for (int j = 0; j < kW; ++j) sh[j][t] = s[j];
  __syncthreads();
#pragma unroll
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int j = 0; j < kW; ++j) sh[j][t] += sh[j][t + w];
    }
    __syncthreads();
  }
  if (t < kW) out[t] = t < 2 ? sh[t][0] / (double)n_paths : sh[t][0];
}

// Block p sums the n_blocks partials of point p into out[2p], out[2p + 1].
__global__ void __launch_bounds__(kReduceThreads)
    sum_partials(const double* __restrict__ partials, int64_t n_blocks,
                 int64_t n_paths, double* __restrict__ out) {
  sum_point_partials<2>(partials + 2 * n_blocks * (int64_t)blockIdx.x,
                        n_blocks, n_paths, out + 2 * (int64_t)blockIdx.x);
}

// One point's partials of block_sums_to_partials<4> (K2's: the payoffs' two
// sums, then its two counts) into out[0..3].
__global__ void __launch_bounds__(kReduceThreads)
    sum_counted_partials(const double* __restrict__ partials,
                         int64_t n_blocks, int64_t n_paths,
                         double* __restrict__ out) {
  sum_point_partials<4>(partials, n_blocks, n_paths, out);
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

// Second pass of one point's 4-value partials on `st`; returns the launch's
// cudaError_t.
inline cudaError_t launch_sum_counted_partials(const double* partials,
                                               int64_t n_blocks,
                                               int64_t n_paths, double* out,
                                               cudaStream_t st) {
  sum_counted_partials<<<1, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                     n_paths, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nmch
