// K1, the forward-Euler kernel: one thread per path group
// (fe_path.cuh::fe_group_path), the group mean payoff, then the
// deterministic two-pass float64 sum of payoff and payoff^2 (reduce.cuh).
// fe.cu instantiates it for the counter generators and holds the C entry
// point; fe_device.cu instantiates it for the device generator, in its own
// translation unit so that the two compile in parallel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace nmch {

// The arguments of one K1 launch, in plain types: fe.cu hands them to
// fe_device.cu's launcher.
struct FeLaunch {
  float params[8];  // (T, S_0, v_0, r, k, rho, theta, sigma)
  uint32_t k0, k1, epoch, base_path;
  int N, rot, box, fast_sqrt;
  int64_t n_blocks;  // n_paths / 128
  double* partials;
  cudaStream_t stream;
};

// K1 with the device generator for any box, rot and fast_sqrt
// (fe_device.cu); cudaErrorInvalidValue, launching nothing, for others.
cudaError_t fe_launch_device(const FeLaunch& a);

namespace {

template <int R, int Rot, int Box, bool FastSqrt>
__global__ void __launch_bounds__(kPathThreads)
    fe_paths(FeParams p, uint32_t k0, uint32_t k1, uint32_t epoch,
             uint32_t base_path, int N, double* __restrict__ partials) {
  const FeConsts c = fe_consts(p, N);
  const uint32_t path = base_path + blockIdx.x * kPathThreads + threadIdx.x;
  float S[Rot];
  fe_group_path<R, Rot, Box, FastSqrt>(p, c, k0, k1, epoch, path, N, S);
  // ops/fe.py::group_payoff: copies in order, then times 1/Rot (exact)
  float payoff = fmaxf(S[0] - p.S_0, 0.0f);
#pragma unroll
  for (int t = 1; t < Rot; ++t) payoff = payoff + fmaxf(S[t] - p.S_0, 0.0f);
  if (Rot > 1) payoff = payoff * (1.0f / Rot);
  block_sum_to_partials(payoff, partials);
}

template <int R, int Rot, int Box, bool FastSqrt>
cudaError_t launch_fe(const FeLaunch& a) {
  const float* q = a.params;
  const FeParams p{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  fe_paths<R, Rot, Box, FastSqrt>
      <<<(unsigned)a.n_blocks, kPathThreads, 0, a.stream>>>(
          p, a.k0, a.k1, a.epoch, a.base_path, a.N, a.partials);
  return cudaGetLastError();
}

template <int R, int Box, bool FastSqrt>
cudaError_t launch_fe_rot(const FeLaunch& a) {
  switch (a.rot) {
    case 1: return launch_fe<R, 1, Box, FastSqrt>(a);
    case 2: return launch_fe<R, 2, Box, FastSqrt>(a);
    case 4: return launch_fe<R, 4, Box, FastSqrt>(a);
    case 8: return launch_fe<R, 8, Box, FastSqrt>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace nmch
