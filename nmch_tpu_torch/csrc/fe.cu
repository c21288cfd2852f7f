// Forward-Euler Heston paths on Hopper (sm_90a): counter-based draws
// (Philox4x32-10 or Threefry-4x32-12), half-circle Box-Muller normals and
// Euler steps, one thread per path (fe_path.cuh), followed by a
// deterministic two-pass float64 sum of payoff and payoff^2 (reduce.cuh).
//
// Replaces nmch_tpu/ops/fe_pallas.py::_fe_kernel with rng="philox" or
// "threefry4", rot=1, box="hc" (the kernel behind fe_moments_pallas,
// fe_pallas.py:317). The generator is a template parameter (two kernels);
// parameters, keys, the epoch and base_path are runtime arguments.
//
// What bounds it on an H100: the SMs' instruction issue. A path carries two
// floats of state (S, v) and a few loop-invariant constants, and touches
// memory only to write its payoff. Per counter block (two Euler steps) it
// spends one generator block (Philox: 10 rounds of two 32-bit wide
// multiplies; Threefry: 12 rounds of add/rotate/xor) and about 70 FP32
// operations of polynomials and steps plus three IEEE square roots.
// What the design does about it: one thread per path with everything in
// registers for all N steps, no shared or global memory inside the time
// loop, and the cross-path sum left to the end (reduce.cuh: a shared-memory
// tree per block, then one block over the per-block partials).
//
// Numerics: see fe_path.cuh. A path's payoff is bitwise the plain version's
// (nmch_tpu_torch/ops/fe.py); the moments differ from it only by the order
// of the float64 sums. No float atomics: the sums are in a fixed order, so
// equal arguments give bitwise-equal moments.

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;

template <int R>
__global__ void __launch_bounds__(kPathThreads)
    fe_paths(nmch::FeParams p, uint32_t k0, uint32_t k1, uint32_t epoch,
             uint32_t base_path, int N, double* __restrict__ partials) {
  const nmch::FeConsts c = nmch::fe_consts(p, N);
  const uint32_t path = base_path + blockIdx.x * kPathThreads + threadIdx.x;
  const float S = nmch::fe_path<R>(p, c, k0, k1, epoch, path, N);
  nmch::block_sum_to_partials(fmaxf(S - p.S_0, 0.0f), partials);
}

}  // namespace

// (E[X], E[X^2]) of n_paths FE paths into out[0..1] (float64, device).
// rng: 0 = philox, 1 = threefry4. partials: float64[2 * n_paths / 128]
// scratch on the device. Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launches (0 on success); nothing is
// launched for invalid arguments.
extern "C" int nmch_fe_moments(float T, float S_0, float v_0, float r,
                               float k, float rho, float theta, float sigma,
                               uint32_t k0, uint32_t k1, uint32_t epoch,
                               uint32_t base_path, int64_t N, int64_t n_paths,
                               int rng, double* partials, double* out,
                               void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_paths < kPathThreads ||
      n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32) ||
      (rng != nmch::kPhilox && rng != nmch::kThreefry4)) {
    return (int)cudaErrorInvalidValue;
  }
  const nmch::FeParams p{T, S_0, v_0, r, k, rho, theta, sigma};
  const int64_t n_blocks = n_paths / kPathThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rng == nmch::kPhilox) {
    fe_paths<nmch::kPhilox><<<(unsigned)n_blocks, kPathThreads, 0, st>>>(
        p, k0, k1, epoch, base_path, (int)N, partials);
  } else {
    fe_paths<nmch::kThreefry4><<<(unsigned)n_blocks, kPathThreads, 0, st>>>(
        p, k0, k1, epoch, base_path, (int)N, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out, st);
}

extern "C" const char* nmch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
