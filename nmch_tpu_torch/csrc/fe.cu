// Forward-Euler Heston paths on Hopper (sm_90a): counter-based draws
// (Philox4x32-10, Threefry-2x32-20, Threefry-4x32-12, or the card's tagged
// Philox stream), Box-Muller normals and Euler steps, one thread per group
// of Rot coupled paths (fe_path.cuh), followed by a deterministic two-pass
// float64 sum of the group mean payoff and its square (reduce.cuh).
//
// Replaces nmch_tpu/ops/fe_pallas.py::_fe_kernel (the kernel behind
// fe_moments_pallas, fe_pallas.py:317) in every variant it takes: rng
// philox, threefry, threefry4 and, for the TPU's hardware generator, the
// device stream (rng/device.py); rot 1, 2, 4, 8; box hc and turns, and for
// the device stream also the packed hc16/hc16f and fast_sqrt. The
// generator, rot, box and fast_sqrt are template parameters, instantiated
// only for the combinations fe_moments_pallas accepts: 24 kernels for the
// counter generators here, 32 for the device stream in fe_device.cu.
// Parameters, keys, the epoch and base_path are runtime arguments.
//
// What bounds it on an H100: the SMs' instruction issue. A group carries
// 2 * Rot floats of state (S, v) and a few loop-invariant constants, and
// touches memory only to write its partial. Per counter block (two Euler
// steps) it spends one generator block (Philox: 10 rounds of two 32-bit
// wide multiplies; Threefry: 12 or 2 x 20 rounds of add/rotate/xor), the
// normals' polynomials, and per copy and step 7 FP32 operations and a
// square root; rot 8 adds a radius-antithetic scale (an exp and a log) per
// normal pair. What the design does about it: one thread per group with
// everything in registers for all N steps, the draw-dependent products of
// a step computed once per pair and shared by the copies, no shared or
// global memory inside the time loop, and the cross-group sum left to the
// end (reduce.cuh).
//
// Numerics: see fe_path.cuh. A group's payoff is bitwise the plain
// version's (nmch_tpu_torch/ops/fe.py::fe_moments_kernel_plain); the moments
// differ from it only by the order of the float64 sums. No float atomics:
// the sums are in a fixed order, so equal arguments give bitwise-equal
// moments.

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_kernel.cuh"

namespace {

using nmch::FeLaunch;
using nmch::kPathThreads;

// K1 for counter generator R: box hc or turns, IEEE sqrt.
template <int R>
cudaError_t launch_counter(const FeLaunch& a) {
  if (a.fast_sqrt != 0) return cudaErrorInvalidValue;
  if (a.box == nmch::kHc) return nmch::launch_fe_rot<R, nmch::kHc, false>(a);
  if (a.box == nmch::kTurns) {
    return nmch::launch_fe_rot<R, nmch::kTurns, false>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// (E[Y], E[Y^2]) of n_paths FE path groups into out[0..1] (float64,
// device). rng: 0 = philox, 1 = threefry4, 2 = threefry, 3 = device; rot:
// 1, 2, 4 or 8; box: 0 = hc, 1 = turns, 2 = hc16, 3 = hc16f (2 and 3, and
// fast_sqrt = 1, with rng 3 only). partials: float64[2 * n_paths / 128]
// scratch on the device. Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launches (0 on success); nothing is
// launched for invalid arguments.
extern "C" int nmch_fe_moments(float T, float S_0, float v_0, float r,
                               float k, float rho, float theta, float sigma,
                               uint32_t k0, uint32_t k1, uint32_t epoch,
                               uint32_t base_path, int64_t N, int64_t n_paths,
                               int rng, int rot, int box, int fast_sqrt,
                               double* partials, double* out, void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_paths < kPathThreads ||
      n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32) ||
      (fast_sqrt != 0 && fast_sqrt != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_blocks = n_paths / kPathThreads;
  const FeLaunch a{{T, S_0, v_0, r, k, rho, theta, sigma},
                   k0, k1, epoch, base_path, (int)N, rot, box, fast_sqrt,
                   n_blocks, partials, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (rng) {
    case nmch::kPhilox: err = launch_counter<nmch::kPhilox>(a); break;
    case nmch::kThreefry4: err = launch_counter<nmch::kThreefry4>(a); break;
    case nmch::kThreefry: err = launch_counter<nmch::kThreefry>(a); break;
    case nmch::kDevice: err = nmch::fe_launch_device(a); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out,
                                        a.stream);
}

extern "C" const char* nmch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
