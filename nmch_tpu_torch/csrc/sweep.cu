// Parameter sweeps on Hopper (sm_90a): the FE and EM moments of P parameter
// points in one launch each, one thread per path.
//
// Replaces nmch_tpu/ops/sweep_pallas.py::_fe_sweep_kernel (K3, behind
// fe_sweep_pallas, sweep_pallas.py:187; its rng="tpu" branch as the device
// stream of rng/device.py, box hc) and ::_em_sweep_kernel (K4, behind
// em_sweep_pallas, :329). The TPU kernels put 128 points in the lanes and
// paths in the rows, which is what fills the TPU's vector unit. Here a
// thread is a path, as in fe.cu and em.cu: the grid is (n_paths / 128, P),
// a block holds 128 paths of one point (so no warp mixes two points'
// parameters or sampler regimes), blockIdx.y is the point, and point p runs
// at epoch epoch0 + p (a u32 add that wraps) with path ids 0..n_paths-1.
//
// Per-point inputs come from a small device table that each thread reads
// once at start: K3 the 8 parameters of its point (T, S_0, v_0, r, k, rho,
// theta, sigma), from which it computes the FE constants as fe.cu does; K4
// the 13 float32 loop constants of ops/em.py::em_consts_table. Then each
// thread runs the shared device path (fe_path.cuh, em_path.cuh).
//
// What bounds it on an H100: instruction issue, as for fe.cu and em.cu. A
// block of K4 runs its point on the schedule that em_path.cuh::
// em_rounds_pay picks on the host for the point's constants (em.cu's
// nmch_em_schedule, passed in `order`): the step loops where nearly every
// step takes the
// one-round normal branch, the round schedule where lanes leave it (small
// theta, or sigma^2 > 2 k theta, where the variance visits zero and the
// alpha < 1 Gamma boost). The launch lasts as long as its slowest blocks,
// and the sigma loop is outermost in grid order (explore.py::grid_points),
// which would put the heaviest points last: the grid's y index maps to a
// point through `order`, a permutation that the wrapper derives from the
// constant table (ops/sweep_cuda.py::em_point_order), heaviest point
// first, so that light points fill the launch's tail.
//
// Reduction: point p's blocks write their partials to row p (reduce.cuh),
// and the second pass runs one 256-thread block per point in the order of
// a single-point run. Point p of a sweep is therefore bitwise the moments
// of fe.cu / em.cu at epoch epoch0 + p and base_path 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "em_path.cuh"
#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::EmArgs;
using nmch::kPathThreads;

constexpr int kFeParams = 8;
constexpr int64_t kMaxPoints = 65535;  // gridDim.y

// K3: one FE path of point blockIdx.y.
template <int R>
__global__ void __launch_bounds__(kPathThreads)
    fe_sweep_paths(const float* __restrict__ params, uint32_t k0, uint32_t k1,
                   uint32_t epoch0, int N, double* __restrict__ partials) {
  const float* q = params + kFeParams * blockIdx.y;
  const nmch::FeParams p{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  const nmch::FeConsts c = nmch::fe_consts(p, N);
  const uint32_t path = blockIdx.x * kPathThreads + threadIdx.x;
  float S[1];
  nmch::fe_group_path<R, 1, nmch::kHc, false>(p, c, k0, k1,
                                              epoch0 + blockIdx.y, path, N, S);
  nmch::block_sum_to_partials(fmaxf(S[0] - p.S_0, 0.0f),
                              partials + 2 * (int64_t)gridDim.x * blockIdx.y);
}

// K4: one EM path of the point that order[blockIdx.y] names, on the
// schedule it names (2 p + 1: point p on the round schedule, 2 p: on the
// step loops).
template <int R, bool kConditional>
__global__ void __launch_bounds__(kPathThreads)
    em_sweep_paths(const float* __restrict__ consts,
                   const int32_t* __restrict__ order, uint32_t k0,
                   uint32_t k1, uint32_t epoch0, int N,
                   double* __restrict__ partials,
                   float* __restrict__ payoff_out,
                   uint32_t* __restrict__ ctr_out) {
  const uint32_t e = (uint32_t)__ldg(order + blockIdx.y);
  const uint32_t p = e >> 1;
  const float* c = consts + nmch::kEmConsts * p;
  const EmArgs a{c[0], c[1], c[2], c[3],  c[4],  c[5],  c[6],
                 c[7], c[8], c[9], c[10], c[11], c[12],
                 k0,   k1,   epoch0 + p, 0u, N};
  const uint32_t path = blockIdx.x * kPathThreads + threadIdx.x;
  uint32_t ctr;
  const float payoff =
      (e & 1u) ? nmch::em_path_rounds<R, kConditional>(a, path, ctr)
               : nmch::em_path_steps<R, kConditional>(a, path, ctr);
  if (payoff_out != nullptr) {
    const int64_t o = (int64_t)p * gridDim.x * kPathThreads + path;
    payoff_out[o] = payoff;
    ctr_out[o] = ctr;
  }
  nmch::block_sum_to_partials(payoff, partials + 2 * (int64_t)gridDim.x * p);
}

template <int R, bool kConditional>
cudaError_t launch_em_sweep(const float* consts, const int32_t* order,
                            uint32_t k0, uint32_t k1, uint32_t epoch0, int N,
                            dim3 grid, double* partials, float* payoff_out,
                            uint32_t* ctr_out, cudaStream_t st) {
  em_sweep_paths<R, kConditional><<<grid, kPathThreads, 0, st>>>(
      consts, order, k0, k1, epoch0, N, partials, payoff_out, ctr_out);
  return cudaGetLastError();
}

bool bad_sizes(int64_t n_points, int64_t N, int64_t n_paths) {
  return n_points < 1 || n_points > kMaxPoints || N < 1 ||
         N > (int64_t(1) << 30) || n_paths < kPathThreads ||
         n_paths % kPathThreads != 0 || n_paths > (int64_t(1) << 32);
}

template <int R>
void launch_fe_sweep(const float* params, uint32_t k0, uint32_t k1,
                     uint32_t epoch0, int N, dim3 grid, double* partials,
                     cudaStream_t st) {
  fe_sweep_paths<R><<<grid, kPathThreads, 0, st>>>(params, k0, k1, epoch0, N,
                                                   partials);
}

}  // namespace

// K3: (E[X], E[X^2]) of n_paths FE paths for each of n_points points into
// out[2p], out[2p + 1] (float64, device). params: float32[n_points * 8] on
// the device, row p = (T, S_0, v_0, r, k, rho, theta, sigma) of point p.
// rng: 0 = philox, 1 = threefry4, 3 = device (the tagged Philox stream,
// box hc, in place of the TPU kernel's hardware generator). partials:
// float64[2 * n_points * n_paths / 128] scratch on the device. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the
// launches (0 on success); nothing is launched for invalid arguments.
extern "C" int nmch_fe_sweep_moments(const float* params, int64_t n_points,
                                     uint32_t k0, uint32_t k1,
                                     uint32_t epoch0, int64_t N,
                                     int64_t n_paths, int rng,
                                     double* partials, double* out,
                                     void* stream) {
  if (bad_sizes(n_points, N, n_paths) ||
      (rng != nmch::kPhilox && rng != nmch::kThreefry4 &&
       rng != nmch::kDevice)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_blocks = n_paths / kPathThreads;
  const dim3 grid((unsigned)n_blocks, (unsigned)n_points);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rng == nmch::kPhilox) {
    launch_fe_sweep<nmch::kPhilox>(params, k0, k1, epoch0, (int)N, grid,
                                   partials, st);
  } else if (rng == nmch::kThreefry4) {
    launch_fe_sweep<nmch::kThreefry4>(params, k0, k1, epoch0, (int)N, grid,
                                      partials, st);
  } else {
    launch_fe_sweep<nmch::kDevice>(params, k0, k1, epoch0, (int)N, grid,
                                   partials, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out, st,
                                        n_points);
}

// K4: as K3 for the EM scheme. consts: float32[n_points * 13] on the
// device, row p = the loop constants of point p (ops/em.py::
// em_consts_table). order: int32[n_points] on the device, the points in
// the order their blocks are dispatched, each entry 2 p + s: point p (every
// point once) and its schedule s, 1 for the round schedule and 0 for the
// step loops (nmch_em_schedule's decision; the results do not depend on
// the order or the schedule). conditional: 0 or 1. payoff_out
// (float32[n_points * n_paths]) and ctr_out (uint32[n_points * n_paths])
// are both null or both device arrays that receive each path's payoff and
// final counter, point major.
extern "C" int nmch_em_sweep_moments(const float* consts,
                                     const int32_t* order, int64_t n_points,
                                     uint32_t k0, uint32_t k1,
                                     uint32_t epoch0, int64_t N,
                                     int64_t n_paths, int rng,
                                     int conditional, double* partials,
                                     double* out, float* payoff_out,
                                     uint32_t* ctr_out, void* stream) {
  if (bad_sizes(n_points, N, n_paths) || order == nullptr ||
      (rng != nmch::kPhilox && rng != nmch::kThreefry4) ||
      (conditional != 0 && conditional != 1) ||
      ((payoff_out == nullptr) != (ctr_out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_blocks = n_paths / kPathThreads;
  const dim3 grid((unsigned)n_blocks, (unsigned)n_points);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const float*, const int32_t*, uint32_t,
                                 uint32_t, uint32_t, int, dim3, double*,
                                 float*, uint32_t*, cudaStream_t);
  constexpr Launch kLaunch[2][2] = {
      {launch_em_sweep<nmch::kPhilox, false>,
       launch_em_sweep<nmch::kPhilox, true>},
      {launch_em_sweep<nmch::kThreefry4, false>,
       launch_em_sweep<nmch::kThreefry4, true>}};
  const cudaError_t err = kLaunch[rng][conditional](
      consts, order, k0, k1, epoch0, (int)N, grid, partials, payoff_out,
      ctr_out, st);
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out, st,
                                        n_points);
}
