// Broadie-Kaya exact-scheme (EM) Heston paths on Hopper (sm_90a): one thread
// per path runs N exact variance transitions (Poisson and Gamma rejection
// samplers on its own counter stream, em_path.cuh), draws or conditions the
// terminal price, and the payoffs go into the deterministic two-pass float64
// sum of reduce.cuh.
//
// Replaces nmch_tpu/ops/em_pallas.py::_em_kernel (the kernel behind
// em_moments_pallas, em_pallas.py:117), in each of its variants: rng philox
// or threefry4 and `conditional` off or on are template parameters (four
// kernels); poisson_cut, the parameters, the keys, the epoch and base_path
// are runtime arguments, so a sweep never rebuilds. The law build
// (em_law_paths, nmch_em_law) is the conditional kernel that also writes
// each path's (v_T, vI), for the pathwise EM Greeks (ops/em_greeks.py), the
// counterpart of the path law that nmch_tpu/ops/em_greeks.py takes from its
// scan engine; it is instantiated apart from the four, which keep their
// registers.
//
// What bounds it on an H100 depends on the launch's shape. At full load
// (the CLI's 2^18 paths, 2,048 blocks, 15.5 an SM) instruction issue: a
// step costs a Poisson draw (one round on the normal branch above the cut,
// a geometric number of PTRS rounds below it, Knuth rounds below lam = 10)
// and one or more Marsaglia-Tsang rounds; each round is a Philox (10
// rounds, 4 integer multiplies each) or Threefry (12 rounds of
// add/rotate/xor) block, a Box-Muller normal with a logf, and the
// acceptance test's logf/log1pf. A path's whole state (v, vI, counter,
// constants) stays in registers; the kernel touches memory only to write
// the payoff (and, on request, the per-path payoff and counter for
// checks). Where lanes of a warp leave the normal branch, the step loops
// wait for each sampler's slowest lane, once per Poisson regime present:
// em_path.cuh then runs the path on its round schedule (the phase with
// more lanes draws, each lane in its own stage and round), chosen per
// launch from the constants. What is left is the round loop's own cost
// (votes, stage tests, state carried across iterations: ~15% over the step
// loops at an equal schedule), the MT squeeze's two-logf fallback, which
// some lane of a warp needs in most MT rounds, and the lanes that wait for
// their phase.
//
// Under one wave (explore's loop mode: 5,120 paths, 40 blocks, one warp on
// each scheduler of 40 SMs) no warp hides another's latency, and a launch
// takes as long as one path's chain of dependent instructions, not its
// issue: ~0.80 ms on the step loops and ~1.97 ms on the round schedule for
// N = 1000 (explore's points, philox, H100 at 700 W). Each round's counter
// block sits at the head of that chain, ~20 dependent integer operations
// that the float math waits for; a build whose block was a short hash
// instead ran 12.4% faster there (16% on the step loops, 8% on the round
// schedule), which bounds what hiding the block can give. So em_paths
// draws through em_path.cuh's lookahead counter (AheadCounter), which
// starts each path's next block as it hands out the current one, beside
// that round's float math: the same bits, 7.7% less time on explore's
// launches (11.5% on the step loops, 3.0% on the round schedule, whose
// draws sit behind its stage branches) and 1-6% less at the CLI's 2^18
// paths, against the plain counter (uint32_t), which the law build, K4
// (sweep.cu) and K2-LRM (em_lrm.cu) keep.
//
// Numerics: see em_path.cuh. Built with -fmad=false, a path's counter and
// payoff equal the plain PyTorch version's (ops/em.py) on the card; the
// moments differ from it only by the order of the float64 sums.

#include <cstdint>
#include <cuda_runtime.h>

#include "em_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::EmArgs;
using nmch::kPathThreads;

// The round schedule's count of its warp's draws (em_path.cuh's Count): its
// loop's iterations, the same in every lane of the warp.
struct WarpDraws {
  int n = 0;
  __device__ __forceinline__ void iteration() { ++n; }
};

// kRounds: the round schedule, else the step loops (em_path.cuh); a kernel
// holds one of them, so that the step loops keep their own register count.
// Both draw through the lookahead counter (em_path.cuh's AheadCounter).
// Each block's partials are 4 values: the payoffs' sum and sum of squares,
// then its counts: the counter blocks its paths drew (their final counters,
// which start at 0) and, on the round schedule, the block draws its warps
// executed (lane 0's iterations); the step loops count no draws of their
// warps (em_path.cuh) and give NaN there.
template <int R, bool kConditional, bool kRounds>
__global__ void __launch_bounds__(kPathThreads)
    em_paths(EmArgs a, double* __restrict__ partials,
             float* __restrict__ payoff_out, uint32_t* __restrict__ ctr_out) {
  const uint32_t idx = blockIdx.x * kPathThreads + threadIdx.x;
  const uint32_t path = a.base_path + idx;
  uint32_t ctr;
  WarpDraws warp;
  const float payoff =
      kRounds ? nmch::em_path_rounds<R, kConditional, true>(
                    a, path, ctr, nmch::NoReport(), warp)
              : nmch::em_path_steps<R, kConditional, true>(a, path, ctr);
  if (payoff_out != nullptr) {
    payoff_out[idx] = payoff;
    ctr_out[idx] = ctr;
  }
  const double draws = !kRounds ? __longlong_as_double(0x7FF8000000000000LL)
                       : threadIdx.x % 32 == 0 ? (double)warp.n
                                               : 0.0;
  const double v[4] = {(double)payoff, (double)(payoff * payoff),
                       (double)ctr, draws};
  nmch::block_sums_to_partials<4>(v, partials);
}

template <int R, bool kConditional>
cudaError_t launch_em_paths(const EmArgs& a, int64_t n_blocks,
                            double* partials, float* payoff_out,
                            uint32_t* ctr_out, cudaStream_t st) {
  const unsigned g = (unsigned)n_blocks;
  if (nmch::em_rounds_pay(a)) {
    em_paths<R, kConditional, true><<<g, kPathThreads, 0, st>>>(
        a, partials, payoff_out, ctr_out);
  } else {
    em_paths<R, kConditional, false><<<g, kPathThreads, 0, st>>>(
        a, partials, payoff_out, ctr_out);
  }
  return cudaGetLastError();
}

// The law build: the conditional payoff into the sum, and each path's
// (v_T, vI) into law_out[idx] and law_out[n_paths + idx]. Its own
// instantiations, so that the builds above keep their registers.
template <int R, bool kRounds>
__global__ void __launch_bounds__(kPathThreads)
    em_law_paths(EmArgs a, double* __restrict__ partials,
                 float* __restrict__ law_out, int64_t n_paths) {
  const uint32_t idx = blockIdx.x * kPathThreads + threadIdx.x;
  const uint32_t path = a.base_path + idx;
  uint32_t ctr;
  nmch::LawReport law;
  const float payoff =
      kRounds ? nmch::em_path_rounds<R, true>(a, path, ctr, law)
              : nmch::em_path_steps<R, true>(a, path, ctr, law);
  law_out[idx] = law.v_T;
  law_out[n_paths + idx] = law.vI;
  nmch::block_sum_to_partials(payoff, partials);
}

template <int R>
cudaError_t launch_em_law(const EmArgs& a, int64_t n_paths, double* partials,
                          float* law_out, cudaStream_t st) {
  const unsigned g = (unsigned)(n_paths / kPathThreads);
  if (nmch::em_rounds_pay(a)) {
    em_law_paths<R, true><<<g, kPathThreads, 0, st>>>(a, partials, law_out,
                                                       n_paths);
  } else {
    em_law_paths<R, false><<<g, kPathThreads, 0, st>>>(a, partials, law_out,
                                                        n_paths);
  }
  return cudaGetLastError();
}

}  // namespace

// (E[X], E[X^2]) of n_paths EM paths into out[0..1], and the launch's
// counts into out[2..3]: the counter blocks the paths drew and the block
// draws their warps executed (float64, device; exact integers; the second
// NaN where the launch ran the step loops, which do not count it).
// consts: the 13 float32 values of ops/em.py::EmConsts, on the host.
// rng: 0 = philox, 1 = threefry4; conditional: 0 or 1.
// partials: float64[4 * n_paths / 128] scratch on the device. payoff_out
// (float32[n_paths]) and ctr_out (uint32[n_paths]) are both null or both
// device arrays that receive each path's payoff and final counter.
// Launches on `stream` and does not synchronise. Returns the cudaError_t of
// the launches (0 on success); nothing is launched for invalid arguments.
extern "C" int nmch_em_moments(const float* consts, uint32_t k0, uint32_t k1,
                               uint32_t epoch, uint32_t base_path, int64_t N,
                               int64_t n_paths, int rng, int conditional,
                               double* partials, double* out,
                               float* payoff_out, uint32_t* ctr_out,
                               void* stream) {
  if (nmch::em_bad_sizes(N, n_paths) ||
      (rng != nmch::kPhilox && rng != nmch::kThreefry4) ||
      (conditional != 0 && conditional != 1) ||
      ((payoff_out == nullptr) != (ctr_out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const EmArgs a = nmch::em_args(consts, k0, k1, epoch, base_path, N);
  const int64_t n_blocks = n_paths / kPathThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const EmArgs&, int64_t, double*, float*,
                                 uint32_t*, cudaStream_t);
  constexpr Launch kLaunch[2][2] = {
      {launch_em_paths<nmch::kPhilox, false>,
       launch_em_paths<nmch::kPhilox, true>},
      {launch_em_paths<nmch::kThreefry4, false>,
       launch_em_paths<nmch::kThreefry4, true>}};
  const cudaError_t err = kLaunch[rng][conditional](a, n_blocks, partials,
                                                    payoff_out, ctr_out, st);
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_counted_partials(partials, n_blocks, n_paths,
                                                out, st);
}

// The conditional moments of nmch_em_moments into out[0..1] (partials:
// float64[2 * n_paths / 128]; no counts), and each path's
// law, v_T into law_out[0 .. n_paths) and vI into law_out[n_paths .. 2 *
// n_paths) (float32, device): the values ops/em.py::path_law_from_consts
// returns, from the conditional build's schedule (em_rounds_pay). The
// pathwise Greeks (ops/em_greeks.py) differentiate the conditional payoff
// on them. Returns as nmch_em_moments.
extern "C" int nmch_em_law(const float* consts, uint32_t k0, uint32_t k1,
                           uint32_t epoch, uint32_t base_path, int64_t N,
                           int64_t n_paths, int rng, double* partials,
                           double* out, float* law_out, void* stream) {
  if (nmch::em_bad_sizes(N, n_paths) || law_out == nullptr ||
      (rng != nmch::kPhilox && rng != nmch::kThreefry4)) {
    return (int)cudaErrorInvalidValue;
  }
  const EmArgs a = nmch::em_args(consts, k0, k1, epoch, base_path, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rng == nmch::kPhilox
          ? launch_em_law<nmch::kPhilox>(a, n_paths, partials, law_out, st)
          : launch_em_law<nmch::kThreefry4>(a, n_paths, partials, law_out,
                                            st);
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_paths / kPathThreads,
                                        n_paths, out, st);
}

// The schedule em_path.cuh runs for each of n_points rows of loop constants
// (host memory, float32[n_points * 13], row p = the 13 constants of
// ops/em.py::em_consts_table) at N steps: out[p] = 1 for the round
// schedule, 0 for the step loops (em_rounds_pay, the decision
// nmch_em_moments takes for its own constants). K4's wrapper puts these in
// its dispatch table. Returns 0, or cudaErrorInvalidValue for invalid
// arguments.
extern "C" int nmch_em_schedule(const float* consts, int64_t n_points,
                                int64_t N, int32_t* out) {
  if (consts == nullptr || out == nullptr || n_points < 0 || N < 1 ||
      N > (int64_t(1) << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int64_t p = 0; p < n_points; ++p) {
    const EmArgs a =
        nmch::em_args(consts + nmch::kEmConsts * p, 0u, 0u, 0u, 0u, N);
    out[p] = nmch::em_rounds_pay(a) ? 1 : 0;
  }
  return 0;
}
