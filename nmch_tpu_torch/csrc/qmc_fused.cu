// The QMC bridge product fused into the FE path simulator on Hopper
// (sm_90a): Brownian increments made from the bridge-ordered normals inside
// the kernel and stepped at once, so that no increment reaches device
// memory.
//
// Replaces benchmarks/qmc_fused_probe.py::_fused_kernel (K9, behind
// qmc_payoff_sums_fused, :160) and ::_fused_kernel_hilo (K10, behind
// qmc_payoff_sums_fused_hilo, :378). Inputs: the normals z1, z2, float32
// (N, M) row-major (point m of replicate m / (M / n_shifts)), and the
// bridge matrix sqrt(dt) A (N, N) as float32 operands a_hi (and a_lo).
// Increment t of a point is dW[t] = sum_j A[t, j] z[j], each product
// rounded and added in float32 in the order j = 0, 1, ..., N - 1, at one of
// three precisions (template parameter P):
//   * kHighest (K9 at HIGHEST): the float32 product of A and z;
//   * kHigh (K10, and K9 at HIGH): (hh + hl) + lh of the three products
//     Ahi zhi, Ahi zlo and Alo zhi, each accumulated on its own; hi/lo
//     are x rounded to bf16 and the residual rounded to bf16 (the wrapper
//     splits A, each thread splits its z), and a product of two bf16
//     values is exact in float32 (8-bit by 8-bit significands);
//   * kDefault (K9 at DEFAULT): one bf16 pass, Ahi zhi.
// Then each point runs fe_path.cuh::fe_step on (dW1[t], dW2[t]) with the
// constants at sqrt_dt = 1, as K6 does; the outputs are each replicate's
// (sum payoff, sum payoff^2), payoff = max(S_N - S_0, 0).
//
// Design: one thread per point keeps S and v in registers across all N
// steps. The time axis runs in tiles of R steps: the thread holds R
// increments of each factor (and of each product at kHigh) as register
// accumulators, walks the bridge nodes j = 0..N-1 reading its own column
// of z1 and z2 (a warp reads 32 neighbouring points of a row: one 128-byte
// line per factor), and takes the R rows of A from shared-memory tiles of
// 128 nodes that the block loads together (every thread reads the same
// A values, a broadcast of 16 bytes per load). After the tile's last node
// it steps its R increments at once. This is where the card differs from
// the TPU: the TPU kept a point tile's (N, 8, 128) normals, 4 MB in f32,
// resident in VMEM for all chunks; a block's share here is N x 128 floats
// of each factor, 1 MB at N = 1000, far over 228 KB of shared memory, so
// each tile of R steps re-reads the thread's column of z from L2 and device
// memory (N / R times in all).
//
// What bounds it on an H100: the float32 products, 2 N^2 M per factor (a
// multiply and an add each). -fmad=false keeps them two instructions (the
// plain version's roundings), so the least time is 4 N^2 M instructions
// over the FP32 issue rate (62.7 ms at 2^19 points x N = 1000 on a 1980
// MHz card; 31.4 ms if they were FMAs); kHigh does three products. The z
// re-reads, 8 N M (N / R) bytes, come second (39 ms at R = 32). A simple
// SIMT kernel: the bf16 passes on the tensor cores (mma/wgmma) are later
// work.
//
// Numerics: -fmad=false and IEEE sqrtf: every increment and payoff is
// bitwise the plain version's (nmch_tpu_torch/ops/fe_qmc.py::
// qmc_payoff_sums_fused_plain), and the sums differ from it only by the
// order of the float64 additions (reduce.cuh, as in qmc.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;

constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;
constexpr int kNodeTile = 128;               // bridge nodes per A tile
constexpr int64_t kMaxShifts = 65535;        // gridDim.y
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;   // gridDim.x

// time steps per register tile: kHigh keeps three accumulators a step
template <int P>
constexpr int kRows = P == kHigh ? 16 : 32;

// x rounded to the nearest bf16 (ties to even) and widened back to float32
// (exact): torch's float -> bfloat16 conversion, for finite x
__device__ __forceinline__ float bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

template <int P>
__global__ void __launch_bounds__(kPathThreads)
    qmc_fused_paths(nmch::FeParams p, const float* __restrict__ z1,
                    const float* __restrict__ z2,
                    const float* __restrict__ a_hi,
                    const float* __restrict__ a_lo, int N, int64_t M,
                    int64_t n, double* __restrict__ partials) {
  constexpr int R = kRows<P>;
  constexpr int kTerms = P == kHigh ? 3 : 1;
  constexpr int kStride = R + 4;   // padded, 16-byte aligned tile row
  __shared__ __align__(16) float sa_hi[kNodeTile * kStride];
  __shared__ __align__(16) float sa_lo[P == kHigh ? kNodeTile * kStride : 4];
  const nmch::FeConsts c = nmch::fe_consts(p, p.T / (float)N, 1.0f);
  const int64_t m =
      (int64_t)blockIdx.y * n + (int64_t)blockIdx.x * kPathThreads +
      threadIdx.x;
  float S = p.S_0;
  float v = p.v_0;
  for (int t0 = 0; t0 < N; t0 += R) {
    float acc1[kTerms][R];
    float acc2[kTerms][R];
#pragma unroll
    for (int q = 0; q < kTerms; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc1[q][r] = 0.0f;
        acc2[q][r] = 0.0f;
      }
    }
    for (int j0 = 0; j0 < N; j0 += kNodeTile) {
      const int jn = min(kNodeTile, N - j0);
      __syncthreads();   // the previous tile's readers are done
      for (int e = threadIdx.x; e < R * kNodeTile; e += kPathThreads) {
        const int r = e / kNodeTile;
        const int j = e % kNodeTile;
        const bool in = t0 + r < N && j < jn;
        const int64_t g = (int64_t)(t0 + r) * N + j0 + j;
        sa_hi[j * kStride + r] = in ? a_hi[g] : 0.0f;
        if constexpr (P == kHigh) {
          sa_lo[j * kStride + r] = in ? a_lo[g] : 0.0f;
        }
      }
      __syncthreads();
      const float* col1 = z1 + (int64_t)j0 * M + m;
      const float* col2 = z2 + (int64_t)j0 * M + m;
#pragma unroll 2
      for (int j = 0; j < jn; ++j) {
        const float x1 = __ldg(col1 + (int64_t)j * M);
        const float x2 = __ldg(col2 + (int64_t)j * M);
        const float h1 = P == kHighest ? x1 : bf16_rn(x1);
        const float h2 = P == kHighest ? x2 : bf16_rn(x2);
        const float l1 = P == kHigh ? bf16_rn(x1 - h1) : 0.0f;
        const float l2 = P == kHigh ? bf16_rn(x2 - h2) : 0.0f;
        const float4* ah = reinterpret_cast<const float4*>(sa_hi + j * kStride);
        const float4* al = reinterpret_cast<const float4*>(sa_lo + j * kStride);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 a4 = ah[q];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = 4 * q + u;
            acc1[0][r] = acc1[0][r] + a[u] * h1;
            acc2[0][r] = acc2[0][r] + a[u] * h2;
          }
          if constexpr (P == kHigh) {
            const float4 b4 = al[q];
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = 4 * q + u;
              acc1[1][r] = acc1[1][r] + a[u] * l1;
              acc2[1][r] = acc2[1][r] + a[u] * l2;
              acc1[2][r] = acc1[2][r] + b[u] * h1;
              acc2[2][r] = acc2[2][r] + b[u] * h2;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t0 + r < N) {
        float d1 = acc1[0][r];
        float d2 = acc2[0][r];
        if constexpr (P == kHigh) {
          d1 = (d1 + acc1[1][r]) + acc1[2][r];
          d2 = (d2 + acc2[1][r]) + acc2[2][r];
        }
        nmch::fe_step(S, v, d1, d2, c);
      }
    }
  }
  nmch::block_sum_to_partials(fmaxf(S - p.S_0, 0.0f),
                              partials + 2 * (int64_t)gridDim.x * blockIdx.y);
}

template <int P>
cudaError_t launch(const nmch::FeParams& p, const float* z1, const float* z2,
                   const float* a_hi, const float* a_lo, int N, int64_t M,
                   int64_t n, dim3 grid, double* partials, cudaStream_t st) {
  qmc_fused_paths<P><<<grid, kPathThreads, 0, st>>>(p, z1, z2, a_hi, a_lo, N,
                                                    M, n, partials);
  return cudaGetLastError();
}

}  // namespace

// Per-replicate (sum payoff, sum payoff^2) of the M = n_shifts * n points
// whose normals are z1, z2 (float32 (N, M) row-major, device; n a multiple
// of 128) into out[2r], out[2r + 1] (float64, device). a_hi, a_lo: float32
// (N, N) row-major on the device, the bridge matrix's operands (precision
// 0 = HIGHEST: a_hi = sqrt(dt) A, a_lo unused; 1 = HIGH: its bf16 hi and
// lo parts; 2 = DEFAULT: its bf16 hi part, a_lo unused). partials:
// float64[2 * n_shifts * n / 128] scratch on the device. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the
// launches (0 on success); nothing is launched for invalid arguments.
extern "C" int nmch_qmc_fused_sums(float T, float S_0, float v_0, float r,
                                   float k, float rho, float theta,
                                   float sigma, const float* z1,
                                   const float* z2, const float* a_hi,
                                   const float* a_lo, int64_t N, int64_t M,
                                   int64_t n_shifts, int precision,
                                   double* partials, double* out,
                                   void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_shifts < 1 ||
      n_shifts > kMaxShifts || M < n_shifts || M % n_shifts != 0 ||
      (M / n_shifts) % kPathThreads != 0 ||
      (precision == kHigh && a_lo == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = M / n_shifts;
  const int64_t n_blocks = n / kPathThreads;
  if (n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const nmch::FeParams p{T, S_0, v_0, r, k, rho, theta, sigma};
  const dim3 grid((unsigned)n_blocks, (unsigned)n_shifts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (precision) {
    case kHighest:
      err = launch<kHighest>(p, z1, z2, a_hi, a_lo, (int)N, M, n, grid,
                             partials, st);
      break;
    case kHigh:
      err = launch<kHigh>(p, z1, z2, a_hi, a_lo, (int)N, M, n, grid,
                          partials, st);
      break;
    case kDefault:
      err = launch<kDefault>(p, z1, z2, a_hi, a_lo, (int)N, M, n, grid,
                             partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  // n_paths = 1: the second pass writes the sums themselves
  return (int)nmch::launch_sum_partials(partials, n_blocks, 1, out, st,
                                        n_shifts);
}
