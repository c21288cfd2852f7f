// The QMC bridge product fused into the FE path simulator on Hopper
// (sm_90a): Brownian increments made from the bridge-ordered normals inside
// the kernel and stepped at once, so that no increment reaches device
// memory; each increment is summed over the bridge matrix's non-zeros only.
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
// The sparse walk. A bridge row has O(log N) non-zeros (10,976 of 10^6 at
// N = 1000: 10 or 11 a row), so the kernel takes a plan of A's non-zero
// pattern, built by the wrapper (ops/qmc_fused_cuda.py::fused_plan): the
// time axis in tiles of R rows, and for each tile the distinct columns its
// rows touch (at most kSlabCols; a row with more is cut into pieces of
// kSlabCols columns, at R = 1) and each row's non-zeros in ascending
// column order as (slot among the tile's columns, row, column). One thread
// per point keeps S and v in registers across all N steps. Per segment (a
// tile, or a piece of a long row), the block copies the segment's plan
// entries into shared memory with A's operand values gathered from a_hi
// and a_lo, and each thread loads its own point's z at the segment's
// columns once (a warp reads one 128-byte line per column and factor),
// splits them into bf16 hi/lo once where P needs it, and keeps them in a
// shared slab of (columns x 128 points), 8 bytes a column and point (at
// kHigh the two bf16 halves of each factor packed in one word). Then it
// walks the segment's rows: each row's non-zeros, one product per
// non-zero and operand pair, and fe_step when the row ends. The coarse
// bridge nodes recur in every tile and are read again from L2 (at N =
// 1000, R = 16: 1,623 column loads per point, 1.6x the normals).
//
// Why this is bitwise the dense order: a skipped node has A = 0 (and so
// a_hi = a_lo = 0), whose product with a finite z is +0 or -0. An
// accumulator starts at +0, and +0 + (+-0) = +0 under round-to-nearest; a
// non-zero x + (+-0) = x exactly; an exact cancellation gives +0, so an
// accumulator is never -0 and adding a signed zero never changes it.
// -fmad=false keeps every product and add its own rounding, so every
// increment and payoff is bitwise the plain version's (nmch_tpu_torch/
// ops/fe_qmc.py::qmc_payoff_sums_fused_plain, which keeps the dense loop),
// and the sums differ from it only by the order of the float64 additions
// (reduce.cuh, as in qmc.cu). Any A works: a dense one takes the same code
// at R = 1 with its rows in pieces, and is slow.
//
// What bounds it on an H100: z1 and z2 read once, 8 N M bytes over 3.35
// TB/s (1.253 ms at 2^19 points x N = 1000); the products on the non-zeros
// (4 nnz M thread instructions at HIGHEST, 12 nnz M at kHigh: 0.69 / 2.1
// ms at the FP32 issue rate) and fe_step's own (17 float and MUFU
// instructions a path-step, 0.27 ms) come under it. The walk itself issues
// about 10 instructions per non-zero and point (the entry and slab loads
// from shared memory, the products, the loop) and about 90 a row, so the
// kernel is issue-bound at a few times the bytes bound. A simple SIMT
// kernel; shared memory holds at most 32 KB of slab plus 16 KB of plan a
// block (32-34 KB for the bridge at N = 1000), so about six blocks of 128
// threads fit on an SM.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;

constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;
constexpr int kSlabCols = 32;                // columns a segment stages
constexpr int kMaxSegEntries = 32 * kSlabCols;   // R <= 32 rows of them
constexpr int64_t kMaxShifts = 65535;        // gridDim.y
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;   // gridDim.x

// a plan entry in shared memory: the slab offset of its column and A's
// operand(s) at it
struct __align__(8) Entry1 {
  int off;
  float a;
};
struct __align__(16) Entry2 {
  int off;
  float a;
  float b;
  int pad;
};
template <int P>
using EntryT = typename std::conditional<P == kHigh, Entry2, Entry1>::type;

// x rounded to the nearest bf16 (ties to even) and widened back to float32
// (exact): torch's float -> bfloat16 conversion, for finite x
__device__ __forceinline__ float bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// a point's normal at one column as the slab keeps it
template <int P>
__device__ __forceinline__ uint32_t slab_word(float x) {
  if (P == kHighest) return __float_as_uint(x);
  const float h = bf16_rn(x);
  if (P == kDefault) return __float_as_uint(h);
  return __float_as_uint(h) | (__float_as_uint(bf16_rn(x - h)) >> 16);
}

template <int P>
__global__ void __launch_bounds__(kPathThreads)
    qmc_fused_paths(nmch::FeParams p, const float* __restrict__ z1,
                    const float* __restrict__ z2,
                    const float* __restrict__ a_hi,
                    const float* __restrict__ a_lo, int N, int64_t M,
                    int64_t n, const int4* __restrict__ segs, int n_segs,
                    const int* __restrict__ cols,
                    const int* __restrict__ pieces,
                    const int4* __restrict__ entries, int slab_cols,
                    double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* slab = reinterpret_cast<uint2*>(smem);
  EntryT<P>* plan = reinterpret_cast<EntryT<P>*>(
      smem + sizeof(uint2) * kPathThreads * slab_cols);
  const uint2* mine = slab + threadIdx.x;
  const nmch::FeConsts c = nmch::fe_consts(p, p.T / (float)N, 1.0f);
  const int64_t m =
      (int64_t)blockIdx.y * n + (int64_t)blockIdx.x * kPathThreads +
      threadIdx.x;
  constexpr int kTerms = P == kHigh ? 3 : 1;
  float acc1[kTerms];
  float acc2[kTerms];
#pragma unroll
  for (int q = 0; q < kTerms; ++q) acc1[q] = acc2[q] = 0.0f;
  float S = p.S_0;
  float v = p.v_0;
  int64_t e0 = 0;   // the segment's first entry
  int pc = 0;       // the next piece (a row, or a piece of a long row)
  for (int s = 0; s < n_segs; ++s) {
    const int4 sg = __ldg(segs + s);   // col0, n_cols, n_entries, piece_end
    __syncthreads();   // the previous segment's plan has been walked
    for (int i = threadIdx.x; i < sg.z; i += kPathThreads) {
      const int4 en = __ldg(entries + e0 + i);   // slot, row, col, 0
      const int64_t g = (int64_t)en.y * N + en.z;
      EntryT<P> x;
      x.off = en.x * kPathThreads;
      x.a = __ldg(a_hi + g);
      if constexpr (P == kHigh) {
        x.b = __ldg(a_lo + g);
        x.pad = 0;
      }
      plan[i] = x;
    }
    e0 += sg.z;
    // this thread's slab column: only it reads it, so no barrier is needed
    // for the slab, only for the plan
#pragma unroll 8
    for (int k = 0; k < sg.y; ++k) {
      const int64_t col = __ldg(cols + sg.x + k);
      const float x1 = __ldg(z1 + col * M + m);
      const float x2 = __ldg(z2 + col * M + m);
      slab[k * kPathThreads + threadIdx.x] =
          make_uint2(slab_word<P>(x1), slab_word<P>(x2));
    }
    __syncthreads();
    int e = 0;
    for (; pc < sg.w; ++pc) {
      const int hdr = __ldg(pieces + pc);   // n_entries << 1 | ends_row
      const int cnt = hdr >> 1;
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const EntryT<P> en = plan[e + i];
        const uint2 w = mine[en.off];
        if constexpr (P == kHigh) {
          const float h1 = __uint_as_float(w.x & 0xFFFF0000u);
          const float l1 = __uint_as_float(w.x << 16);
          const float h2 = __uint_as_float(w.y & 0xFFFF0000u);
          const float l2 = __uint_as_float(w.y << 16);
          acc1[0] = acc1[0] + en.a * h1;
          acc2[0] = acc2[0] + en.a * h2;
          acc1[1] = acc1[1] + en.a * l1;
          acc2[1] = acc2[1] + en.a * l2;
          acc1[2] = acc1[2] + en.b * h1;
          acc2[2] = acc2[2] + en.b * h2;
        } else {
          acc1[0] = acc1[0] + en.a * __uint_as_float(w.x);
          acc2[0] = acc2[0] + en.a * __uint_as_float(w.y);
        }
      }
      e += cnt;
      if (hdr & 1) {
        float d1 = acc1[0];
        float d2 = acc2[0];
        if constexpr (P == kHigh) {
          d1 = (d1 + acc1[1]) + acc1[2];
          d2 = (d2 + acc2[1]) + acc2[2];
        }
        nmch::fe_step(S, v, d1, d2, c);
#pragma unroll
        for (int q = 0; q < kTerms; ++q) acc1[q] = acc2[q] = 0.0f;
      }
    }
  }
  nmch::block_sum_to_partials(fmaxf(S - p.S_0, 0.0f),
                              partials + 2 * (int64_t)gridDim.x * blockIdx.y);
}

template <int P>
cudaError_t launch(const nmch::FeParams& p, const float* z1, const float* z2,
                   const float* a_hi, const float* a_lo, int N, int64_t M,
                   int64_t n, const int* segs, int n_segs, const int* cols,
                   const int* pieces, const int* entries, int slab_cols,
                   int seg_entries, dim3 grid, double* partials,
                   cudaStream_t st) {
  const size_t smem = sizeof(uint2) * kPathThreads * slab_cols +
                      sizeof(EntryT<P>) * seg_entries;
  // the default allows 48 KB of static and dynamic shared memory together
  const cudaError_t err = cudaFuncSetAttribute(
      qmc_fused_paths<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  qmc_fused_paths<P><<<grid, kPathThreads, smem, st>>>(
      p, z1, z2, a_hi, a_lo, N, M, n, reinterpret_cast<const int4*>(segs),
      n_segs, cols, pieces, reinterpret_cast<const int4*>(entries), slab_cols,
      partials);
  return cudaGetLastError();
}

}  // namespace

// Per-replicate (sum payoff, sum payoff^2) of the M = n_shifts * n points
// whose normals are z1, z2 (float32 (N, M) row-major, device; n a multiple
// of 128) into out[2r], out[2r + 1] (float64, device). a_hi, a_lo: float32
// (N, N) row-major on the device, the bridge matrix's operands (precision
// 0 = HIGHEST: a_hi = sqrt(dt) A, a_lo unused; 1 = HIGH: its bf16 hi and
// lo parts; 2 = DEFAULT: its bf16 hi part, a_lo unused). partials:
// float64[2 * n_shifts * n / 128] scratch on the device. The plan of A's
// non-zeros (ops/qmc_fused_cuda.py::fused_plan), int32 on the device:
// segs (n_segs, 4) = (first column, columns, entries, end of its pieces),
// cols (the segments' columns), pieces (n_entries << 1 | ends_row, one a
// row or piece of a row, in row order), entries (., 4) = (slot, row,
// column, 0) in row order, columns ascending; slab_cols and seg_entries:
// the most columns and entries of a segment. Launches on `stream` and does
// not synchronise. Returns the cudaError_t of the launches (0 on success);
// nothing is launched for invalid arguments.
extern "C" int nmch_qmc_fused_sums(float T, float S_0, float v_0, float r,
                                   float k, float rho, float theta,
                                   float sigma, const float* z1,
                                   const float* z2, const float* a_hi,
                                   const float* a_lo, int64_t N, int64_t M,
                                   int64_t n_shifts, int precision,
                                   double* partials, double* out,
                                   const int* segs, int64_t n_segs,
                                   const int* cols, const int* pieces,
                                   const int* entries, int slab_cols,
                                   int seg_entries, void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || n_shifts < 1 ||
      n_shifts > kMaxShifts || M < n_shifts || M % n_shifts != 0 ||
      (M / n_shifts) % kPathThreads != 0 ||
      (precision == kHigh && a_lo == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (segs == nullptr || pieces == nullptr || n_segs < 1 ||
      n_segs > 0x7FFFFFFF || slab_cols < 0 || slab_cols > kSlabCols ||
      seg_entries < 0 || seg_entries > kMaxSegEntries) {
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
      err = launch<kHighest>(p, z1, z2, a_hi, a_lo, (int)N, M, n, segs,
                             (int)n_segs, cols, pieces, entries, slab_cols,
                             seg_entries, grid, partials, st);
      break;
    case kHigh:
      err = launch<kHigh>(p, z1, z2, a_hi, a_lo, (int)N, M, n, segs,
                          (int)n_segs, cols, pieces, entries, slab_cols,
                          seg_entries, grid, partials, st);
      break;
    case kDefault:
      err = launch<kDefault>(p, z1, z2, a_hi, a_lo, (int)N, M, n, segs,
                             (int)n_segs, cols, pieces, entries, slab_cols,
                             seg_entries, grid, partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  // n_paths = 1: the second pass writes the sums themselves
  return (int)nmch::launch_sum_partials(partials, n_blocks, 1, out, st,
                                        n_shifts);
}
