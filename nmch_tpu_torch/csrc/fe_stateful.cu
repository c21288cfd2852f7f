// Forward-Euler Heston paths from carried recurrence states on Hopper
// (sm_90a): the stateful curand families XORWOW and MRG32k3a, one thread per
// path, and the skip-ahead that places those states on the streams.
//
// Replaces nmch_tpu/ops/fe_stateful_pallas.py::_fe_stateful_kernel (K5, the
// kernel behind fe_moments_stateful_pallas, fe_stateful_pallas.py:248). A
// thread loads its path's 6 state words (XORWOW x, y, z, w, v, d; MRG32k3a
// s1 || s2) from the (6, n_paths) int64 state, runs N Euler steps with the
// state in registers (per counter block: 4 recurrence outputs, two
// Box-Muller pairs, steps 2j and 2j + 1, the second skipped when 2j + 1 >=
// N), writes the advanced state back, and its payoff goes into the
// deterministic two-pass float64 sum of reduce.cuh. The family is a template
// parameter (two kernels); parameters and N are runtime arguments.
//
// The jumps that nmch_tpu runs as plain XLA (fe_stateful_pallas.py:130
// fe_stateful_state, :178 advance_state) run here as two small kernels on
// host-computed tables: stateful_init applies to each lane the jumps
// selected by the bits of path * 2^67 + epoch * 2^40 (XORWOW: GF(2)^160
// matrices, XORed in where a state bit is set; MRG32k3a: 3x3 matrices mod
// m), those a warp shares once for the warp and the rest as one combined
// table per lane; stateful_advance one jump to every lane (the carried
// state's ride to the next epoch's start). In torch eager they would be
// thousands of small launches per pricing run.
//
// What bounds K5 on an H100: instruction issue, as for fe.cu. Per counter
// block a path spends 4 recurrence steps (XORWOW: about 8 integer ops each;
// MRG32k3a: 4 modular products, each a 64-bit product and two folds, and 3
// modular differences), 4 uniforms, two logf and three IEEE square roots,
// about 70 FP32 operations of polynomials and steps. The state is 48 bytes
// per path in and out (96 as int64), negligible beside that. The design
// keeps the whole path in registers for all N steps and touches memory only
// for the state and the payoff. The jump kernels are bound by issue too:
// a GF(2)^160 mat-vec is a mask and five AND-XORs per input bit. XORWOW's
// advance looks four input bits up at once (one entry of 16 a nibble, from
// shared memory), and loads and stores its states while it builds those
// entries; init shares a warp's common jumps across its lanes (a lane forms
// one bit of each output word, a ballot gathers it) and reads each lane's
// combined table in lines that the warp's 32 loads fill.
//
// Numerics: built with -fmad=false, every float operation is the plain
// version's (nmch_tpu_torch/ops/fe_stateful.py::fe_moments_stateful_plain),
// in its order, with libdevice logf (torch's CUDA log) and IEEE sqrtf, so a
// path's payoff and advanced state are bitwise the plain version's. The
// modular products are exact, so any exact method gives nmch_tpu's words.

#include <cstdint>
#include <cuda_runtime.h>

#include "em_path.cuh"
#include "fe_path.cuh"
#include "reduce.cuh"

namespace {

using nmch::kPathThreads;

// the wrappers' `rng` argument (ops/fe_stateful_cuda.py::FAMILIES)
enum StatefulRng { kXorwow = 0, kMrg32k3a = 1 };
constexpr int kStateWords = 6;
constexpr int kJumpMats = 58;     // jump exponent bits [40, 98)
constexpr int kEpochBits = 27;    // bits [40, 67): epoch; [67, 98): path
constexpr int kLaneBits = 5;      // path bits that differ within a warp

constexpr uint32_t kWeyl = 362437u;
constexpr uint32_t kC1 = 209u;    // m1 = 2^32 - 209
constexpr uint32_t kC2 = 22853u;  // m2 = 2^32 - 22853
constexpr uint32_t kA12 = 1403580u, kA13N = 810728u;
constexpr uint32_t kA21 = 527612u, kA23N = 1370589u;
constexpr float kTwoNeg23 = 0x1p-23f;
constexpr float kInvM1 = (float)(1.0 / 4294967087.0);  // float32(1 / m1)

// table words per jump: XORWOW (5 input words, 32 bits, 5 output words),
// MRG32k3a two 3x3 matrices
__host__ __device__ constexpr int table_words(int F) {
  return F == kXorwow ? 5 * 32 * 5 : 2 * 9;
}

// x mod (2^32 - C), any 64-bit x: 2^32 = C (mod 2^32 - C)
template <uint32_t C>
__device__ __forceinline__ uint32_t mod_fold(uint64_t x) {
  x = (x >> 32) * C + (x & 0xFFFFFFFFull);  // < (C + 1) 2^32
  x = (x >> 32) * C + (x & 0xFFFFFFFFull);  // < 2^32 + C^2
  constexpr uint64_t kM = (1ull << 32) - C;
  return (uint32_t)(x >= kM ? x - kM : x);
}

template <uint32_t C>
__device__ __forceinline__ uint32_t modmul(uint32_t a, uint32_t b) {
  return mod_fold<C>((uint64_t)a * b);
}

// (a - b) mod m for a, b < m: a u32 wrap adds 2^32 = m + C
template <uint32_t C>
__device__ __forceinline__ uint32_t modsub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a - b - C;
}

// one recurrence step on the state s[6], returning the output word
// (rng/xorwow.py::xorwow_step, rng/mrg32k3a.py::mrg_step)
template <int F>
__device__ __forceinline__ uint32_t next_word(uint32_t s[kStateWords]) {
  if constexpr (F == kXorwow) {
    const uint32_t t = s[0] ^ (s[0] >> 2);
    s[0] = s[1];
    s[1] = s[2];
    s[2] = s[3];
    s[3] = s[4];
    s[4] = (s[4] ^ (s[4] << 4)) ^ (t ^ (t << 1));
    s[5] += kWeyl;
    return s[4] + s[5];
  } else {
    const uint32_t x1 =
        modsub<kC1>(modmul<kC1>(kA12, s[1]), modmul<kC1>(kA13N, s[0]));
    const uint32_t x2 =
        modsub<kC2>(modmul<kC2>(kA21, s[5]), modmul<kC2>(kA23N, s[3]));
    s[0] = s[1];
    s[1] = s[2];
    s[2] = x1;
    s[3] = s[4];
    s[4] = s[5];
    s[5] = x2;
    return modsub<kC1>(x1, x2);
  }
}

// output word -> uniform in (0, 1): XORWOW ((o >> 9) + 0.5) 2^-23
// (rng/xorwow.py::u01_from_out), MRG32k3a (z + 0.5) / m1 with z rounded to
// nearest (rng/mrg32k3a.py::u01_from_z builds the same rounding from two
// 16-bit halves)
template <int F>
__device__ __forceinline__ float uniform(uint32_t o) {
  if constexpr (F == kXorwow) {
    return (__uint_as_float((o >> 9) | 0x4B000000u) - 8388608.0f + 0.5f) *
           kTwoNeg23;
  } else {
    return (__uint2float_rn(o) + 0.5f) * kInvM1;
  }
}

// K5: one FE path of the state in column blockIdx.x * 128 + threadIdx.x.
template <int F>
__global__ void __launch_bounds__(kPathThreads)
    fe_stateful_paths(nmch::FeParams p, int N, int64_t n_paths,
                      const int64_t* __restrict__ state_in,
                      int64_t* __restrict__ state_out,
                      double* __restrict__ partials) {
  const nmch::FeConsts c = nmch::fe_consts(p, N);
  const int64_t i = (int64_t)blockIdx.x * kPathThreads + threadIdx.x;
  uint32_t s[kStateWords];
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) {
    s[w] = (uint32_t)state_in[w * n_paths + i];
  }
  float S = p.S_0;
  float v = p.v_0;
  const uint32_t n = (uint32_t)N;
  const uint32_t n_blocks = (n + 1) / 2;
#pragma unroll 1
  for (uint32_t j = 0; j < n_blocks; ++j) {
    const uint32_t o0 = next_word<F>(s);
    const uint32_t o1 = next_word<F>(s);
    const uint32_t o2 = next_word<F>(s);
    const uint32_t o3 = next_word<F>(s);
    float g0, g1, g2, g3;
    nmch::boxmuller(uniform<F>(o0), uniform<F>(o1), g0, g1);
    nmch::boxmuller(uniform<F>(o2), uniform<F>(o3), g2, g3);
    nmch::fe_step(S, v, g0, g1, c);
    if (2 * j + 1 < n) nmch::fe_step(S, v, g2, g3, c);
  }
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) {
    state_out[w * n_paths + i] = (int64_t)s[w];
  }
  nmch::block_sum_to_partials(fmaxf(S - p.S_0, 0.0f), partials);
}

// s <- J s for one jump table (rng/xorwow.py / rng/mrg32k3a.py layouts),
// word k of the table at tab[k * kStride]: the single tables (kStride 1)
// and the init kernel's combined tables, interleaved over a warp's lanes
// (kStride 32: a warp's 32 loads of one word are one 128-byte line).
template <int F, int kStride = 1>
__device__ __forceinline__ void jump(uint32_t s[kStateWords],
                                     const uint32_t* __restrict__ tab) {
  if constexpr (F == kXorwow) {
    // XOR in the 5-word column of every set input bit; the Weyl word d is
    // left to the caller
    uint32_t acc[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int wi = 0; wi < 5; ++wi) {
      const uint32_t word = s[wi];
#pragma unroll 4
      for (int b = 0; b < 32; ++b) {
        const uint32_t mask = 0u - ((word >> b) & 1u);
        const uint32_t* col = tab + (wi * 32 + b) * 5 * kStride;
#pragma unroll
        for (int wo = 0; wo < 5; ++wo) {
          acc[wo] ^= mask & __ldg(col + wo * kStride);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < 5; ++w) s[w] = acc[w];
  } else {
    uint32_t t[kStateWords];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const uint32_t* a = tab + 3 * r * kStride;        // row r of J1
      const uint32_t* b = tab + (9 + 3 * r) * kStride;  // row r of J2
      t[r] = mod_fold<kC1>(
          (uint64_t)modmul<kC1>(__ldg(a), s[0]) +
          modmul<kC1>(__ldg(a + kStride), s[1]) +
          modmul<kC1>(__ldg(a + 2 * kStride), s[2]));
      t[3 + r] = mod_fold<kC2>(
          (uint64_t)modmul<kC2>(__ldg(b), s[3]) +
          modmul<kC2>(__ldg(b + kStride), s[4]) +
          modmul<kC2>(__ldg(b + 2 * kStride), s[5]));
    }
#pragma unroll
    for (int w = 0; w < kStateWords; ++w) s[w] = t[w];
  }
}

// XORWOW's jump by four input bits at a time (the method of four
// Russians): for each of the 40 nibbles of the 160-bit input, the XOR of
// the table's columns for each of its 16 values, built by a block in
// shared memory; a lane then XORs in one entry a nibble. nib: word wo of
// nibble g's entry for value v at (g * 16 + v) * 5 + wo (a warp's lanes
// read 16 entries at most, on 16 distinct banks).
constexpr int kNibbles = 160 / 4;
constexpr int kNibWords = kNibbles * 16 * 5;

__device__ __forceinline__ constexpr int lowest_bit(int v) {
  return (v & 1) ? 0 : (v & 2) ? 1 : (v & 4) ? 2 : 3;
}

__device__ __forceinline__ void build_nibbles(
    const uint32_t* __restrict__ tab, uint32_t* nib) {
  for (int p = threadIdx.x; p < kNibbles * 5; p += kPathThreads) {
    const int g = p / 5, wo = p % 5;
    uint32_t col[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) col[k] = __ldg(tab + (4 * g + k) * 5 + wo);
    uint32_t ent[16];
    ent[0] = 0u;
#pragma unroll
    for (int v = 1; v < 16; ++v) {
      ent[v] = ent[v & (v - 1)] ^ col[lowest_bit(v)];
    }
#pragma unroll
    for (int v = 0; v < 16; ++v) nib[(g * 16 + v) * 5 + wo] = ent[v];
  }
}

__device__ __forceinline__ void jump_nibbles(uint32_t s[kStateWords],
                                             const uint32_t* nib) {
  uint32_t acc[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int g = 0; g < kNibbles; ++g) {
    const uint32_t v = (s[g / 8] >> (4 * (g % 8))) & 15u;
    const uint32_t* e = nib + (g * 16 + v) * 5;
#pragma unroll
    for (int wo = 0; wo < 5; ++wo) acc[wo] ^= e[wo];
  }
#pragma unroll
  for (int w = 0; w < 5; ++w) s[w] = acc[w];
}

// XORWOW: s <- J s for a state s that every lane of the warp holds, the
// warp's lanes sharing the work: lane l forms output bit l of each output
// word, the parity of (row (wo, l) AND s), and a ballot gathers the word.
// rows: the table's rows, word wi of row (wo, l) at rows[(wo * 5 + wi) *
// 32 + l] (a warp's 32 loads are one line).
__device__ __forceinline__ void warp_jump_xorwow(
    uint32_t s[kStateWords], const uint32_t* __restrict__ rows,
    uint32_t lane) {
  uint32_t out[5];
#pragma unroll
  for (int wo = 0; wo < 5; ++wo) {
    uint32_t x = 0u;
#pragma unroll
    for (int wi = 0; wi < 5; ++wi) {
      x ^= __ldg(rows + (wo * 5 + wi) * 32 + lane) & s[wi];
    }
    out[wo] = __ballot_sync(0xFFFFFFFFu, __popc(x) & 1u);
  }
#pragma unroll
  for (int w = 0; w < 5; ++w) s[w] = out[w];
}

struct BaseState {
  uint32_t w[kStateWords];
};

// The states of paths 0..n_paths-1 at epoch `epoch` of the seed whose state
// is `base` (ops/fe_stateful.py::fe_stateful_state_split): table m, of the
// 58, is applied where bit m of (path << 27 | epoch) is set. The tables are
// powers of one transition, so they commute: a warp (32 paths, a multiple
// of 32 apart from path 0) first takes the jumps every lane shares, the
// epoch's bits and its paths' bits 5 and up, once; then each lane its
// combined table of path bits 0..4 (lane_tables, interleaved by lane).
// XORWOW takes the shared jumps on the warp's lanes together
// (warp_jump_xorwow, tables in row form); MRG32k3a's are 3x3 mat-vecs that
// each lane repeats. The Weyl word d is jump-invariant.
template <int F>
__global__ void __launch_bounds__(kPathThreads)
    stateful_init(const uint32_t* __restrict__ tables,
                  const uint32_t* __restrict__ lane_tables, BaseState base,
                  uint32_t epoch, int64_t n_paths,
                  int64_t* __restrict__ state_out) {
  const int64_t i = (int64_t)blockIdx.x * kPathThreads + threadIdx.x;
  const uint32_t lane = threadIdx.x & 31u;
  uint32_t s[kStateWords];
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) s[w] = base.w[w];
  // the shared jumps: set bits of the epoch, then of the warp's path bits
  uint32_t bits = epoch & ((1u << kEpochBits) - 1u);
  int m0 = 0;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (; bits != 0u; bits &= bits - 1u) {
      const int m = m0 + __ffs(bits) - 1;
      if constexpr (F == kXorwow) {
        warp_jump_xorwow(s, tables + m * table_words(F), lane);
      } else {
        jump<F>(s, tables + m * table_words(F));
      }
    }
    bits = (uint32_t)i >> kLaneBits;
    m0 = kEpochBits + kLaneBits;
  }
  jump<F, 32>(s, lane_tables + lane);
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) {
    state_out[w * n_paths + i] = (int64_t)s[w];
  }
}

// Every state moved by one jump (ops/fe_stateful.py::advance_state); XORWOW
// adds d_inc, the Weyl increment of the jump's steps, to d. XORWOW's jump
// runs on the block's nibble entries, built while the states load.
template <int F>
__global__ void __launch_bounds__(kPathThreads)
    stateful_advance(const uint32_t* __restrict__ table, uint32_t d_inc,
                     int64_t n_paths, const int64_t* __restrict__ state_in,
                     int64_t* __restrict__ state_out) {
  const int64_t i = (int64_t)blockIdx.x * kPathThreads + threadIdx.x;
  uint32_t s[kStateWords];
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) {
    s[w] = (uint32_t)state_in[w * n_paths + i];
  }
  if constexpr (F == kXorwow) {
    __shared__ uint32_t nib[kNibWords];
    build_nibbles(table, nib);
    __syncthreads();
    jump_nibbles(s, nib);
    s[5] += d_inc;
  } else {
    jump<F>(s, table);
  }
#pragma unroll
  for (int w = 0; w < kStateWords; ++w) {
    state_out[w * n_paths + i] = (int64_t)s[w];
  }
}

bool bad_paths(int64_t n_paths) {
  return n_paths < kPathThreads || n_paths % kPathThreads != 0 ||
         n_paths >= (int64_t(1) << 31);
}

}  // namespace

// (E[X], E[X^2]) of n_paths FE paths into out[0..1] (float64, device), and
// the advanced states into state_out. rng: 0 = xorwow, 1 = mrg32k3a.
// state_in, state_out: int64[6 * n_paths] on the device (word w of path i at
// w * n_paths + i, values below 2^32), distinct arrays. partials:
// float64[2 * n_paths / 128] scratch on the device. Launches on `stream` and
// does not synchronise. Returns the cudaError_t of the launches (0 on
// success); nothing is launched for invalid arguments.
extern "C" int nmch_fe_stateful_moments(float T, float S_0, float v_0,
                                        float r, float k, float rho,
                                        float theta, float sigma, int64_t N,
                                        int64_t n_paths, int rng,
                                        const int64_t* state_in,
                                        int64_t* state_out, double* partials,
                                        double* out, void* stream) {
  if (N < 1 || N > (int64_t(1) << 30) || bad_paths(n_paths) ||
      (rng != kXorwow && rng != kMrg32k3a) || state_in == state_out) {
    return (int)cudaErrorInvalidValue;
  }
  const nmch::FeParams p{T, S_0, v_0, r, k, rho, theta, sigma};
  const int64_t n_blocks = n_paths / kPathThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rng == kXorwow) {
    fe_stateful_paths<kXorwow><<<(unsigned)n_blocks, kPathThreads, 0, st>>>(
        p, (int)N, n_paths, state_in, state_out, partials);
  } else {
    fe_stateful_paths<kMrg32k3a><<<(unsigned)n_blocks, kPathThreads, 0, st>>>(
        p, (int)N, n_paths, state_in, state_out, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nmch::launch_sum_partials(partials, n_blocks, n_paths, out, st);
}

// States of paths 0..n_paths-1 at `epoch` into state_out (int64[6 *
// n_paths], device). tables: the 58 jump tables on the device (u32; XORWOW
// 58 x 800 words in row form, word wi of row (wo, l) at (wo * 5 + wi) * 32
// + l; MRG32k3a 58 x (J1, J2)); lane_tables: the 32 combined tables of path
// bits 0..4 (ops/fe_stateful.py::init_lane_tables), word k of lane l's at
// k * 32 + l; b0..b5 the seed's state words.
extern "C" int nmch_stateful_init(int rng, const uint32_t* tables,
                                  const uint32_t* lane_tables, uint32_t b0,
                                  uint32_t b1, uint32_t b2, uint32_t b3,
                                  uint32_t b4, uint32_t b5, uint32_t epoch,
                                  int64_t n_paths, int64_t* state_out,
                                  void* stream) {
  if (bad_paths(n_paths) || (rng != kXorwow && rng != kMrg32k3a) ||
      tables == nullptr || lane_tables == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const BaseState base{{b0, b1, b2, b3, b4, b5}};
  const unsigned n_blocks = (unsigned)(n_paths / kPathThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rng == kXorwow) {
    stateful_init<kXorwow><<<n_blocks, kPathThreads, 0, st>>>(
        tables, lane_tables, base, epoch, n_paths, state_out);
  } else {
    stateful_init<kMrg32k3a><<<n_blocks, kPathThreads, 0, st>>>(
        tables, lane_tables, base, epoch, n_paths, state_out);
  }
  return (int)cudaGetLastError();
}

// state_out = one jump of state_in (int64[6 * n_paths] each, device,
// distinct); table: one jump table on the device, d_inc XORWOW's Weyl
// increment (ignored for MRG32k3a).
extern "C" int nmch_stateful_advance(int rng, const uint32_t* table,
                                     uint32_t d_inc, int64_t n_paths,
                                     const int64_t* state_in,
                                     int64_t* state_out, void* stream) {
  if (bad_paths(n_paths) || (rng != kXorwow && rng != kMrg32k3a) ||
      state_in == state_out) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned n_blocks = (unsigned)(n_paths / kPathThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rng == kXorwow) {
    stateful_advance<kXorwow><<<n_blocks, kPathThreads, 0, st>>>(
        table, d_inc, n_paths, state_in, state_out);
  } else {
    stateful_advance<kMrg32k3a><<<n_blocks, kPathThreads, 0, st>>>(
        table, d_inc, n_paths, state_in, state_out);
  }
  return (int)cudaGetLastError();
}
