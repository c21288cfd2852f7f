// Counter-based generators of the port's streams, one 4-word block per
// call, bitwise nmch_tpu_torch/rng/philox.py, rng/threefry4.py,
// rng/threefry.py and rng/device.py (and so nmch_tpu's, apart from the
// device stream, which has no TPU counterpart): counter (block, epoch,
// path_lo, path_hi), key from the seed. The path kernels (fe_path.cuh,
// em_path.cuh) take the generator as a template parameter R, a CounterRng
// (also the C entry points' `rng`).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nmch {
namespace {

enum CounterRng { kPhilox = 0, kThreefry4 = 1, kThreefry = 2, kDevice = 3 };

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kThreefryParity = 0x1BD11BDAu;
// Threefry-2x32's derived keys: k0 ^ epoch * kGold, and k1 ^ kGold2
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kGold2 = 0xBB67AE85u;
// the device stream's path_hi word, "DPRG" (rng/device.py::TAG)
constexpr uint32_t kDeviceTag = 0x44505247u;

// Philox4x32-10: counter (c0..c3) in, 4 words out in place.
__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1,
                                              uint32_t& c2, uint32_t& c3,
                                              uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
}

// One Threefry-4x32 round: two mixes (rotations R0, R1) and the
// Threefish-256 permutation (swap x1 <-> x3).
template <int R0, int R1>
__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1,
                                               uint32_t& x2, uint32_t& x3) {
  x0 += x1;
  x1 = ((x1 << R0) | (x1 >> (32 - R0))) ^ x0;
  x2 += x3;
  x3 = ((x3 << R1) | (x3 >> (32 - R1))) ^ x2;
  const uint32_t t = x1;
  x1 = x3;
  x3 = t;
}

// Key injection s (after every fourth round): x_i += ks[(s + i) % 5],
// x3 += s.
template <int S>
__device__ __forceinline__ void threefry_inject(uint32_t& x0, uint32_t& x1,
                                                uint32_t& x2, uint32_t& x3,
                                                const uint32_t ks[5]) {
  x0 += ks[S % 5];
  x1 += ks[(S + 1) % 5];
  x2 += ks[(S + 2) % 5];
  x3 += ks[(S + 3) % 5] + (uint32_t)S;
}

// Threefry-4x32, 12 rounds, key (k0, k1, 0, 0): counter in, 4 words out in
// place (rotation table R_32x4 of Random123's threefry.h).
__device__ __forceinline__ void threefry4x32_12(uint32_t& x0, uint32_t& x1,
                                                uint32_t& x2, uint32_t& x3,
                                                uint32_t k0, uint32_t k1) {
  const uint32_t ks[5] = {k0, k1, 0u, 0u, k0 ^ k1 ^ kThreefryParity};
  x0 += ks[0];
  x1 += ks[1];
  x2 += ks[2];
  x3 += ks[3];
  threefry_round<10, 26>(x0, x1, x2, x3);
  threefry_round<11, 21>(x0, x1, x2, x3);
  threefry_round<13, 27>(x0, x1, x2, x3);
  threefry_round<23, 5>(x0, x1, x2, x3);
  threefry_inject<1>(x0, x1, x2, x3, ks);
  threefry_round<6, 20>(x0, x1, x2, x3);
  threefry_round<17, 11>(x0, x1, x2, x3);
  threefry_round<25, 10>(x0, x1, x2, x3);
  threefry_round<18, 20>(x0, x1, x2, x3);
  threefry_inject<2>(x0, x1, x2, x3, ks);
  threefry_round<10, 26>(x0, x1, x2, x3);
  threefry_round<11, 21>(x0, x1, x2, x3);
  threefry_round<13, 27>(x0, x1, x2, x3);
  threefry_round<23, 5>(x0, x1, x2, x3);
  threefry_inject<3>(x0, x1, x2, x3, ks);
}

// Four Threefry-2x32 rounds with rotations D0..D3: x0 += x1,
// x1 = rotl(x1, d) ^ x0.
template <int D0, int D1, int D2, int D3>
__device__ __forceinline__ void threefry2x32_mix4(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = ((x1 << D0) | (x1 >> (32 - D0))) ^ x0;
  x0 += x1;
  x1 = ((x1 << D1) | (x1 >> (32 - D1))) ^ x0;
  x0 += x1;
  x1 = ((x1 << D2) | (x1 >> (32 - D2))) ^ x0;
  x0 += x1;
  x1 = ((x1 << D3) | (x1 >> (32 - D3))) ^ x0;
}

// Threefry-2x32, 20 rounds, key (k0, k1): counter (x0, x1) in, 2 words out
// in place; key schedule ks = (k1, k0 ^ k1 ^ parity, k0), injection i
// adds ks[i % 3] and ks[(i + 1) % 3] + i + 1 (rng/threefry.py).
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t ks2 = k0 ^ k1 ^ kThreefryParity;
  x0 += k0;
  x1 += k1;
  threefry2x32_mix4<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += ks2 + 1u;
  threefry2x32_mix4<17, 29, 16, 24>(x0, x1);
  x0 += ks2;
  x1 += k0 + 2u;
  threefry2x32_mix4<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  threefry2x32_mix4<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += ks2 + 4u;
  threefry2x32_mix4<13, 15, 26, 6>(x0, x1);
  x0 += ks2;
  x1 += k0 + 5u;
}

// The block of generator R at counter (c0..c3) = (block, epoch, path_lo,
// path_hi), in place. Threefry-2x32 draws two 2-word calls at (block,
// path_lo) under the keys (k0 ^ epoch * kGold, k1) and (k0 ^ epoch *
// kGold, k1 ^ kGold2); the device stream is Philox at path_hi = "DPRG".
template <int R>
__device__ __forceinline__ void counter_block(uint32_t& c0, uint32_t& c1,
                                              uint32_t& c2, uint32_t& c3,
                                              uint32_t k0, uint32_t k1) {
  if (R == kPhilox) {
    philox4x32_10(c0, c1, c2, c3, k0, k1);
  } else if (R == kThreefry4) {
    threefry4x32_12(c0, c1, c2, c3, k0, k1);
  } else if (R == kThreefry) {
    const uint32_t ka = k0 ^ (c1 * kGold);
    uint32_t y0 = c0, y1 = c2;
    c1 = c2;
    threefry2x32_20(ka, k1, c0, c1);
    threefry2x32_20(ka, k1 ^ kGold2, y0, y1);
    c2 = y0;
    c3 = y1;
  } else {
    c3 = kDeviceTag;
    philox4x32_10(c0, c1, c2, c3, k0, k1);
  }
}

}  // namespace
}  // namespace nmch
