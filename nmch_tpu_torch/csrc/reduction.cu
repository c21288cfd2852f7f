// The f32 tile-tree plus Kahan reduction of the reduction probe on Hopper
// (sm_90a).
//
// Replaces benchmarks/reduction_bench.py::_red_kernel (K7, behind
// pallas_sum, reduction_bench.py:50): the sum of a float32 (rows, 128)
// array, rows a multiple of 512, as the f32 sum of each (512, 128) tile
// followed by a Kahan-compensated f32 sum of the tile sums in tile order
// (nmch_tpu/ops/fe_pallas.py::_kahan_add). The TPU ran the tiles in order
// on one core and carried (sum, compensation) in scalar memory across its
// sequential grid; Hopper's blocks run in any order, so the sum takes two
// passes:
//   1. red_tile_sums: one 256-thread block per tile. Thread t loads the
//      tile's float4s t, t + 256, ..., t + 63 * 256 (each warp reads 512
//      contiguous bytes per load) and keeps one running f32 sum per float4
//      lane in registers; its sum is (x + y) + (z + w); a warp folds its
//      lanes with shuffle-down steps of 16, 8, 4, 2, 1, and warp 0 folds
//      the 8 warp sums by 4, 2, 1. One f32 partial per tile.
//   2. red_kahan: one block stages the partials in shared memory, 8,192
//      at a time with coalesced loads, and its thread 0 adds them in tile
//      order with _kahan_add's four f32 operations. This is the one
//      sequential part: 15,625 dependent steps at 1.024B elements, each
//      four dependent FP32 adds (~16 cycles, ~0.13 ms in all); one thread
//      reading straight from device memory would wait on load latency
//      instead.
// It is f32 by design: this kernel is the reduction the probe measures, so
// it keeps the TPU's arithmetic, not reduce.cuh's float64 partials.
//
// Numerics: the order above is mirrored by nmch_tpu_torch/ops/
// reduction.py::tile_sums_plain, and nvcc does not reassociate float
// additions, so the kernel equals its plain version bitwise on any data.
//
// What bounds it on an H100: device memory. Each float is read once and
// added once (4 bytes per FP32 add), far below the card's 20 operations
// per byte, so the least time is the array's bytes over 3.35 TB/s (0.122
// ms at 102.4M elements, 1.223 ms at 1.024B). The design reads each byte
// once with 16-byte coalesced loads, 16 in flight per thread, keeps the
// sums in registers, and leaves one float per tile to the second pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileFloats = 512 * 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrides = kTileFloats / (4 * kThreads);   // 64 float4s
constexpr int64_t kMaxTiles = 0x7FFFFFFF;                 // gridDim.x
constexpr int kKahanThreads = 1024;   // threads that stage the partials
constexpr int kKahanChunk = 8192;     // partials staged at a time (32 KB)

__global__ void __launch_bounds__(kThreads)
    red_tile_sums(const float4* __restrict__ x, float* __restrict__ partials) {
  const float4* p = x + (int64_t)blockIdx.x * (kTileFloats / 4) + threadIdx.x;
  float4 acc = __ldg(p);
#pragma unroll 16
  for (int k = 1; k < kStrides; ++k) {
    const float4 v = __ldg(p + k * kThreads);
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(0xFFFFFFFFu, s, o);
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      w = w + __shfl_down_sync(0xFFFFFFFFu, w, o);
    }
    if (lane == 0) partials[blockIdx.x] = w;
  }
}

__global__ void __launch_bounds__(kKahanThreads)
    red_kahan(const float* __restrict__ partials, int64_t n_tiles,
              float* __restrict__ out) {
  __shared__ float chunk[kKahanChunk];
  float acc = 0.0f;
  float comp = 0.0f;
  for (int64_t c0 = 0; c0 < n_tiles; c0 += kKahanChunk) {
    const int cn =
        n_tiles - c0 < kKahanChunk ? (int)(n_tiles - c0) : kKahanChunk;
    __syncthreads();   // thread 0 is done with the previous chunk
    for (int i = threadIdx.x; i < cn; i += kKahanThreads) {
      chunk[i] = partials[c0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < cn; ++i) {
        const float y = chunk[i] - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
      }
    }
  }
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

// The float32 sum of x (float32 (n_tiles * 512, 128) row-major, device,
// 16-byte aligned) into *out (device). partials: float32[n_tiles] scratch
// on the device. Launches on `stream` and does not synchronise. Returns
// the cudaError_t of the launches (0 on success); nothing is launched for
// invalid arguments.
extern "C" int nmch_red_sum(const float* x, int64_t n_tiles, float* partials,
                            float* out, void* stream) {
  if (n_tiles < 1 || n_tiles > kMaxTiles ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  red_tile_sums<<<(unsigned)n_tiles, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(x), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  red_kahan<<<1, kKahanThreads, 0, st>>>(partials, n_tiles, out);
  return (int)cudaGetLastError();
}
