// The f32 tile-tree plus Kahan reduction of the reduction probe on Hopper
// (sm_90a), in one launch.
//
// Replaces benchmarks/reduction_bench.py::_red_kernel (K7, behind
// pallas_sum, reduction_bench.py:50): the sum of a float32 (rows, 128)
// array, rows a multiple of 512, as the f32 sum of each (512, 128) tile
// followed by a Kahan-compensated f32 sum of the tile sums in tile order
// (nmch_tpu/ops/fe_pallas.py::_kahan_add). The TPU ran the tiles in order
// on one core and carried (sum, compensation) in scalar memory across its
// sequential grid. Hopper's blocks run in any order, and the chain of
// 15,625 dependent Kahan steps (1.024B elements; four dependent FP32 adds
// each, ~16 cycles, ~0.13 ms in all) is serial, so the kernel runs the
// chain beside the tile pass instead of after it:
//   * producers: block b + 1 sums tile b (blocks are dispatched in
//     ascending order, so tiles start in tile order) and publishes the sum
//     with one 64-bit store into its slot: (1 << 32) | the sum's bits. The
//     value and its ready mark are one single-copy-atomic word, so no
//     fence and no second load is needed. Producers never wait.
//   * consumer, block 0: warp 1 polls a window of 256 slots (8 a lane,
//     relaxed 64-bit loads), takes the prefix of the window whose slots
//     carry the ready mark, copies those sums into a ring of 4,096
//     floats in shared memory in tile order and publishes the count; thread
//     0 runs the chain over the ring with _kahan_add's four f32 operations
//     as the sums arrive, and writes the result.
// The consumer only ever waits on blocks that never wait, so the kernel
// cannot deadlock whatever order the scheduler starts blocks in; the order
// of dispatch only decides how soon the chain can move. Under the tile
// pass's load, a memory round trip takes microseconds, so the stager takes
// up to 256 sums per round trip (about 12 tiles finish per microsecond at
// 1.024B elements) and the chain, ~8 ns a step, keeps pace: it ends a few
// microseconds after the last tile. No float is atomic or reordered.
//
// Ring back-pressure: the stager stops when the ring holds 4,096 sums the
// chain has not added, and the chain publishes its count only after a
// block fence, so the stager never overwrites a sum before it is read.
// The chain (~8 ns a step) outruns the tiles (~80 ns apart at 1.024B), so
// no check exercises a full ring: that path is argued, not tested.
//
// Reset: nmch_red_sum zeroes the call's slots with one cudaMemsetAsync on
// the call's stream before the launch (8 bytes a tile, 125 KB at 1.024B
// elements), so no slot holds a ready mark from an earlier call; a CUDA
// graph captures the memset with the kernel. The memset and its gap cost
// ~0.003 ms a call on an H100 at 102.4M elements; a generation number per
// call in persistent slots would save that, but a graph would replay one
// generation over slots that already carry it and add stale sums.
//
// The order inside a tile: thread t of the tile's 256 threads loads the
// tile's float4s t, t + 256, ..., t + 63 * 256 (each warp reads 512
// contiguous bytes per load, 16 loads in flight) and keeps one running f32
// sum per float4 lane in registers; its sum is (x + y) + (z + w); a warp
// folds its lanes with shuffle-down steps of 16, 8, 4, 2, 1, and warp 0
// folds the 8 warp sums by 4, 2, 1. It is f32 by design: this kernel is
// the reduction the probe measures, so it keeps the TPU's arithmetic, not
// reduce.cuh's float64 partials.
//
// Numerics: both orders are mirrored by nmch_tpu_torch/ops/reduction.py
// (tile_sums_plain, red_sum_plain), and nvcc does not reassociate float
// additions, so the kernel equals its plain version bitwise on any data.
//
// What bounds it on an H100: device memory. Each float is read once and
// added once (4 bytes per FP32 add), far below the card's 20 operations
// per byte, so the least time is the array's bytes over 3.35 TB/s (0.122
// ms at 102.4M elements, 1.223 ms at 1.024B). The tile pass reads each
// byte once with 16-byte coalesced loads; the serial chain hides behind
// it, and only the last tiles' share of it (a few microseconds) shows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileFloats = 512 * 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrides = kTileFloats / (4 * kThreads);   // 64 float4s
constexpr int64_t kMaxTiles = 0x7FFFFFFE;                 // gridDim.x - 1
constexpr int kBatch = 16;       // float4 loads a thread has in flight
constexpr int kStage = 8;        // slots a stager lane polls per round
constexpr int kRing = 4096;      // tile sums staged for the chain

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The tile's sum in the fixed order; valid in thread 0 (all threads call).
__device__ __forceinline__ float tile_sum(const float4* __restrict__ x,
                                          int64_t tile, float* warp_sums) {
  const float4* p = x + tile * (kTileFloats / 4) + threadIdx.x;
  float4 acc = __ldg(p);
  // loads in batches of kBatch, all in flight before their adds, which
  // take them in order
#pragma unroll
  for (int k0 = 1; k0 < kStrides; k0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < kStrides) v[u] = __ldg(p + (k0 + u) * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < kStrides) {
        acc.x = acc.x + v[u].x;
        acc.y = acc.y + v[u].y;
        acc.z = acc.z + v[u].z;
        acc.w = acc.w + v[u].w;
      }
    }
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(0xFFFFFFFFu, s, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  float w = 0.0f;
  if (warp == 0) {
    w = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      w = w + __shfl_down_sync(0xFFFFFFFFu, w, o);
    }
  }
  return w;
}

// Threads 0-63 of block 0: warp 1 stages the tile sums in tile order,
// thread 0 runs the Kahan chain over them.
__device__ void kahan_consumer(const unsigned long long* slots,
                               int64_t n_tiles, float* out) {
  __shared__ float ring[kRing];
  __shared__ volatile int64_t staged;     // sums in the ring so far
  __shared__ volatile int64_t consumed;   // sums the chain has added
  if (threadIdx.x == 0) {
    staged = 0;
    consumed = 0;
  }
  asm volatile("bar.sync 1, 64;" ::: "memory");
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) {
    int64_t c0 = 0;
    while (c0 < n_tiles) {
      unsigned long long w[kStage];   // all in flight at once
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int64_t t = c0 + 32 * k + lane;
        w[k] = t < n_tiles ? load_relaxed(slots + t) : 0;
      }
      float v[kStage];
      unsigned ready[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        v[k] = __uint_as_float((unsigned)w[k]);
        ready[k] = __ballot_sync(0xFFFFFFFFu, (w[k] >> 32) != 0);
      }
      // the window's ready prefix, as far as the ring has room
      int count = 0;
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        if (count == 32 * k) {
          count += ready[k] == 0xFFFFFFFFu ? 32 : __ffs(~ready[k]) - 1;
        }
      }
      const int64_t room = kRing - (c0 - consumed);
      if (count > room) count = (int)room;
      if (count == 0) continue;
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        if (32 * k + lane < count) {
          ring[(c0 + 32 * k + lane) & (kRing - 1)] = v[k];
        }
      }
      __syncwarp();
      c0 += count;
      if (lane == 0) {
        __threadfence_block();
        staged = c0;
      }
    }
  } else if (threadIdx.x == 0) {
    float acc = 0.0f;
    float comp = 0.0f;
    int64_t i = 0;
    while (i < n_tiles) {
      const int64_t avail = staged;
      __threadfence_block();
#pragma unroll 8
      for (; i < avail; ++i) {
        const float s = ring[i & (kRing - 1)];
        const float y = s - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
      }
      __threadfence_block();   // the ring's reads before the count
      consumed = i;
    }
    *out = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    red_sum_kernel(const float4* __restrict__ x, int64_t n_tiles,
                   unsigned long long* __restrict__ slots,
                   float* __restrict__ out) {
  if (blockIdx.x == 0) {
    if (threadIdx.x < 64) kahan_consumer(slots, n_tiles, out);
    return;
  }
  __shared__ float warp_sums[kWarps];
  const int64_t t = blockIdx.x - 1;
  const float w = tile_sum(x, t, warp_sums);
  if (threadIdx.x == 0) {
    store_relaxed(slots + t, (1ull << 32) | __float_as_uint(w));
  }
}

}  // namespace

// The float32 sum of x (float32 (n_tiles * 512, 128) row-major, device,
// 16-byte aligned) into *out (device). slots: int64[n_tiles] of scratch on
// the device, which the call zeroes. Enqueues one memset and one kernel on
// `stream` and does not synchronise. Returns the cudaError_t of the
// enqueue (0 on success); nothing is enqueued for invalid arguments.
extern "C" int nmch_red_sum(const float* x, int64_t n_tiles, int64_t* slots,
                            float* out, void* stream) {
  if (n_tiles < 1 || n_tiles > kMaxTiles ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(slots, 0, n_tiles * sizeof(int64_t), st);
  if (err != cudaSuccess) return (int)err;
  red_sum_kernel<<<(unsigned)(n_tiles + 1), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(x), n_tiles,
      reinterpret_cast<unsigned long long*>(slots), out);
  return (int)cudaGetLastError();
}
