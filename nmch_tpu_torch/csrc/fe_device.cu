// K1 with the device generator (fe.cu's note): the counterpart of
// nmch_tpu/ops/fe_pallas.py::_fe_kernel with rng="tpu", whose hardware
// bitstream the card cannot reproduce. It draws the tagged Philox stream
// of rng/device.py instead: 4 words a counter block with box hc or turns,
// 3 with the packed hc16/hc16f (3 Philox calls feed 4 blocks), where at
// rot 8 each pair's radius-antithetic scale comes from its radius uniform
// (fe_pallas.py:143-168). All 4 boxes x 4 rots x fast_sqrt off/on: 32
// kernels, compiled here beside fe.cu's 24.

#include <cuda_runtime.h>

#include "fe_kernel.cuh"

namespace {

template <int Box>
cudaError_t launch_device_box(const nmch::FeLaunch& a) {
  if (a.fast_sqrt != 0) {
    return nmch::launch_fe_rot<nmch::kDevice, Box, true>(a);
  }
  return nmch::launch_fe_rot<nmch::kDevice, Box, false>(a);
}

}  // namespace

cudaError_t nmch::fe_launch_device(const nmch::FeLaunch& a) {
  switch (a.box) {
    case nmch::kHc: return launch_device_box<nmch::kHc>(a);
    case nmch::kTurns: return launch_device_box<nmch::kTurns>(a);
    case nmch::kHc16: return launch_device_box<nmch::kHc16>(a);
    case nmch::kHc16f: return launch_device_box<nmch::kHc16f>(a);
    default: return cudaErrorInvalidValue;
  }
}
