"""The reduction probe's sum through the hand-written CUDA kernel
``csrc/reduction.cu``.

The counterpart of ``benchmarks/reduction_bench.py::pallas_sum`` (kernel
K7): the float32 sum of a (rows, 128) array as per-tile tree sums and a
Kahan sum across the tiles.  On a CUDA tensor the wrapper launches the
kernel (one memset of the tiles' ready slots, then one launch: a block
per (512, 128) tile, while one block adds the finished tile sums in tile
order) or raises; on a CPU tensor it runs the plain version,
``ops/reduction.py::red_sum_plain``, whose order is the kernel's.
"""

from __future__ import annotations

import torch

from .launch import call_kernel, check_device, count_launch
from .reduction import check_rows, red_sum_plain


def red_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """float32 0-dim sum of x on x's device.

    x: float32 (rows, 128) contiguous, rows a positive multiple of 512.
    Each launch adds one to ``red_sum_cuda.launches`` and to
    ``variant_launches["red_sum"]``."""
    n_tiles = check_rows(x)
    if check_device(x.device).type == "cpu":
        return red_sum_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads "
                         "float4s)")
    slots = torch.empty(n_tiles, dtype=torch.int64, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    call_kernel("nmch_red_sum", "red_sum", x.device, x.data_ptr(), n_tiles,
                slots.data_ptr(), out.data_ptr())
    count_launch(red_sum_cuda, "red_sum")
    return out


red_sum_cuda.launches = 0
red_sum_cuda.variant_launches = {}
