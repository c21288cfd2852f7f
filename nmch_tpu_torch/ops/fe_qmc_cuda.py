"""QMC path simulation through the hand-written CUDA kernel ``csrc/qmc.cu``.

The counterpart of ``nmch_tpu/ops/fe_qmc.py::qmc_payoff_sums_pallas``
(kernel K6): FE paths driven by precomputed Brownian increments, summed
per replicate.  On a CUDA tensor the wrapper launches the kernel (one
thread per path, then one block per replicate that sums the per-block
partials) or raises; on a CPU tensor it runs the plain version,
``ops/fe_qmc.py::qmc_payoff_sums_plain``, which computes the same
payoffs operation for operation.  Unlike the TPU kernel it takes any
number of paths per replicate (no 1024-path tiles).
"""

from __future__ import annotations

import torch

from .fe import LANES
from .fe_qmc import qmc_payoff_sums_plain
from .launch import call_kernel, check_device, check_params, count_launch, \
    scratch

_MAX_N = 1 << 30
_MAX_SHIFTS = 65535        # the kernel's gridDim.y


def _check(params, dW1, dW2, n_shifts):
    """Validate the wrapper's arguments; returns (device, N, M)."""
    check_params(params)
    for name, dW in (("dW1", dW1), ("dW2", dW2)):
        if not isinstance(dW, torch.Tensor) or dW.dtype != torch.float32 \
                or dW.dim() != 2:
            raise ValueError(f"{name} must be a float32 tensor of shape "
                             f"(N, M)")
        if not dW.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major (N, M))")
    if dW1.shape != dW2.shape or dW1.device != dW2.device:
        raise ValueError(f"dW1 {tuple(dW1.shape)} on {dW1.device} and dW2 "
                         f"{tuple(dW2.shape)} on {dW2.device} differ")
    device = check_device(dW1.device)
    N, M = dW1.shape
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"N={N} must be in [1, 2^30]")
    if not 1 <= int(n_shifts) <= _MAX_SHIFTS or M == 0 or M % n_shifts:
        raise ValueError(f"M={M} must be a positive multiple of n_shifts="
                         f"{n_shifts} (1 to {_MAX_SHIFTS})")
    return device, N, M


def qmc_payoff_sums_cuda(params, dW1, dW2, n_shifts: int):
    """Per-replicate (sum payoff, sum payoff^2), float64 (n_shifts,)
    tensors on the increments' device.

    params: float32 (8,) on the CPU, (T, S_0, v_0, r, k, rho, theta,
    sigma); dW1, dW2: float32 (N, M) contiguous Brownian increments
    (scaled by sqrt(dt)), path m of replicate m // (M / n_shifts).  Each
    launch adds one to ``qmc_payoff_sums_cuda.launches`` and to
    ``variant_launches["qmc_sim"]``."""
    device, N, M = _check(params, dW1, dW2, n_shifts)
    if device.type == "cpu":
        return qmc_payoff_sums_plain(params, dW1, dW2, n_shifts)
    n_blocks = -(-(M // n_shifts) // LANES)
    partials, out = scratch(device, 2 * n_shifts * n_blocks, (n_shifts, 2))
    call_kernel("nmch_qmc_payoff_sums", "qmc_sim", device, *params.tolist(),
                dW1.data_ptr(), dW2.data_ptr(), N, M, n_shifts,
                partials.data_ptr(), out.data_ptr())
    count_launch(qmc_payoff_sums_cuda, "qmc_sim")
    return out[:, 0], out[:, 1]


qmc_payoff_sums_cuda.launches = 0
qmc_payoff_sums_cuda.variant_launches = {}
