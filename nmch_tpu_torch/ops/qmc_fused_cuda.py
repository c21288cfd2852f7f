"""The fused QMC bridge + simulator through the hand-written CUDA kernel
``csrc/qmc_fused.cu``.

The counterpart of ``benchmarks/qmc_fused_probe.py``'s
``qmc_payoff_sums_fused`` (kernel K9) and ``qmc_payoff_sums_fused_hilo``
(kernel K10) in one function: ``precision`` "HIGHEST" is K9's float32
product, "HIGH" K10's three bf16 hi/lo products, "DEFAULT" one bf16
product.  Each point's thread makes its increments from its own column
of the normals and steps them at once, so no increment reaches device
memory.  On a CUDA tensor the wrapper launches the kernel (then one
block per replicate that sums the per-block partials) or raises; on a
CPU tensor it runs the plain version,
``ops/fe_qmc.py::qmc_payoff_sums_fused_plain``, which computes the same
increments and payoffs operation for operation.
"""

from __future__ import annotations

import torch

from .fe import LANES
from .fe_cuda import call_kernel, count_launch
from .fe_qmc import PRECISIONS, check_fused, fused_operands, \
    qmc_payoff_sums_fused_plain

# the kernels-line names of the three precisions
KERNEL_NAMES = {"HIGHEST": "qmc_fused", "HIGH": "qmc_fused_hilo",
                "DEFAULT": "qmc_fused_bf16"}


def qmc_payoff_sums_fused_cuda(params, z1, z2, A_scaled, n_shifts: int, *,
                               precision: str = "HIGHEST"):
    """Per-replicate (sum payoff, sum payoff^2), float64 (n_shifts,)
    tensors on the normals' device.

    params: float32 (8,) on the CPU, (T, S_0, v_0, r, k, rho, theta,
    sigma); z1, z2: float32 (N, M) contiguous bridge-ordered unit normals
    (``qmc_normals_mxu``), M a multiple of 1024 * n_shifts; A_scaled:
    float32 (N, N) contiguous, sqrt(dt) * ``bb_increment_matrix(N)``, on
    the same device.  Each launch adds one to
    ``qmc_payoff_sums_fused_cuda.launches`` and to
    ``variant_launches[KERNEL_NAMES[precision]]``."""
    N, M = check_fused(params, z1, z2, A_scaled, n_shifts, precision)
    device = z1.device
    if device.type == "cpu":
        return qmc_payoff_sums_fused_plain(params, z1, z2, A_scaled,
                                           n_shifts, precision=precision)
    if device.type != "cuda":
        raise ValueError(f"device {device} is neither cpu nor cuda")
    ops = [op.contiguous() for op in fused_operands(A_scaled, precision)]
    a_lo = ops[1] if len(ops) > 1 else ops[0]
    n_blocks = M // n_shifts // LANES
    partials = torch.empty(2 * n_shifts * n_blocks, dtype=torch.float64,
                           device=device)
    out = torch.empty(n_shifts, 2, dtype=torch.float64, device=device)
    name = KERNEL_NAMES[precision]
    call_kernel("nmch_qmc_fused_sums", name, device, *params.tolist(),
                z1.data_ptr(), z2.data_ptr(), ops[0].data_ptr(),
                a_lo.data_ptr(), N, M, n_shifts, PRECISIONS.index(precision),
                partials.data_ptr(), out.data_ptr())
    count_launch(qmc_payoff_sums_fused_cuda, name)
    return out[:, 0], out[:, 1]


qmc_payoff_sums_fused_cuda.launches = 0
qmc_payoff_sums_fused_cuda.variant_launches = {}
