"""FE moments through the hand-written CUDA kernel ``csrc/fe_philox.cu``.

The counterpart of ``nmch_tpu/ops/fe_pallas.py::fe_moments_pallas`` for
rng="philox", rot=1.  On a CUDA device the wrapper launches the kernel
(one thread per path, then one block that sums the per-block partials)
or raises; on the CPU it runs the plain version, ``ops/fe.py::
fe_moments_scan``, which computes the same payoffs operation for
operation.  Parameters and streams are runtime arguments, so a
parameter sweep never rebuilds the kernel.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .fe import LANES, fe_moments_scan, path_index_grid

_MAX_N = 1 << 30


def _u32(name: str, x) -> int:
    x = int(x)
    if not 0 <= x <= 0xFFFFFFFF:
        raise ValueError(f"{name}={x} is not a uint32")
    return x


def check_args(params, seed_words, epoch, base_path, N, n_paths, device):
    """Validate the arguments of a kernel wrapper; returns (device, N,
    n_paths, k0, k1, epoch, base_path), the integers as Python ints."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
    N, n_paths = int(N), int(n_paths)
    if not isinstance(params, torch.Tensor) or params.dtype != torch.float32 \
            or params.shape != (8,) or params.device.type != "cpu":
        raise ValueError("params must be a float32 tensor of shape (8,) on "
                         "the CPU")
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"N={N} must be in [1, 2^30]")
    if n_paths <= 0 or n_paths % LANES or n_paths > 1 << 32:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {LANES}, at most 2^32")
    k0, k1 = (_u32("seed word", w) for w in seed_words)
    return (device, N, n_paths, k0, k1, _u32("epoch", epoch),
            _u32("base_path", base_path))


def fe_moments_cuda(params, seed_words, epoch, base_path, *, N: int,
                    n_paths: int, device):
    """(E[X], E[X^2]) over n_paths FE paths, as float64 0-dim tensors on
    ``device``.

    params: float32 tensor (8,) on the CPU, (T, S_0, v_0, r, k, rho,
    theta, sigma); the kernel receives the values by argument.
    seed_words: the (k0, k1) u32 key pair; epoch and base_path: u32
    stream coordinates (path p draws from counter (j, epoch,
    base_path + p, 0)).  Each launch adds one to
    ``fe_moments_cuda.launches``."""
    device, N, n_paths, k0, k1, epoch, base_path = check_args(
        params, seed_words, epoch, base_path, N, n_paths, device)
    if device.type == "cpu":
        pidx = path_index_grid(n_paths, base_path, device)
        return fe_moments_scan(params, N, pidx, epoch, k0, k1)

    lib, _ = load_library()
    partials = torch.empty(2 * (n_paths // LANES), dtype=torch.float64,
                           device=device)
    out = torch.empty(2, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmch_fe_philox_moments(
            *params.tolist(), k0, k1, epoch, base_path, N, n_paths,
            partials.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        msg = lib.nmch_cuda_error_string(rc).decode()
        raise RuntimeError(f"fe_philox launch failed: CUDA error {rc} "
                           f"({msg})")
    fe_moments_cuda.launches += 1
    return out[0], out[1]


fe_moments_cuda.launches = 0
