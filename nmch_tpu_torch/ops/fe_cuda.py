"""FE moments through the hand-written CUDA kernel ``csrc/fe.cu``.

The counterpart of ``nmch_tpu/ops/fe_pallas.py::fe_moments_pallas`` for
rng="philox" or "threefry4", rot=1.  On a CUDA device the wrapper
launches the kernel (one thread per path, then one block that sums the
per-block partials) or raises; on the CPU it runs the plain version,
``ops/fe.py::fe_moments_scan``, which computes the same payoffs
operation for operation.  Parameters and streams are runtime arguments,
so a parameter sweep never rebuilds the kernel.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .fe import LANES, fe_moments_scan, path_index_grid

_MAX_N = 1 << 30
RNGS = ("philox", "threefry4")   # the kernels' `rng` argument is the index


def check_u32(name: str, x) -> int:
    x = int(x)
    if not 0 <= x <= 0xFFFFFFFF:
        raise ValueError(f"{name}={x} is not a uint32")
    return x


def check_rng(rng: str, kernel: str) -> None:
    """Refuse a generator the kernels do not take."""
    if rng == "tpu":
        raise ValueError(f"rng='tpu' is not ported yet: the device PRNG of "
                         f"the TPU kernels has no counterpart in {kernel} "
                         f"(ROADMAP.md Queue 1, slice 3, item 12)")
    if rng not in RNGS:
        raise ValueError(f"rng={rng!r}: the {kernel} kernel takes 'philox' "
                         f"or 'threefry4'")


def check_sizes(N, n_paths, device):
    """Validate a wrapper's device and sizes; returns (device, N, n_paths)
    with the integers as Python ints."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
    N, n_paths = int(N), int(n_paths)
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"N={N} must be in [1, 2^30]")
    if n_paths <= 0 or n_paths % LANES or n_paths > 1 << 32:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {LANES}, at most 2^32")
    return device, N, n_paths


def check_args(params, seed_words, epoch, base_path, N, n_paths, device):
    """Validate the arguments of a kernel wrapper; returns (device, N,
    n_paths, k0, k1, epoch, base_path), the integers as Python ints."""
    device, N, n_paths = check_sizes(N, n_paths, device)
    if not isinstance(params, torch.Tensor) or params.dtype != torch.float32 \
            or params.shape != (8,) or params.device.type != "cpu":
        raise ValueError("params must be a float32 tensor of shape (8,) on "
                         "the CPU")
    k0, k1 = (check_u32("seed word", w) for w in seed_words)
    return (device, N, n_paths, k0, k1, check_u32("epoch", epoch),
            check_u32("base_path", base_path))


def count_launch(fn, name: str) -> None:
    """Add one to a wrapper's ``launches`` and ``variant_launches[name]``."""
    fn.launches += 1
    fn.variant_launches[name] = fn.variant_launches.get(name, 0) + 1


def call_kernel(entry: str, name: str, device, *args) -> None:
    """Call the kernel library's C entry point ``entry`` with ``args`` and
    the device's current stream; raise if it returns a CUDA error."""
    lib, _ = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.nmch_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def fe_moments_cuda(params, seed_words, epoch, base_path, *, N: int,
                    n_paths: int, device, rng: str = "philox"):
    """(E[X], E[X^2]) over n_paths FE paths, as float64 0-dim tensors on
    ``device``.

    params: float32 tensor (8,) on the CPU, (T, S_0, v_0, r, k, rho,
    theta, sigma); the kernel receives the values by argument.
    seed_words: the (k0, k1) u32 key pair; epoch and base_path: u32
    stream coordinates (path p draws from counter (j, epoch,
    base_path + p, 0)); rng: "philox" or "threefry4".  Each launch adds
    one to ``fe_moments_cuda.launches`` and to
    ``fe_moments_cuda.variant_launches[f"fe_{rng}"]``."""
    device, N, n_paths, k0, k1, epoch, base_path = check_args(
        params, seed_words, epoch, base_path, N, n_paths, device)
    check_rng(rng, "FE")
    if device.type == "cpu":
        pidx = path_index_grid(n_paths, base_path, device)
        return fe_moments_scan(params, N, pidx, epoch, k0, k1, rng=rng)

    partials = torch.empty(2 * (n_paths // LANES), dtype=torch.float64,
                           device=device)
    out = torch.empty(2, dtype=torch.float64, device=device)
    call_kernel("nmch_fe_moments", f"fe_{rng}", device, *params.tolist(),
                k0, k1, epoch, base_path, N, n_paths, RNGS.index(rng),
                partials.data_ptr(), out.data_ptr())
    count_launch(fe_moments_cuda, f"fe_{rng}")
    return out[0], out[1]


fe_moments_cuda.launches = 0
fe_moments_cuda.variant_launches = {}
