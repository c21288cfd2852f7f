"""FE pathwise Greeks through the hand-written CUDA kernel G1,
``csrc/fe_greeks.cu``.

G1 carries each path's tangents in forward mode through K1's time loop
(rng philox, threefry or threefry4; box hc; rot 1) and sums the payoff and
its 8 tangents in float64.  On a CUDA device the wrapper launches it (one
thread per path, then one block that sums the per-block partials) or
raises; on the CPU it runs the plain version,
``ops/fe_greeks.py::fe_greeks_plain``, which computes the same per-path
values operation for operation.  It stands in on the card for
``nmch_tpu/ops/greeks.py::fe_price_and_greeks`` (``jax.grad`` through the
scan); its reverse-mode counterpart here is ``ops/greeks.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .fe import LANES
from .fe_greeks import N_PARAMS, consts_jacobian, fe_greeks_plain
from .greeks import check_counter_rng
from .launch import RNGS, call_kernel, check_args, count_launch, scratch


def variant_name(rng: str) -> str:
    """The name under which a G1 build is counted and reported."""
    return f"fe_greeks_{rng}"


def fe_greeks_cuda(params, seed_words, epoch, base_path, *, N: int,
                   n_paths: int, device, rng: str = "philox",
                   fix_strike: bool = False, per_path: bool = False):
    """(price, grads): the mean payoff, a float64 0-dim tensor, and the
    means of its tangents in ``ops/greeks.py::PARAM_NAMES`` order, a
    float64 (8,) tensor, both on ``device``.

    params: float32 tensor (8,) on the CPU; the kernel receives its values
    and the constants' Jacobian (``consts_jacobian``) by argument.
    seed_words, epoch, base_path: as ``fe_moments_cuda``.  fix_strike
    freezes K = S_0 (the fixed-strike delta).  per_path=True also returns
    the float32 (9, n_paths) table of each path's payoff and tangents.
    Each launch adds one to ``fe_greeks_cuda.launches`` and to
    ``fe_greeks_cuda.variant_launches[variant_name(rng)]``."""
    device, N, n_paths, k0, k1, epoch, base_path = check_args(
        params, seed_words, epoch, base_path, N, n_paths, device)
    check_counter_rng(rng)
    if device.type == "cpu":
        return fe_greeks_plain(params, (k0, k1), epoch, base_path, N=N,
                               n_paths=n_paths, rng=rng,
                               fix_strike=fix_strike, device=device,
                               per_path=per_path)

    name = variant_name(rng)
    pv = (ctypes.c_float * N_PARAMS)(*params.tolist())
    jac = consts_jacobian(params, N).flatten().tolist()
    jac = (ctypes.c_float * len(jac))(*jac)
    partials, out = scratch(device, (1 + N_PARAMS) * (n_paths // LANES),
                            1 + N_PARAMS)
    table = None
    if per_path:
        table = torch.empty(1 + N_PARAMS, n_paths, dtype=torch.float32,
                            device=device)
    call_kernel("nmch_fe_greeks", name, device, pv, jac, k0, k1, epoch,
                base_path, N, n_paths, RNGS.index(rng), int(bool(fix_strike)),
                partials.data_ptr(), out.data_ptr(),
                None if table is None else table.data_ptr())
    count_launch(fe_greeks_cuda, name)
    if per_path:
        return out[0], out[1:], table
    return out[0], out[1:]


fe_greeks_cuda.launches = 0
fe_greeks_cuda.variant_launches = {}
