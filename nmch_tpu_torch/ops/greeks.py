"""Pathwise Greeks of the FE price by reverse-mode autograd: the golden.

The counterpart of ``nmch_tpu/ops/greeks.py``: ``torch.autograd``
differentiates the price estimator through all N Euler steps of the
plain FE engine (``ops/fe.py``), with the draws of ``fe_moments_scan``
(counter block j drives steps 2j and 2j + 1; at odd N the second step of
the last block is masked), so the price equals ``fe_moments_scan``'s
and the gradients are the exact sensitivities of the discretized
estimator:

    delta = dP/dS_0, vega = dP/dsigma, rho_r = dP/dr,
    plus dP/dT, dP/dv_0, dP/dk, dP/dtheta, dP/drho.

The payoff (S_T - K)^+ is Lipschitz and S_T has a density, so the
pathwise estimator is unbiased for these first-order Greeks.  K = S_0 as
in the reference, so delta moves spot and strike together; fix_strike
freezes K at its input value (the classic fixed-strike delta).

Ties follow ``jax.grad``: the payoff's derivative at S_T == K is 1/2
(``torch.maximum``), |x|'s at 0 is 0.  ``sqrt_f32`` differentiates in
float64 and rounds to float32, so its derivative rounds unlike XLA's
float32 one: the gradients agree with ``nmch_tpu`` to rounding, not
bitwise.

Reverse mode keeps every step's intermediates; ``remat`` (default: N >
512) recomputes each counter block in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.  On the
card the method layer takes the forward-mode kernel G1 instead
(``ops/fe_greeks_cuda.py``); this module is its reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..rng.normal import normal4_from_bits
from ..rng.philox import MASK32
from .fe import fe_params_consts, fe_step, make_draw4, mean_f32, \
    path_index_grid

PARAM_NAMES = ("T", "S_0", "v_0", "r", "k", "rho", "theta", "sigma")
COUNTER_RNGS = ("philox", "threefry", "threefry4")


def check_counter_rng(rng: str) -> None:
    if rng not in COUNTER_RNGS:
        raise ValueError(f"rng={rng!r}: the Greeks need a counter rng "
                         f"(philox/threefry/threefry4)")


def _fe_price(pv, K, N: int, path_idx, epoch, k0, k1, rng: str,
              remat: bool):
    """Mean of (S_T - K)^+ over the paths, differentiable in pv and K."""
    S_0, v_0, cst = fe_params_consts(pv, N)
    draw = make_draw4(rng, path_idx, torch.zeros_like(path_idx), epoch,
                      k0, k1)
    ones = torch.ones(path_idx.shape, device=path_idx.device)
    S, v = ones * S_0, ones * v_0

    def block(S, v, j: int, *cst):
        g0, g1, g2, g3 = normal4_from_bits(*draw(j))
        S, v = fe_step(S, v, g0, g1, cst)
        if 2 * j + 1 < N:
            S, v = fe_step(S, v, g2, g3, cst)
        return S, v

    for j in range((N + 1) // 2):
        if remat:
            S, v = checkpoint(block, S, v, j, *cst, use_reentrant=False)
        else:
            S, v = block(S, v, j, *cst)
    payoff = torch.maximum(S - K, torch.zeros_like(S))
    return mean_f32(payoff)


def fe_price_and_greeks(params, epoch, k0, k1, *, N: int, n_paths: int,
                        rng: str = "philox", fix_strike: bool = False,
                        remat: bool | None = None):
    """(price, greeks): greeks is a dict over PARAM_NAMES of the pathwise
    dPrice/dparam at the (seed, epoch) draws, each a float32 0-dim tensor
    on the device of ``params`` (float32 (8,), ``HestonParams.as_tensor``).

    fix_strike: freeze K at the incoming S_0 instead of the K = S_0
    coupling.  remat: recompute each block in the backward pass (None:
    N > 512)."""
    check_counter_rng(rng)
    if remat is None:
        remat = N > 512
    pv = params.detach().to(torch.float32).clone().requires_grad_(True)
    K = pv[1].detach() if fix_strike else pv[1]
    path_idx = path_index_grid(n_paths, device=pv.device)
    with torch.enable_grad():
        price = _fe_price(pv, K, N, path_idx, int(epoch) & MASK32, k0, k1,
                          rng, remat)
        (grads,) = torch.autograd.grad(price, pv)
    return price.detach(), dict(zip(PARAM_NAMES, grads.unbind()))


def fe_greeks_sweep(params_matrix, epoch0, k0, k1, *, N: int, n_paths: int,
                    rng: str = "philox", fix_strike: bool = False,
                    remat: bool | None = None):
    """(prices float32 (P,), grads float32 (P, 8)) over the rows of a
    float32 (P, 8) parameter matrix: row p prices at epoch (epoch0 + p)
    mod 2^32 (the batched sweep's convention), grads in PARAM_NAMES
    order.  One ``fe_price_and_greeks`` per row."""
    prices, grads = [], []
    for p, row in enumerate(params_matrix.to(torch.float32)):
        price, g = fe_price_and_greeks(
            row, (int(epoch0) + p) & MASK32, k0, k1, N=N, n_paths=n_paths,
            rng=rng, fix_strike=fix_strike, remat=remat)
        prices.append(price)
        grads.append(torch.stack([g[n] for n in PARAM_NAMES]))
    return torch.stack(prices), torch.stack(grads)
