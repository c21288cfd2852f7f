"""EM (Broadie–Kaya) sensitivities: pathwise where exact, CRN central
differences where rejection sampling breaks pathwise differentiability.

The counterpart of ``nmch_tpu/ops/em_greeks.py`` (its module docstring
holds the analysis).  In short: the variance path (v_t, vI, v_T) is drawn
from laws that involve only (T, v_0, k, theta, sigma), so for (S_0, r,
rho) autograd through the smooth conditional payoff, with the variance
path held fixed, is an unbiased pathwise estimator
(``em_price_and_greeks``).  The other five parameters move Poisson cell
boundaries and Marsaglia–Tsang acceptance decisions, so they get central
finite differences with common random numbers (``em_greeks_fd``): the
bumped runs share the (seed, epoch) streams, and every path whose samplers
do not flip cancels.  ``ops/em_lrm.py`` holds the score-function
alternative.

On a CUDA device the variance paths come from kernel K2: its law build
(``ops/em_cuda.py::em_law_cuda``) for the pathwise trio, and ten
conditional launches for the FD; on the CPU from the plain version
(``ops/em.py``).  What stays in torch is the per-path epilogue that XLA
runs outside any Pallas kernel in ``nmch_tpu``: a few elementwise ops on
n_paths values and their autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rng.normal import sqrt_f32
from .em import conditional_payoff_of_strike, em_moments_scan
from .em_cuda import em_law_cuda, em_moments_cuda
from .fe import mean_f32, path_index_grid

PATHWISE_PARAMS = ("S_0", "r", "rho")
FD_PARAMS = ("T", "v_0", "k", "theta", "sigma")
_IDX = {"T": 0, "S_0": 1, "v_0": 2, "r": 3, "k": 4, "rho": 5,
        "theta": 6, "sigma": 7}


def check_counter_rng(rng: str) -> None:
    if rng not in ("philox", "threefry4"):
        raise ValueError(f"rng={rng!r}: the EM Greeks need a counter rng "
                         f"(philox/threefry4)")


def pathwise_from_law(params, v_T, vI, fix_strike: bool = False):
    """(price, grads over PATHWISE_PARAMS) by autograd through the
    conditional payoff at each path's (v_T, vI), held fixed: the price is
    the conditional estimator's, each a float32 0-dim tensor."""
    pv = params.detach().to(v_T.device, torch.float32)
    T, v_0, k, theta, sigma = pv[0], pv[2], pv[4], pv[6], pv[7]
    p3 = torch.stack([pv[1], pv[3], pv[5]]).requires_grad_(True)
    with torch.enable_grad():
        S_0, r, rho = p3.unbind()
        K = S_0.detach() if fix_strike else S_0
        m = (torch.log(S_0) + r * T - 0.5 * vI
             + (rho / sigma) * (v_T - v_0 - k * theta * T + k * vI))
        sig_eff = sqrt_f32((1.0 - rho * rho) * vI)
        payoff = conditional_payoff_of_strike(m, sig_eff, K)
        price = mean_f32(payoff)
        (g,) = torch.autograd.grad(price, p3)
    return price.detach(), dict(zip(PATHWISE_PARAMS, g.unbind()))


def em_price_and_greeks(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                        rng: str = "philox",
                        poisson_cut: float | None = None,
                        fix_strike: bool = False, device="cuda"):
    """(price, greeks) with greeks a dict over PATHWISE_PARAMS, float32
    0-dim tensors on ``device``: the exactly pathwise EM subset.  The price
    is the conditional estimate (``em_moments_scan(conditional=True)``'s
    estimator); delta moves spot and the K = S_0 coupling unless
    fix_strike.  params_vec: float32 (8,); poisson_cut None means 4000."""
    check_counter_rng(rng)
    # each path's (v_T, vI): K2's law build on a card, path_law_from_consts
    # on the CPU
    _, _, v_T, vI = em_law_cuda(params_vec.to("cpu"), (k0, k1), int(epoch),
                                0, N=N, n_paths=n_paths, device=device,
                                rng=rng, poisson_cut=poisson_cut)
    return pathwise_from_law(params_vec, v_T, vI, fix_strike)


def em_greeks_fd(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                 rng: str = "philox", poisson_cut: float | None = None,
                 params: tuple = FD_PARAMS, rel_bump: float = 5e-2,
                 device="cuda"):
    """Central differences with common random numbers, a dict over
    ``params`` of float32 0-dim tensors on the CPU: two conditional prices
    per parameter at the same (seed, epoch), bumped by h =
    float32(rel_bump) * max(|x|, 0.05), and (up - dn) / (2 h) in float32
    (``nmch_tpu/ops/em_greeks.py::em_greeks_fd``).  On a card each price
    is one K2 launch."""
    check_counter_rng(rng)
    device = torch.device(device)

    def price_of(p):
        if device.type == "cuda":
            m, _ = em_moments_cuda(p, (k0, k1), epoch, 0, N=N,
                                   n_paths=n_paths, device=device, rng=rng,
                                   conditional=True, poisson_cut=poisson_cut)
        else:
            m, _ = em_moments_scan(p, N, path_index_grid(n_paths), epoch,
                                   k0, k1, rng=rng, conditional=True,
                                   poisson_cut=poisson_cut)
        return m

    return crn_fd(params_vec, price_of, params, rel_bump)


def crn_fd(params_vec, price_of, params: tuple = FD_PARAMS,
           rel_bump: float = 5e-2) -> dict:
    """``em_greeks_fd``'s differences from ``price_of``, a function of a
    bumped float32 (8,) CPU parameter vector that returns its price (any
    float tensor; taken in float32)."""
    pv = params_vec.detach().to("cpu", torch.float32)
    bump = torch.tensor(np.float32(rel_bump))
    floor = torch.tensor(np.float32(0.05))
    two = torch.tensor(2.0)
    out = {}
    for name in params:
        i = _IDX[name]
        x = pv[i]
        h = bump * torch.maximum(torch.abs(x), floor)
        up, dn = pv.clone(), pv.clone()
        up[i] = x + h
        dn[i] = x - h
        up_m, dn_m = (price_of(q).to("cpu", torch.float32) for q in (up, dn))
        out[name] = (up_m - dn_m) / (two * h)
    return out
