"""Broadie–Kaya "Exact Method" (EM): loop constants and the plain golden.

The counterpart of ``nmch_tpu/ops/em.py``, for the counter families
(philox/threefry4) and, with the integer ``seed``, the stateful families
(xorwow/mrg32k3a: each path's recurrence state starts at stream (seed,
path, epoch) and is carried through the sampler rounds).  Per time step
(reference ``NMCH_EM.cu:96-124``) the variance moves through its exact
noncentral-chi-square law, sampled as a Poisson mixture of gammas:

    lambda   = lam_const * v_t
    N_p      ~ Poisson(lambda)
    gamma    ~ Gamma(d + N_p),  d = 2 k theta / sigma^2
    v_{t+dt} = vfac * gamma

with the trapezoidal integrated variance vI = sum(v_t + v_{t+dt}) * dt/2,
and the terminal price drawn in closed form given the variance path:

    m    = ln S_0 + r T - vI/2 + (rho/sigma)(v_T - v_0 - k theta T + k vI)
    S_T  = exp(m + sqrt((1 - rho^2) vI) * G)

(or, with ``conditional``, the Black–Scholes expectation of the payoff
given m and the variance path).  Consumption: each path's counter advances
lane-locally through the sampler rounds (``ops/sampling.py``), then one
block for the terminal normal.  For a stateful family the "counter" is
the 6-tuple of state words.

``em_consts`` computes the loop constants once, in float32 on the CPU;
the plain version here and the kernel wrapper (``ops/em_cuda.py``) both
start from its bits.  ``em_consts_table`` gives the same bits for each
point of a sweep (``ops/sweep.py``, ``ops/sweep_cuda.py``), and the
``*_from_consts`` functions take constants that are Python floats (one
point) or (P, 1, 1) tensors (P points on a leading axis).  Layout: paths
in (n_paths/128, 128) tensors, as in ``ops/fe.py``; moments are summed in
float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..rng.normal import boxmuller, sqrt_f32, uniform_open01
from .fe import moments_f64
from .sampling import POISSON_LARGE, STATEFUL_RNGS, gamma_ms_from_stream, \
    make_stream_draw4, poisson_from_stream, stream_state_init

# The method layer's Poisson cut (nmch_tpu/ops/em.py:53): the price is
# insensitive down to ~128 while the PTRS rounds it avoids dominate the
# EM step cost.  NMCH_EM and the CLI resolve None to this; the ops layer
# (this module, ops/sampling.py, ops/em_cuda.py) resolves None to
# curand's 4000.
FAST_POISSON_CUT = 128.0


class EmConsts(NamedTuple):
    """Loop-invariant float32 values of one EM run (each a Python float
    that is exactly a float32), in the argument order of ``csrc/em.cu``."""
    v_0: float
    S_0: float          # also the strike K
    lam_const: float    # 2 k e^{-k dt} / (sigma^2 (1 - e^{-k dt}))
    d: float            # 2 k theta / sigma^2
    vfac: float         # sigma^2 (1 - e^{-k dt}) / (2 k)
    half_dt: float      # dt * 0.5
    log_S0: float       # ln S_0 (= ln K)
    m0: float           # ln S_0 + r T
    rho_s: float        # rho / sigma
    ktT: float          # k * theta * T
    k: float
    one_m_rho2: float   # 1 - rho^2
    poisson_cut: float  # lambda at and above which N_p is the normal approx


def em_consts(params, N: int, poisson_cut: float | None = None) -> EmConsts:
    """``nmch_tpu.ops.em.em_path_law``'s constants, in its order of float32
    operations, computed on the CPU.  params: float32 (8,) tensor (T, S_0,
    v_0, r, k, rho, theta, sigma); poisson_cut None means 4000."""
    row = em_consts_table(params.reshape(1, 8), N, poisson_cut)[0]
    return EmConsts(*(float(v) for v in row))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e^x of float32 x, rounded once from float64 (differentiable)."""
    return torch.exp(x.double()).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """ln x of float32 x, rounded once from float64."""
    return torch.log(x.double()).float()


def em_consts_table(params_matrix, N: int,
                    poisson_cut: float | None = None) -> torch.Tensor:
    """float32 (P, 13) on the CPU: row p holds the ``EmConsts`` of
    params_matrix[p], a float32 (P, 8) matrix of (T, S_0, v_0, r, k, rho,
    theta, sigma) rows.

    The arithmetic runs on the (P,) columns (IEEE float32 operations, so
    each element rounds as a 0-dim one does).  The two transcendentals are
    taken in float64 and rounded once (``exp_f32``, ``log_f32``): the
    correctly rounded float32, which no host's float32 libm or SIMD path
    can move."""
    p = params_matrix.detach().to("cpu", torch.float32)
    T, S_0, v_0, r, k, rho, theta, sigma = p.unbind(1)
    dt = T / N
    exp_kdt = exp_f32(-k * dt)
    sig2 = sigma * sigma
    d = 2.0 * k * theta / sig2
    one_m = 1.0 - exp_kdt
    lam_const = 2.0 * k * exp_kdt / (sig2 * one_m)
    vfac = sig2 * one_m / (2.0 * k)
    log_S0 = log_f32(S_0)
    cut = float(np.float32(POISSON_LARGE if poisson_cut is None
                           else poisson_cut))
    cols = (v_0, S_0, lam_const, d, vfac, dt * 0.5, log_S0, log_S0 + r * T,
            rho / sigma, k * theta * T, k, 1.0 - rho * rho,
            torch.full_like(T, cut))
    return torch.stack(cols, dim=1)


def em_path_law(params, N: int, path_lo, path_hi, epoch, k0, k1,
                rng: str = "philox", poisson_cut: float | None = None,
                seed: int | None = None):
    """Simulate the exact variance path; returns (m, sig_eff, v_T, vI,
    final_ctr): ln S_T ~ N(m, sig_eff^2) given the variance path.  path_lo
    and path_hi are int64 tensors of u32 path words; the counters come
    back as an int64 tensor of the same shape (a 6-tuple of them for a
    stateful rng).  seed: the python int seed, required for the stateful
    families and ignored otherwise."""
    return path_law_from_consts(em_consts(params, N, poisson_cut), N,
                                path_lo, path_hi, epoch, k0, k1, rng, seed)


def path_law_from_consts(c: EmConsts, N: int, path_lo, path_hi, epoch,
                         k0, k1, rng: str, seed: int | None = None):
    """``em_path_law`` from its constants.  The fields of ``c`` other than
    ``poisson_cut`` (always a float) may be tensors that broadcast against
    ``path_lo``, as may ``epoch`` for a counter rng; the outputs take the
    broadcast shape."""
    Vt = torch.zeros(path_lo.shape, device=path_lo.device) + c.v_0
    vI = torch.zeros_like(Vt)
    if rng in STATEFUL_RNGS:
        if seed is None:
            raise ValueError(f"rng={rng!r} needs the integer seed "
                             f"(stateful stream init)")
        ctr = stream_state_init(rng, seed, path_lo, epoch)
    else:
        ctr = torch.zeros(Vt.shape, dtype=torch.int64,
                          device=path_lo.device)
    for _ in range(N):
        lam = c.lam_const * Vt
        N_p, ctr = poisson_from_stream(lam, ctr, epoch, path_lo, path_hi,
                                       k0, k1, rng=rng,
                                       large_cut=c.poisson_cut)
        gam, ctr = gamma_ms_from_stream(c.d + N_p, ctr, epoch, path_lo,
                                        path_hi, k0, k1, rng=rng)
        Vt_next = c.vfac * gam
        vI = vI + (Vt + Vt_next)     # dt/2 applied once after the loop
        Vt = Vt_next
    vI = vI * c.half_dt
    m = (c.m0 - 0.5 * vI
         + c.rho_s * (Vt - c.v_0 - c.ktT + c.k * vI))
    sig_eff = sqrt_f32(c.one_m_rho2 * vI)
    return m, sig_eff, Vt, vI, ctr


def em_terminal_core(params, N: int, path_lo, path_hi, epoch, k0, k1,
                     rng: str = "philox", poisson_cut: float | None = None,
                     seed: int | None = None):
    """Simulate the exact scheme; returns (S_T, v_T, vI, final_ctr)."""
    return terminal_from_consts(em_consts(params, N, poisson_cut), N,
                                path_lo, path_hi, epoch, k0, k1, rng, seed)


def terminal_from_consts(c: EmConsts, N: int, path_lo, path_hi, epoch,
                         k0, k1, rng: str, seed: int | None = None):
    """``em_terminal_core`` from its constants (``path_law_from_consts``)."""
    m, sig_eff, Vt, vI, ctr = path_law_from_consts(c, N, path_lo, path_hi,
                                                   epoch, k0, k1, rng, seed)
    S_T, ctr = terminal_draw(m, sig_eff, ctr, path_lo, path_hi, epoch, k0,
                             k1, rng)
    return S_T, Vt, vI, ctr


def terminal_draw(m, sig_eff, ctr, path_lo, path_hi, epoch, k0, k1,
                  rng: str):
    """S_T = exp(m + sig_eff * G) from one more block of each path's
    stream after the variance path; returns (S_T, final_ctr)."""
    w0, w1, _, _, ctr = make_stream_draw4(rng, epoch, path_lo, path_hi,
                                          k0, k1)(ctr)
    g, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
    return torch.exp(m + sig_eff * g), ctr


# Abramowitz–Stegun 7.1.26 (the reference's nmch::utils::NP, utils.cu:5-25)
_AS_P = float(np.float32(0.2316419))
_AS_B = tuple(float(np.float32(b)) for b in
              (0.319381530, -0.356563782, 1.781477937,
               -1.821255978, 1.330274429))
_INV_SQRT_2PI = float(np.float32(0.3989422804014327))


def norm_cdf_vec(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz–Stegun 7.1.26 normal CDF, max abs error ~7.5e-8."""
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _AS_P * ax)
    poly = _AS_B[4] * t + _AS_B[3]
    for b in _AS_B[2::-1]:
        poly = poly * t + b
    poly = poly * t
    phi = _INV_SQRT_2PI * torch.exp(-0.5 * ax * ax)
    nd = 1.0 - phi * poly
    return torch.where(x >= 0.0, nd, 1.0 - nd)


def em_conditional_payoff(m, sig_eff, K: float, log_K: float):
    """E[(S_T - K)^+ | variance path] = e^{m+s^2/2} Phi(s - d) - K Phi(-d),
    d = (ln K - m)/s (conditional Monte Carlo).  K and log_K: floats, or
    tensors that broadcast against m (``conditional_payoff_of_strike``)."""
    s = torch.clamp_min(sig_eff, float(np.float32(1e-12)))
    d = (log_K - m) / s
    return (torch.exp(m + 0.5 * s * s) * norm_cdf_vec(s - d)
            - K * norm_cdf_vec(-d))


def conditional_payoff_of_strike(m, sig_eff, K: torch.Tensor):
    """``em_conditional_payoff`` at a strike K that is a float32 tensor, ln
    K taken here (``nmch_tpu``'s em_conditional_payoff takes K traced):
    differentiable in K, for the Greeks' K = S_0 coupling."""
    return em_conditional_payoff(m, sig_eff, K, torch.log(K))


def em_terminal(params, N: int, path_idx, epoch, k0, k1,
                rng: str = "philox", poisson_cut: float | None = None,
                seed: int | None = None):
    """(S_T, v_T) for (R, 128) path indices."""
    S_T, v_T, _, _ = em_terminal_core(params, N, path_idx,
                                      torch.zeros_like(path_idx), epoch,
                                      k0, k1, rng=rng,
                                      poisson_cut=poisson_cut, seed=seed)
    return S_T, v_T


def em_payoffs(params, N: int, path_idx, epoch, k0, k1,
               rng: str = "philox", conditional: bool = False,
               poisson_cut: float | None = None, seed: int | None = None):
    """Per-path (payoff float32, final counter int64) in the layout of
    ``path_idx``: X = (S_T - K)^+, K = S_0, or its conditional
    expectation given the variance path (one fewer block per path).  For
    a stateful rng (``seed`` required) the counter is the final 6-tuple
    of state words."""
    return payoffs_from_consts(em_consts(params, N, poisson_cut), N,
                               path_idx, epoch, k0, k1, rng, conditional,
                               seed)


def payoffs_from_consts(c: EmConsts, N: int, path_idx, epoch, k0, k1,
                        rng: str, conditional: bool,
                        seed: int | None = None):
    """``em_payoffs`` from its constants: the ``conditional`` entry of
    ``payoffs_both_from_consts``."""
    return payoffs_both_from_consts(c, N, path_idx, epoch, k0, k1, rng,
                                    seed)[conditional]


def payoffs_both_from_consts(c: EmConsts, N: int, path_idx, epoch, k0, k1,
                             rng: str, seed: int | None = None) -> dict:
    """Both estimators from one simulation of the variance path law
    (``path_law_from_consts``): {False: (payoff, final_ctr) of the sampled
    terminal price, which draws one more block a path, True: those of the
    conditional payoff}."""
    path_hi = torch.zeros_like(path_idx)
    m, sig_eff, _, _, ctr = path_law_from_consts(c, N, path_idx, path_hi,
                                                 epoch, k0, k1, rng, seed)
    S_T, ctr_t = terminal_draw(m, sig_eff, ctr, path_idx, path_hi, epoch,
                               k0, k1, rng)
    return {False: (torch.clamp_min(S_T - c.S_0, 0.0), ctr_t),
            True: (em_conditional_payoff(m, sig_eff, c.S_0, c.log_S0), ctr)}


def em_moments_scan(params, N: int, path_idx, epoch, k0, k1,
                    rng: str = "philox", conditional: bool = False,
                    poisson_cut: float | None = None,
                    seed: int | None = None):
    """Golden engine: (E[X], E[X^2]) as float64 0-dim tensors.  seed: the
    python int seed, required for the stateful families."""
    payoff, _ = em_payoffs(params, N, path_idx, epoch, k0, k1, rng=rng,
                           conditional=conditional, poisson_cut=poisson_cut,
                           seed=seed)
    return moments_f64(payoff)
