"""Semi-analytic Heston call price (characteristic-function oracle).

The reference has no real Heston oracle — it sanity-checks against a
Black–Scholes price fed with the vol-of-vol (SURVEY.md §4 flags this as
a weak point to improve).  This module provides the proper
semi-analytic price via the Heston characteristic function in the
numerically stable "little Heston trap" formulation (Albrecher,
Mayerhofer, Schoutens & Tistaert 2007), integrated with adaptive
quadrature.  Used as the statistical test oracle for both MC schemes.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..params import HestonParams


def _phi(u: complex, T: float, S_0: float, r: float, k: float, rho: float,
         theta: float, sigma: float, v_0: float) -> complex:
    """E[exp(i u ln S_T)] under Heston ("little trap" branch choice)."""
    iu = 1j * u
    a = k - rho * sigma * iu
    d = np.sqrt(a * a + sigma * sigma * (iu + u * u))
    g = (a - d) / (a + d)
    e_dt = np.exp(-d * T)
    C = (k * theta / (sigma * sigma)) * (
        (a - d) * T - 2.0 * np.log((1.0 - g * e_dt) / (1.0 - g))
    )
    D = ((a - d) / (sigma * sigma)) * (1.0 - e_dt) / (1.0 - g * e_dt)
    return np.exp(C + D * v_0 + iu * (math.log(S_0) + r * T))


@functools.lru_cache(maxsize=4)
def _leggauss(n_nodes: int):
    """Gauss-Legendre nodes and weights, computed once per node count (an
    eigenproblem of size n_nodes: most of a call's time) and read-only."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    x.setflags(write=False)
    w.setflags(write=False)
    return x, w


def heston_call(params: HestonParams, K: float | None = None,
                u_max: float = 200.0, n_nodes: int = 2000) -> float:
    """European call E[e^{-rT} (S_T - K)^+] via the P1/P2 decomposition.

    C = S_0 P1 - K e^{-rT} P2,
    Pj = 1/2 + (1/pi) Int_0^inf Re[e^{-iu ln K} f_j(u) / (iu)] du.

    Gauss-Legendre on [0, u_max]; the integrand decays like a Gaussian
    (v_0 T ~ 0.1), so u_max = 200 with 2000 nodes is far past machine
    precision for the reference's parameter ranges.
    """
    p = params
    K = p.K if K is None else K
    lnK = math.log(K)
    phi_mi = _phi(-1j, p.T, p.S_0, p.r, p.k, p.rho, p.theta, p.sigma, p.v_0)

    x, w = _leggauss(n_nodes)
    u = 0.5 * u_max * (x + 1.0)
    wu = 0.5 * u_max * w

    phi_u = _phi(u.astype(complex), p.T, p.S_0, p.r, p.k, p.rho, p.theta,
                 p.sigma, p.v_0)
    phi_umi = _phi(u - 1j, p.T, p.S_0, p.r, p.k, p.rho, p.theta, p.sigma,
                   p.v_0)

    integ2 = np.real(np.exp(-1j * u * lnK) * phi_u / (1j * u))
    integ1 = np.real(np.exp(-1j * u * lnK) * phi_umi / (1j * u * phi_mi))

    P1 = 0.5 + (wu @ integ1) / math.pi
    P2 = 0.5 + (wu @ integ2) / math.pi
    return float(p.S_0 * P1 - K * math.exp(-p.r * p.T) * P2)


def heston_call_undiscounted(params: HestonParams,
                             K: float | None = None) -> float:
    """E[(S_T - K)^+] with no discount factor — this matches what the
    reference's kernels actually estimate (payoff is never multiplied by
    exp(-rT) in the framework path, see ops/fe.py docstring)."""
    return heston_call(params, K) * math.exp(params.r * params.T)
