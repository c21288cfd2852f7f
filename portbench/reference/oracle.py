"""Semi-analytic Heston call price, a frozen copy of the port's oracle.

The "little Heston trap" characteristic function (Albrecher, Mayerhofer,
Schoutens & Tistaert 2007), integrated by Gauss-Legendre on [0, 200]
with 2000 nodes.  The benchmark's tests hold the reference's prices to it.
"""

from __future__ import annotations

import math

import numpy as np


def _phi(u, T, S_0, r, k, rho, theta, sigma, v_0):
    """E[exp(i u ln S_T)] under Heston."""
    iu = 1j * u
    a = k - rho * sigma * iu
    d = np.sqrt(a * a + sigma * sigma * (iu + u * u))
    g = (a - d) / (a + d)
    e_dt = np.exp(-d * T)
    C = (k * theta / (sigma * sigma)) * (
        (a - d) * T - 2.0 * np.log((1.0 - g * e_dt) / (1.0 - g)))
    D = ((a - d) / (sigma * sigma)) * (1.0 - e_dt) / (1.0 - g * e_dt)
    return np.exp(C + D * v_0 + iu * (math.log(S_0) + r * T))


def heston_call_undiscounted(p: dict, u_max: float = 200.0,
                             n_nodes: int = 2000) -> float:
    """E[(S_T - K)^+] at K = S_0, with no discount factor (the pricers'
    payoff is never discounted)."""
    args = (p["T"], p["S_0"], p["r"], p["k"], p["rho"], p["theta"],
            p["sigma"], p["v_0"])
    K = p["S_0"]
    lnK = math.log(K)
    phi_mi = _phi(-1j, *args)
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    u = 0.5 * u_max * (x + 1.0)
    wu = 0.5 * u_max * w
    phi_u = _phi(u.astype(complex), *args)
    phi_umi = _phi(u - 1j, *args)
    integ2 = np.real(np.exp(-1j * u * lnK) * phi_u / (1j * u))
    integ1 = np.real(np.exp(-1j * u * lnK) * phi_umi / (1j * u * phi_mi))
    P1 = 0.5 + (wu @ integ1) / math.pi
    P2 = 0.5 + (wu @ integ2) / math.pi
    return float(p["S_0"] * P1 * math.exp(p["r"] * p["T"]) - K * P2)
