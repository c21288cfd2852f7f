"""Black–Scholes helpers, including the reference's quirky "true price".

The reference prints a "true price" computed with the Black–Scholes
formula using **sigma (the vol-of-vol!) as the volatility** and T=1
(``src/NMCH/methods/NMCH_FE.cu:336-344``, ``NMCH_EM.cu:400-408``), via
the Abramowitz–Stegun polynomial normal CDF ``nmch::utils::NP``
(``src/NMCH/utils/utils.cu:5-25``).  That is *not* the Heston price —
we keep it for output parity (``reference_true_price``) and provide the
real semi-analytic Heston oracle in ``nmch_tpu_torch.oracle.heston``.
"""

from __future__ import annotations

import math


def norm_cdf_as(x: float) -> float:
    """Abramowitz–Stegun 7.1.26-style polynomial CDF, exactly the
    reference's ``NP`` (utils.cu:5-25): |x| <= 10 polynomial, else 0/1."""
    p = 0.2316419
    b1, b2, b3, b4, b5 = (0.319381530, -0.356563782, 1.781477937,
                          -1.821255978, 1.330274429)
    ax = abs(x)
    if ax <= 10.0:
        t = 1.0 / (1.0 + p * ax)
        phi = math.exp(-ax * ax / 2.0) / math.sqrt(2.0 * math.pi)
        nd = 1.0 - phi * (b1 * t + b2 * t ** 2 + b3 * t ** 3
                          + b4 * t ** 4 + b5 * t ** 5)
    else:
        nd = 1.0
    return nd if x >= 0.0 else 1.0 - nd


def norm_cdf(x: float) -> float:
    """Exact normal CDF (erfc-based)."""
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def reference_true_price(S_0: float, K: float, r: float, sigma: float) -> float:
    """The reference's printed "true price" (NMCH_FE.cu:336-338), verbatim:
    BS call with vol = sigma (vol-of-vol) and T = 1 baked in."""
    d1 = (r + 0.5 * sigma * sigma) / sigma
    d2 = (r - 0.5 * sigma * sigma) / sigma
    return S_0 * norm_cdf_as(d1) - K * math.exp(-r) * norm_cdf_as(d2)


def bs_call(S_0: float, K: float, T: float, r: float, vol: float) -> float:
    """Standard Black–Scholes call (exact CDF)."""
    if vol <= 0.0 or T <= 0.0:
        return max(S_0 - K * math.exp(-r * T), 0.0)
    sq = vol * math.sqrt(T)
    d1 = (math.log(S_0 / K) + (r + 0.5 * vol * vol) * T) / sq
    d2 = d1 - sq
    return S_0 * norm_cdf(d1) - K * math.exp(-r * T) * norm_cdf(d2)
