"""The exploration grid (edo01/NMCH ``exploration.cu:24-25,71-81,105``).

kappa, theta and sigma each run from lo to hi in ``steps`` equal steps by
the reference's accumulating loop (``for (x = lo; x <= hi; x += (hi -
lo) / steps)``), sigma outermost and kappa innermost, and a point is kept
only where 20 kappa theta >= sigma^2.
"""

from __future__ import annotations


def axis(lo: float, hi: float, steps: int) -> list[float]:
    step = (hi - lo) / steps
    out, x = [], lo
    for _ in range(steps + 2):
        if x > hi + 1e-9:
            break
        out.append(x)
        x += step
    return out


def grid_points(grid: dict) -> list[tuple[float, float, float]]:
    """(k, theta, sigma) of every kept point, in the reference's order."""
    n = grid["steps"]
    return [(k, theta, sigma)
            for sigma in axis(*grid["sigma"], n)
            for theta in axis(*grid["theta"], n)
            for k in axis(*grid["k"], n)
            if 20.0 * k * theta >= sigma * sigma]
