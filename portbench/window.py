"""The measured window: a closed loop of steps timed by the host clock.

``run_window`` calls ``step()`` back to back until ``seconds`` have
passed; the window ends when the step that crossed that mark returns.
Each step ends synchronised (the pricers copy their moments to the host),
so a step's host time covers its device work.  Rates are taken over the
whole window and all its work; a percentile over every step.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    seconds: float = 0.0            # wall time of the whole window
    units: int = 0                  # calls or points completed in it
    step_s: list = dataclasses.field(default_factory=list)   # each step

    def ms_per_unit(self) -> float:
        return 1e3 * self.seconds / self.units

    def step_ms_percentile(self, q: float) -> float:
        return 1e3 * percentile(self.step_s, q)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of all values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(1, math.ceil(q / 100.0 * len(s))) - 1]


def run_window(step, seconds: float) -> Window:
    w = Window()
    clock = time.perf_counter
    t_start = clock()
    while True:
        t0 = clock()
        n = step()
        t1 = clock()
        w.step_s.append(t1 - t0)
        w.units += n
        if t1 - t_start >= seconds:
            break
    w.seconds = t1 - t_start
    return w
