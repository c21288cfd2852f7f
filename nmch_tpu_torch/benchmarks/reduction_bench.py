"""Reduction-only microbenchmark on the card: the counterpart of
``benchmarks/reduction_bench.py``.

The reference benchmarks its two reduction strategies in isolation
(profilings/timings.txt:23-29).  ``nmch_tpu``'s probe reduces an
HBM-resident float32 array of 102.4M and 1.024B elements two ways; this
script does the same on the card:

* ``cuda+kahan``: the hand-written kernel K7 (``ops/reduction_cuda.py``
  -> ``csrc/reduction.cu``): per-tile f32 tree sums, then an f32 Kahan
  sum across the tiles in order (the FE/EM kernels' reduction on the
  TPU, ``nmch_tpu/ops/fe_pallas.py::_kahan_add``);
* ``torch.sum``: PyTorch's own reduction, the yardstick (``jnp.sum`` in
  the JAX script).

Every element is 0.5, so every tile sum is 32768 and every partial is
exact: the kernel's sum must be n/2, which the script checks.  The two
routes are timed in turns (kernel, torch.sum, torch.sum, kernel), five
times over, so that neither route's place in the order decides the
comparison: a turn is one warm-up and then 5 queued runs timed by CUDA
events, and a route's time is the median of its 10 turns.

Run: python -m nmch_tpu_torch.benchmarks.reduction_bench   (on the card)
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..methods.base import resolve_device
from ..ops.reduction import LANES, TILE
from ..ops.reduction_cuda import red_sum_cuda
from ..utils.timing import card_name_and_power_limit, timed_blocked

SIZES = (102_400_000, 1_024_000_000)   # reduction_bench.py:61
REPS = 5
TURNS = 5
ORDER = ("cuda+kahan", "torch.sum", "torch.sum", "cuda+kahan")


def rows_for(n_elems: int) -> int:
    """Rows of 128 floats, rounded down to whole (512, 128) tiles."""
    return (n_elems // LANES // TILE) * TILE


def measure(n_elems: int, device, reps: int = REPS,
            turns: int = TURNS) -> list:
    """One record per route ({name, n, ms, ms_turns, gbytes_per_s, sum})
    of the sum of rows_for(n_elems) x 128 halves on ``device``: ``turns``
    rounds of ORDER, each turn ``reps`` queued runs after a warm-up;
    ``ms`` is the median of the route's turns."""
    rows = rows_for(n_elems)
    n = rows * LANES
    x = torch.full((rows, LANES), 0.5, dtype=torch.float32, device=device)
    routes = {"cuda+kahan": red_sum_cuda, "torch.sum": torch.sum}
    times = {name: [] for name in routes}
    sums = {}
    for _ in range(turns):
        for name in ORDER:
            val, ms = timed_blocked(lambda fn=routes[name]: fn(x), device,
                                    reps)
            times[name].append(ms)
            sums[name] = float(val)
    recs = []
    for name, ts in times.items():
        ms = statistics.median(ts)
        recs.append({"name": name, "n": n, "ms": ms, "ms_turns": ts,
                     "gbytes_per_s": n * 4 / ms / 1e6, "sum": sums[name]})
    return recs


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    device = resolve_device("cuda")
    print(card_name_and_power_limit(), flush=True)
    recs = []
    for n_elems in SIZES:
        for rec in measure(n_elems, device):
            recs.append(rec)
            print(f"{rec['name']:13s} {rec['n'] / 1e6:7.1f}M elems: "
                  f"{rec['ms']:7.4f} ms ({rec['gbytes_per_s']:.0f} GB/s; "
                  f"turns {min(rec['ms_turns']):.4f}-"
                  f"{max(rec['ms_turns']):.4f})  sum={rec['sum']:.1f}",
                  flush=True)
    print(json.dumps({"reduction": recs}))
    exact = all(r["sum"] == r["n"] / 2 for r in recs
                if r["name"] == "cuda+kahan")
    if not exact:
        print("the kernel's sum is not n/2", file=sys.stderr)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
