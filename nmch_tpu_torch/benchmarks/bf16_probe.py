"""bf16 vs float32 elementwise issue-rate probe on the card: the counterpart
of ``benchmarks/bf16_probe.py``.

Question: does packed bf16 arithmetic double the elements per cycle over
float32 on this card, i.e. could a bf16 path state lift the FE kernels'
issue-bound step rate?  The kernel K8 (``ops/chain_cuda.py`` ->
``csrc/chain_probe.cu``) runs K iterations of the probe's 8-op
mul/add/abs chain plus a tail on a resident tile: (rows, 128) float32,
one element per thread, against (2 rows, 128) bf16, one packed bf16x2
word of two elements per thread, i.e. the same threads and instructions
per iteration IF the card issues packed bf16 ops at the float32 rate.
Reported metric: element-ops/s, (8 chain ops + 1 tail) per element and
iteration.

    bf16/f32 ratio ~2.0  -> packed ALU confirmed
    ratio ~1.0           -> bf16 saves memory, not issue slots

The sqrt and rsqrt tails probe the special-function unit (MUFU) that the
FE step's square root uses.  At the JAX script's tiles (128 x 128
float32, 256 x 128 bf16) the grid is 128 blocks of 128 threads, under one
block per SM, so the time is one chain's latency; ``--rows`` at 16384
fills the card and measures the issue rate.

Prints one JSON line with the JAX script's keys ({f32,bf16}_{alu,sqrt,
rsqrt}_Gelops and _ms, ratio_{alu,sqrt,rsqrt}, and {dtype}_{tail}_error
where the card refuses a variant for a stated capability), plus the
card's name and power limit and the rows.  A kernel that fails to build
fails the run.

Usage: python -m nmch_tpu_torch.benchmarks.bf16_probe [--rows 128]
(on the card)
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from .._build import load_library
from ..methods.base import resolve_device
from ..ops.chain import DTYPES, ELEMENT_OPS, K, ROWS
from ..ops.chain_cuda import CapabilityError, chain_cuda
from ..utils.timing import card_name_and_power_limit, timed_blocked

REPS = 20                         # bf16_probe.py:43
VARIANTS = (("alu", False, False), ("sqrt", True, False),
            ("rsqrt", True, True))


def probe_input(dtype: str, rows: int, device) -> torch.Tensor:
    """The probe's tile: uniform(0.5, 1.5) from numpy seed 0, in dtype."""
    x = np.random.default_rng(0).uniform(0.5, 1.5, (rows, 128))
    return torch.from_numpy(x).to(device=device, dtype=DTYPES[dtype])


def measure(dtype: str, rows: int, with_sqrt: bool, rsqrt: bool = False, *,
            device, K: int = K, reps: int = REPS):
    """(element-ops per s, seconds per run) of the chain kernel on the
    probe's tile (a warm-up run, then ``reps`` queued runs)."""
    x = probe_input(dtype, rows, device)
    _, ms = timed_blocked(lambda: chain_cuda(x, K=K, with_sqrt=with_sqrt,
                                             rsqrt=rsqrt), device, reps)
    dt = ms / 1e3
    return rows * 128 * K * ELEMENT_OPS / dt, dt


def collect(measure_fn, f32_rows: int = ROWS["f32"]) -> dict:
    """The probe's JSON record: ``measure_fn(dtype, rows, with_sqrt,
    rsqrt)`` for each dtype and tail (bf16 at twice the rows); a variant
    refused with ``CapabilityError`` is recorded as ``*_error``.  Each
    ratio_* is formed from the unrounded rates, and left out where the
    float32 rate is 0."""
    out, rate = {}, {}
    for name in DTYPES:
        rows = f32_rows * ROWS[name] // ROWS["f32"]
        for tag, ws, rs in VARIANTS:
            try:
                elops, dt = measure_fn(name, rows, ws, rs)
            except CapabilityError as e:
                out[f"{name}_{tag}_error"] = str(e).splitlines()[0][:120]
                continue
            rate[name, tag] = elops
            out[f"{name}_{tag}_Gelops"] = round(elops / 1e9, 1)
            out[f"{name}_{tag}_ms"] = round(dt * 1e3, 3)
    for tag, _, _ in VARIANTS:
        a, b = rate.get(("bf16", tag)), rate.get(("f32", tag))
        if a is not None and b:
            out[f"ratio_{tag}"] = round(a / b, 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS["f32"],
                    help="float32 rows of the tile (bf16 runs twice as "
                         "many); 128 is the JAX script's")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    load_library()          # a kernel that fails to build fails the run
    out = collect(functools.partial(measure, device=device), args.rows)
    out.update(card=card_name_and_power_limit(), f32_rows=args.rows,
               bf16_rows=2 * args.rows, K=K)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
