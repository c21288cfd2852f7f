"""The readings that the limits of ``correct`` are set from (on the card).

    python3 -m portbench.calibrate --cells cli_fe,cli_em --seeds 12
        --control-seeds 3 [--fmad] [--out FILE]

For each cell, in one process and at the cell's own size, on ``--seeds``
seeds: the cell's warm-up and ``checked_steps + 1`` steps of its timed
path, then the numbers that a run compares (``program``: the program's
answers of the first ``checked_steps`` steps against the float32
reference; the lower reading is their largest, over every seed), and
what a step that leaves its state unchanged would read (``unchanged``:
each checked step's answers against those of the step after it).  On ``--control-seeds``
more, the control (``control``: the reference with its path state and
step arithmetic in bfloat16, put in the program's place; the upper
reading is their smallest).

``--fmad`` builds the program's kernel library with ``-fmad=true``: nvcc
then contracts a*b+c into one rounding, a float32 reordering of the same
arithmetic, so its readings are those of a sound program that rounds
differently from the reference.  One JSON object per cell goes to
``--out`` and standard output.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from . import check, spec, workloads


def _fmad_build() -> None:
    """The program's library built with contraction (a separate build
    directory: the flags are part of its hash)."""
    from nmch_tpu_torch import _build
    flags = tuple("-fmad=true" if f == "-fmad=false" else f
                  for f in _build.NVCC_FLAGS)
    if flags == _build.NVCC_FLAGS:
        raise RuntimeError("the build has no -fmad=false to switch")
    _build.NVCC_FLAGS = flags
    _build.load_library.cache_clear()


def readings(bench, cell: str, seed: int, control: bool,
             device="cuda") -> dict:
    import torch
    _, config, traffic = spec.cell(bench, cell)
    wl = workloads.make(config, traffic, seed, device)
    wl.warm_up()
    k = traffic["checked_steps"]
    for _ in range(k + 1):
        wl.step()
    wl.release()
    idx = list(range(k))
    prog = wl.program(idx)
    nxt = wl.program([i + 1 for i in idx])
    ref, _ = wl.reference(idx)
    out = {"seed": seed,
           "program": check.gaps(prog, ref),
           "unchanged": check.gaps(prog, nxt)}
    if control:
        ctl, _ = wl.reference(idx, torch.bfloat16)
        out["control"] = check.gaps(ctl, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fmad", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.fmad:
        _fmad_build()
    bench = spec.load_benchmark()
    rng = random.Random(3_000_000_017 + 7 * args.fmad)
    for cell in args.cells.split(","):
        seeds = [rng.randrange(1 << 31, 1 << 32) for _ in range(
            args.seeds + args.control_seeds)]
        rows = []
        for i, s in enumerate(seeds):
            rows.append(readings(bench, cell, s, i >= args.seeds))
            print(cell, rows[-1], file=sys.stderr, flush=True)
        names = list(rows[0]["program"])
        summary = {
            "cell": cell, "fmad": args.fmad, "rows": rows,
            "lower": {n: max(r["program"][n] for r in rows)
                      for n in names},
            "unchanged": {n: min(r["unchanged"][n] for r in rows)
                          for n in names}}
        if args.control_seeds:
            summary["upper"] = {n: min(r["control"][n] for r in rows
                                       if "control" in r) for n in names}
        line = json.dumps(summary)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
