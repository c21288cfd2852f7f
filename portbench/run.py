"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds ``nmch_tpu_torch``.  In order: load
the cell (``BENCHMARK.json``, its configuration and traffic files), load
the program and build or reuse its kernel library
(``build/nmch_tpu_torch/<hash>`` in the checkout), warm up the cell's own
shapes, measure for ``--seconds`` (under torch.profiler with ``--trace
1``), check the answers against ``portbench/reference`` and print one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``card`` (name, power
limit, SM clock and power after the window), ``harness`` (steps, the
checked ones, the reference's seconds, ``built``: whether this run
compiled the kernel library, so that its set-up counts nvcc, and the
set-up's parts: process start to the cell (interpreter, torch, the card
check), the program's import and pricers, the warm-up with the library's
build or load) and
``checks`` last: each number compared beside its limit, also the last
lines on standard error.

It refuses, with a non-zero exit and no result, without as many CUDA
cards as the cell asks for, and when a module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``nmch_tpu`` is loaded: after loading,
after the window, and once more when the result is complete (the
reference and the metrics' readers run after the window).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402


def _process_start() -> float:
    """This process's start on the perf_counter clock (from /proc, so the
    interpreter's own start-up counts; the module's import time where
    /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T0


def _cache_dirs(root) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    build = os.path.join(root, "build", "portbench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))


class GuardError(RuntimeError):
    pass


def _guard(when: str) -> None:
    from .guard import forbidden_modules
    bad = forbidden_modules()
    if bad:
        raise GuardError(f"{when}: forbidden modules loaded: "
                         f"{', '.join(bad)}")


@dataclasses.dataclass
class Context:
    """What a metric's reader (``metrics/<name>.py``) reads."""
    unit: str                   # "call" or "point"
    setup_s: float
    window: object              # window.Window
    n_paths: int
    N: int                      # steps a path
    points: int                 # grid points priced per sweep step
    counts: dict                # the reference's counts: {method: {..}}
    trace: object = None        # trace.DeviceTrace with --trace 1


def _card() -> dict:
    """The card's name, power limit, SM clock and power draw (nvidia-smi)."""
    q = "name,power.limit,clocks.sm,power.draw"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        vals = [v.strip() for v in out.strip().splitlines()[0].split(",")]
        return dict(zip(q.split(","), vals))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}


def _build_seconds() -> float:
    """Seconds this process spent compiling the program's kernel library
    (0 where it found it built)."""
    from nmch_tpu_torch import _build
    return _build.load_library()[1].seconds


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float | None = None,
             sizes: dict | None = None, base=spec.HERE) -> dict:
    """One run of a cell; returns the result line as a dict.  ``device``
    "cpu" and ``sizes`` (overrides of the configuration's NTPB, NB, N)
    are for the harness's tests, which run the program's plain versions."""
    import torch

    from . import check, trace as tracing, window, workloads
    t0 = _T0 if t0 is None else t0
    t_cell = time.perf_counter()
    entry, config, traffic = spec.cell(bench, workload, base)
    config = dict(config, **(sizes or {}))
    cuda = torch.device(device).type == "cuda"

    wl = workloads.make(config, traffic, seed, device, base)
    _guard("after loading")
    t_made = time.perf_counter()
    wl.warm_up()
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t0
    build_s = _build_seconds() if cuda else 0.0

    tr = None
    if trace:
        with tracing.DeviceTrace() as tr:
            win = window.run_window(wl.step, seconds)
    else:
        win = window.run_window(wl.step, seconds)
    _guard("after the window")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    card = _card() if cuda else {}

    n = len(wl.steps)
    idx = sorted(random.Random(seed).sample(
        range(n), min(traffic["checked_steps"], n)))
    program = wl.program(idx)
    answers = [a for i in range(n) for a in wl.steps[i]]
    wl.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference, counts = wl.reference(idx)
    t_ref = time.perf_counter() - t_ref
    correct, checks = check.judge(check.gaps(program, reference),
                                  traffic["limits"])
    failed = check.failed_answers(answers)
    correct = correct and failed == 0

    ctx = Context(unit=wl.unit, setup_s=setup_s, window=win,
                  n_paths=wl.n_paths, N=wl.N, points=len(wl.points),
                  counts=counts, trace=tr)
    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        v = spec.reader(m["name"], base)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    _guard("before the result")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": entry["chips"] if cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(answers),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = win.seconds
        out["breakdown"] = tracing.breakdown(tr.ops)
    out["card"] = card
    out["harness"] = {"steps": n, "checked": idx, "reference_s": t_ref,
                      "built": build_s > 0, "build_s": build_s,
                      "setup_parts_s": {"to_the_cell": t_cell - t0,
                                        "program": t_made - t_cell,
                                        "warm_up": t_warm - t_made},
                      "step_ms_min_median_max": [
                          1e3 * min(win.step_s), win.step_ms_percentile(50),
                          1e3 * max(win.step_s)]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t0 = _process_start()
    bench = spec.load_benchmark()
    entry, _, _ = spec.cell(bench, args.workload)
    _cache_dirs(str(spec.ROOT))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        out = run_cell(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t0)
    except GuardError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
