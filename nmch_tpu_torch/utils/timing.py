"""Wall-clock timing that waits for the device, and CUDA-event timing of
queued runs.

The reference brackets every init()/compute() with cudaEvent timers
(``NMCH_FE.cu:370-385,395-411``).  PyTorch returns before a CUDA launch
finishes, so on a CUDA device the timer synchronises on entry and on
exit: the interval covers the device work, not just its enqueue.
"""

from __future__ import annotations

import subprocess
import time

import torch


class Timer:
    """``with Timer(device) as t: ...`` then ``t.ms``."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def timed_blocked(fn, device, reps: int = 1):
    """Run ``fn()`` once untimed (the kernels' build, the caching
    allocator's first allocations), then ``reps`` times back to back, and
    return (the last result, ms per run): the counterpart of
    ``nmch_tpu/utils/timing.py::timed_blocked`` for queued runs, as the
    probes time them.

    On a CUDA device the interval is two CUDA events recorded around the
    queued runs, read after synchronising on the second; on the CPU it is
    the host clock."""
    device = torch.device(device)
    if reps < 1:
        raise ValueError(f"reps={reps} must be >= 1")
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card); every
    number the probes print is the card's at this limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_MARK = "spin_kernel"     # torch.cuda._sleep's kernel


def device_ops(fn, calls: int = 1, traces: int = 3) -> list:
    """The names of the device operations (kernels, memsets, copies) that
    ``calls`` calls of ``fn()`` put on the card, in the order the profiler
    records them.  torch.profiler runs two warm-up cycles of the same
    calls first and reports the next cycle alone, which a one-thread spin
    kernel (``torch.cuda._sleep``) opens and closes.  A freshly started
    trace may drop activity records: a trace that lacks either mark lost
    some at an end and is taken again, up to ``traces`` times, and then
    this raises; the marks are not returned."""
    from torch.profiler import ProfilerActivity, profile, schedule
    ops = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=1,
                                       repeat=1)) as prof:
            for _ in range(3):
                torch.cuda._sleep(1)
                for _ in range(calls):
                    fn()
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                prof.step()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ops) >= 2 and all(_MARK in op for op in (ops[0], ops[-1])):
            return ops[1:-1]
    raise RuntimeError(f"device_ops: each of {traces} traces lost records "
                       f"at an end ({ops})")
