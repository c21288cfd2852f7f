"""Wall-clock timing that waits for the device, CUDA-event timing of
queued runs, and host spans inside a profiler's window.

The reference brackets every init()/compute() with cudaEvent timers
(``NMCH_FE.cu:370-385,395-411``).  PyTorch returns before a CUDA launch
finishes, so on a CUDA device the timer synchronises on entry and on
exit: the interval covers the device work, not just its enqueue.

``span(name)`` marks what the host does at a layer boundary of a call
(``compute``, ``prepare``, ``prepare.*``).  It records only while a
``torch.profiler`` profile is on, on ``time.time_ns()``'s clock, the
Unix-epoch nanoseconds to which the profiler converts its device trace,
so that a span and the device operations it queued compare directly;
``spans()`` returns what it recorded.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
import types

import torch
import torch.autograd.profiler as _profiler

SPAN_LIMIT = 1 << 20        # records kept; later spans are counted, not kept
_NO_COUNTS = types.MappingProxyType({})     # a record's counts until set


class SpanRecord:
    """One span: ``name``; ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` None while it is open); ``parent``, the index in
    ``spans()`` of the span it opened inside, -1 at the top;
    ``request``, a per-process number that a top-level span takes when it
    opens and its descendants share; and ``counts``, {name: int} of the
    work the span's code counted (``compute``: K2's ``k2.blocks``, and
    ``k2.warp_iters`` where K2 ran its round schedule; methods/base.py),
    empty for every other span."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request",
                 "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts = _NO_COUNTS

    def __enter__(self):
        rec = _recorder
        self.parent = rec.open
        if self.parent < 0:
            rec.requests += 1
            self.request = rec.requests
        else:
            self.request = rec.records[self.parent].request
        rec.open = len(rec.records)
        rec.records.append(self)
        self.end_ns = None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _recorder.open = self.parent
        return False


_NO_SPAN = contextlib.nullcontext()     # what ``span`` returns while off


class _Recorder:
    """The process's spans: the profiler whose window they mark is one per
    process too."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.open = -1          # index of the innermost open span
        self.requests = 0       # request numbers taken so far
        self.dropped = 0        # spans not kept past SPAN_LIMIT


_recorder = _Recorder()


def span(name: str):
    """``with span(name): ...`` records the block as a ``SpanRecord`` while
    a torch profiler records (``torch.profiler.profile`` with any
    activities); otherwise it returns one shared object that does nothing,
    at the cost of one flag read."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    if len(_recorder.records) >= SPAN_LIMIT:
        _recorder.dropped += 1
        return _NO_SPAN
    return SpanRecord(name)


def spans() -> list[SpanRecord]:
    """The spans recorded in this process, in the order they opened (a
    record's ``parent`` indexes this list)."""
    return list(_recorder.records)


def spans_dropped() -> int:
    """How many spans opened past ``SPAN_LIMIT`` and were not kept."""
    return _recorder.dropped


class Timer:
    """``with Timer(device) as t: ...`` then ``t.ms``.  A block that has
    itself waited for every device operation it queued (all on one stream,
    waited for on that stream) sets ``t.waited = True``, and the exit does
    not synchronise the device again."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self.waited = False
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.waited:
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
