"""The traced window: the card's operations from torch.profiler.

``DeviceTrace`` records CUDA activity only (kernels, copies, memsets and
the runtime calls that launch them), which costs the host about a
microsecond a launch and leaves the host's own work unrecorded.  After the
window, ``ops`` holds every device operation as (name, start_ns, end_ns),
sorted by start, and ``busy_s`` the length of their union: the seconds in
which an operation ran on the card.  Kernel names are matched by the
readers under ``portbench/metrics``.
"""

from __future__ import annotations

import re

import torch

_ANON = "(anonymous namespace)::"
_ARGS = re.compile(r"\(.*$")


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()
                                              * 1000)


def short_name(name: str) -> str:
    """A kernel's name without anonymous namespaces and its argument list,
    at most 120 characters."""
    short = _ARGS.sub("", name.replace(_ANON, "")).removeprefix("void ")
    return short.strip()[:120] or name[:120]


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` then ``tr.ops``, ``tr.busy_s``."""

    def __init__(self):
        self.ops: list[tuple[str, int, int]] = []
        self.busy_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._collect()
        return False

    def _collect(self) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != cuda:
                continue
            start = _ns(ev, "start")
            ops.append((ev.name(), start, start + _ns(ev, "duration")))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self.busy_s = sum(e - s for s, e in merged(ops)) / 1e9


def merged(ops) -> list[tuple[int, int]]:
    """The union of the ops' intervals as sorted disjoint (start, end)."""
    out: list[list[int]] = []
    for _, s, e in ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def breakdown(ops, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time between operations by the operation that ended it (what the host
    was preparing), each summed by name: ``{"device_ops": [[name, s]],
    "idle_gaps": [[name, s]]}``."""
    busy: dict[str, float] = {}
    for name, s, e in ops:
        key = short_name(name)
        busy[key] = busy.get(key, 0.0) + (e - s) / 1e9
    idle: dict[str, float] = {}
    end = None
    for name, s, e in ops:
        if end is not None and s > end:
            key = "before " + short_name(name)
            idle[key] = idle.get(key, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": top_of(busy), "idle_gaps": top_of(idle)}
