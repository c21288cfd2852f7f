"""The program's host spans against the traced device operations.

The program records spans (``nmch_tpu_torch.utils.timing.span``) only while
a profiler records, on ``time.time_ns()``: ``compute`` a pricer's call,
``prepare`` the host's work until the kernel is queued, ``prepare.*`` its
parts.  The trace's host-side records (the runtime calls that queue each
device operation) share that clock, but its device records do not: on an
H100 their offset from it wanders by milliseconds within a 20 s window.
So each idle gap of the card (between two merged operations, as long as
the device records measure it) is placed on the host's clock to end where
the host called the launch of the operation that ended it (the record of
the same correlation id), a few microseconds before the card started it.
That holds for an operation launched onto an idle card; one queued while
the card was busy, or without a launch record, takes the offset of the
last operation that was not.

Of the requests (a top-level span and the spans inside it) that overlap
the traced operations so placed, ``split_of`` assigns each instant of
those gaps to the innermost span open then, and to the caller where none
is.  Nothing when the window holds no trace or no spans, as with a
program that records none.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from portbench import trace

PREPARE = "prepare"


def is_prepare(name) -> bool:
    return name == PREPARE or (name or "").startswith(PREPARE + ".")


def program_spans():
    """The program's span records, or None where it records none or
    dropped some."""
    try:
        from nmch_tpu_torch.utils.timing import spans, spans_dropped
    except ImportError:
        return None
    return None if spans_dropped() else spans()


@functools.lru_cache(maxsize=1)
def device_timeline(tr):
    """(ops, launches) of a ``trace.DeviceTrace``: its device operations as
    (start_ns, end_ns, correlation id) sorted by start, and {correlation
    id: start_ns} of its host-side records; None without the profiler's
    records."""
    prof = getattr(tr, "_prof", None)
    if prof is None:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        start = trace._ns(ev, "start")
        if ev.device_type() == cuda:
            ops.append((start, start + trace._ns(ev, "duration"),
                        ev.correlation_id()))
        elif ev.correlation_id():
            launches[ev.correlation_id()] = start
    ops.sort()
    return ops, launches


@dataclasses.dataclass
class Split:
    prep_ns: int        # the union of the requests' prepare* spans
    idle_ns: dict       # card idle ns by innermost span name, None: caller


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _overlaps(pieces, gaps) -> dict:
    """{label: ns} of sorted disjoint labelled (start, end, label) pieces
    inside sorted disjoint gaps."""
    out: dict = {}
    j = 0
    for s, e, label in pieces:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            ov = min(e, gaps[k][1]) - max(s, gaps[k][0])
            if ov > 0:
                out[label] = out.get(label, 0) + ov
            k += 1
    return out


def host_gaps(ops, launches):
    """(gaps, lo, hi): the card's idle gaps between the first and the last
    of ``ops`` ((start_ns, end_ns, correlation id), sorted by start), each
    placed on the host's clock by the launch record of the operation that
    ends it (see the module's doc), sorted and disjoint, and the first
    operation's start and the last one's end on that clock; None where no
    operation has a launch record."""
    busy: list[list[int]] = []      # [start, end, correlation id of first]
    for s, e, c in ops:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e, c])
    shifts, shift = [], None       # device clock minus host clock
    for k, (s, _, c) in enumerate(busy):
        t = launches.get(c)
        if t is not None and (shift is None or t >= busy[k - 1][1] - shift):
            shift = s - t
        shifts.append(shift)
    first = next((x for x in shifts if x is not None), None)
    if first is None:
        return None
    shifts = [first if x is None else x for x in shifts]
    gaps = []
    for prev, nxt, shift in zip(busy, busy[1:], shifts[1:]):
        s, e = prev[1] - shift, nxt[0] - shift
        if gaps:
            s = max(s, gaps[-1][1])
        if e > s:
            gaps.append((s, e))
    return gaps, busy[0][0] - shifts[0], busy[-1][1] - shifts[-1]


def split_of(ops, launches, records) -> Split | None:
    """The split of the device operations ``ops`` by the span ``records``,
    with ``launches`` as ``device_timeline`` gives them."""
    placed = host_gaps(ops, launches) if records else None
    if placed is None:
        return None
    gaps, lo, hi = placed
    done = [i for i, r in enumerate(records) if r.end_ns is not None]
    requests = {records[i].request for i in done
                if records[i].start_ns <= hi and records[i].end_ns >= lo}
    kept = [i for i in done if records[i].request in requests]
    if not kept:
        return None
    kids: dict = {}
    for i in kept:
        kids.setdefault(records[i].parent, []).append(i)
    pieces = []
    for i in kept:
        r = records[i]
        t = r.start_ns
        for c in kids.get(i, ()):
            pieces.append((t, records[c].start_ns, r.name))
            t = records[c].end_ns
        pieces.append((t, r.end_ns, r.name))
    pieces = sorted(p for p in pieces if p[1] > p[0])
    idle = _overlaps(pieces, gaps)
    idle[None] = sum(e - s for s, e in gaps) - sum(idle.values())
    prep = _union_ns((records[i].start_ns, records[i].end_ns) for i in kept
                     if is_prepare(records[i].name))
    return Split(prep_ns=prep, idle_ns=idle)


def split(ctx, unit: str) -> Split | None:
    """The split of a traced window of a cell whose unit is ``unit``."""
    if ctx.trace is None or ctx.unit != unit or not ctx.trace.ops:
        return None
    timeline = device_timeline(ctx.trace)
    records = program_spans()
    if timeline is None or not records:
        return None
    return split_of(*timeline, records)


def prep_ms(ctx, unit: str):
    s = split(ctx, unit)
    return None if s is None else s.prep_ns / 1e6 / ctx.window.units


def idle_prep_pct(ctx, unit: str):
    s = split(ctx, unit)
    if s is None:
        return None
    ns = sum(v for k, v in s.idle_ns.items() if is_prepare(k))
    return 100.0 * ns / 1e9 / ctx.window.seconds


def idle_caller_pct(ctx, unit: str):
    s = split(ctx, unit)
    return None if s is None else \
        100.0 * s.idle_ns[None] / 1e9 / ctx.window.seconds
