"""The traced window's device operations placed under the program's spans.

Each device operation is put on the host's clock at its launch record,
which shares the spans' clock (``host_spans``'s doc), and falls under the
innermost span open at that instant and under that span's ancestors.  An
operation without a launch record is left out, as is a span that never
closed.  Nothing when the window holds no trace or no spans, as with a
program that records none.
"""

from __future__ import annotations

from portbench import host_spans


def innermost(ops, launches, records) -> list[tuple[tuple, int]]:
    """[(op, index in ``records`` of the innermost span open at the op's
    launch, or -1)] of ``ops`` ((start_ns, end_ns, correlation id)) in the
    order of their launches, with ``launches`` as
    ``host_spans.device_timeline`` gives them.  Spans nest (a child opens
    and closes inside its parent); at one instant a span opens before a
    launch, which comes before a close."""
    events = []
    for i, r in enumerate(records):
        if r.end_ns is not None:
            events.append((r.start_ns, 0, i))
            events.append((r.end_ns, 2, -i))       # the child closes first
    for op in ops:
        t = launches.get(op[2])
        if t is not None:
            events.append((t, 1, op))
    events.sort()
    out, stack = [], []
    for _, kind, x in events:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            stack.remove(-x)
        else:
            out.append((x, stack[-1] if stack else -1))
    return out


def enclosing(records, i: int, name: str) -> int:
    """The index of record ``i`` or of its nearest ancestor called
    ``name``, or -1."""
    while i >= 0 and records[i].name != name:
        i = records[i].parent
    return i


def under(records, i: int, name: str) -> bool:
    """Whether record ``i`` or one of its ancestors is called ``name``."""
    return enclosing(records, i, name) >= 0


def placed(ctx):
    """(innermost(...), the span records) of a traced window, or None."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    timeline = host_spans.device_timeline(ctx.trace)
    records = host_spans.program_spans()
    if timeline is None or not records:
        return None
    return innermost(*timeline, records), records


def device_ms_per_unit(ctx, name: str):
    """The device time of the ops launched inside a span called ``name``,
    in ms, over the units of the window; None where no op was."""
    p = placed(ctx)
    if p is None:
        return None
    ops, records = p
    ns = [e - s for (s, e, _), i in ops if under(records, i, name)]
    return sum(ns) / 1e6 / ctx.window.units if ns else None
