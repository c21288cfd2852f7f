"""The readers of the program's host spans (``portbench/host_spans.py``) on
synthetic traces, with the device records' clock offset from the host's,
and on spans the program records on the CPU."""

import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import host_spans, run, spec, trace, window

US = 1000       # ns


def _rec(name, start, end, parent, request):
    return types.SimpleNamespace(name=name, start_ns=start * US,
                                 end_ns=end * US, parent=parent,
                                 request=request)


def _timeline(ops, offset=lambda t: 0):
    """Device records (start_ns, end_ns, correlation id) of ops given in us
    on the host's clock, their device clock ahead of it by offset(start),
    and each op's launch record at its host start."""
    dev = [(s * US + offset(s), e * US + offset(s), i + 1)
           for i, (_, s, e) in enumerate(ops)]
    return dev, {i + 1: s * US for i, (_, s, _) in enumerate(ops)}


def _ctx(ops, unit="call", seconds=1e-3, units=2, timeline=None):
    tr = trace.DeviceTrace()
    tr.ops = [(n, s * US, e * US) for n, s, e in ops]
    tr.busy_s = sum(e - s for s, e in trace.merged(tr.ops)) / 1e9
    tr.timeline = timeline or _timeline(ops)
    win = window.Window(seconds=seconds, units=units)
    return run.Context(unit=unit, setup_s=1.0, window=win, n_paths=128,
                       N=4, points=0, counts={}, trace=tr)


def _read(name, ctx):
    return spec.reader(name)(ctx)


# two calls: the card runs [100, 200) and [300, 400) us; in the gap the
# host is in the caller's code (200-240), in ``compute`` alone (240-250)
# and in ``prepare`` (250-300, half of the gap: 30 in it, 20 in its
# ``prepare.enqueue``)
OPS = [("fe_paths", 100, 200), ("fe_paths", 300, 400)]
RECORDS = [
    _rec("compute", 20, 200, -1, 1), _rec("prepare", 30, 90, 0, 1),
    _rec("prepare.enqueue", 60, 90, 1, 1),
    _rec("compute", 240, 410, -1, 2), _rec("prepare", 250, 310, 3, 2),
    _rec("prepare.enqueue", 280, 310, 4, 2),
]


@pytest.fixture
def recorded(monkeypatch):
    def use(records):
        monkeypatch.setattr(host_spans, "program_spans", lambda: records)
    monkeypatch.setattr(host_spans, "device_timeline",
                        lambda tr: getattr(tr, "timeline", None))
    use(RECORDS)
    return use


def test_a_gap_half_covered_by_prepare_counts_half(recorded):
    ctx = _ctx(OPS)
    s = host_spans.split(ctx, "call")
    assert s.idle_ns == {"prepare": 30 * US, "prepare.enqueue": 20 * US,
                         "compute": 10 * US, None: 40 * US}
    assert s.prep_ns == 60 * US + 60 * US
    assert _read("idle_prep_pct.call", ctx) == pytest.approx(
        100 * 50e-6 / 1e-3)
    assert _read("idle_caller_pct.call", ctx) == pytest.approx(
        100 * 40e-6 / 1e-3)
    assert _read("prep_ms.call", ctx) == pytest.approx(120e-3 / 2)
    idle = _read("idle_pct.call", ctx)
    assert _read("idle_prep_pct.call", ctx) + \
        _read("idle_caller_pct.call", ctx) <= idle
    for name in ("prep_ms.sweep", "idle_prep_pct.sweep",
                 "idle_caller_pct.sweep"):
        assert _read(name, ctx) is None


def test_sweep_readers_and_top_level_prepare(recorded):
    """The batched sweep's ``prepare`` is the top of its request; the copy
    in it is the trace's first operation."""
    recorded([_rec("prepare", 0, 120, -1, 7),
              _rec("prepare.grid", 10, 40, 0, 7),
              _rec("prepare.copy_in", 90, 110, 0, 7),
              _rec("prepare", 500, 556, -1, 8),
              _rec("prepare.grid", 500, 530, 3, 8)])
    ops = [("Memcpy HtoD", 100, 105), ("em_sweep_paths", 130, 450),
           ("Memcpy HtoD", 555, 558), ("fe_sweep_paths", 570, 600)]
    ctx = _ctx(ops, unit="point", seconds=1e-3, units=200)
    s = host_spans.split(ctx, "point")
    # gaps: 105-130 (prepare 105-120: 5 in copy_in, 10 in prepare; caller
    # 10), 450-555 (caller 50, grid 30, prepare 25), 558-570 (caller)
    assert s.idle_ns == {"prepare.copy_in": 5 * US, "prepare": 35 * US,
                         "prepare.grid": 30 * US, None: 72 * US}
    assert s.prep_ns == 176 * US
    assert _read("prep_ms.sweep", ctx) == pytest.approx(176e-3 / 200)
    assert _read("idle_prep_pct.sweep", ctx) == pytest.approx(
        100 * 70e-6 / 1e-3)
    assert _read("idle_caller_pct.sweep", ctx) == pytest.approx(
        100 * 72e-6 / 1e-3)
    assert _read("idle_prep_pct.call", ctx) is None


def test_the_device_clocks_offset_is_taken_out(recorded):
    """The same window with the device records 3 ms ahead of the host's
    clock, or 2 ms behind it: the split is the same.  Without the second
    op's launch record its gap takes the last offset known."""
    want = host_spans.split(_ctx(OPS), "call")
    for off in (3000 * US, -2000 * US):
        moved = _timeline(OPS, lambda t: off)
        assert host_spans.split(_ctx(OPS, timeline=moved), "call") == want
    ops, launches = _timeline(OPS, lambda t: 3000 * US)
    lost = (ops, {c: t for c, t in launches.items() if c != 2})
    assert host_spans.split(_ctx(OPS, timeline=lost), "call") == want
    # one launch record, 5 us before its op's start: every gap 5 us earlier
    one = (ops, {1: launches[1] - 5 * US})
    s = host_spans.split(_ctx(OPS, timeline=one), "call")
    assert s.idle_ns == {"compute": 15 * US, "prepare": 30 * US,
                         "prepare.enqueue": 15 * US, None: 40 * US}
    assert host_spans.split(_ctx(OPS, timeline=(ops, {})), "call") is None


def test_an_op_queued_behind_a_kernel_keeps_the_kernels_offset(recorded):
    """A sum launched at 110 us, while the kernel runs, starts 1 us after
    the kernel's end: its 1 us gap stays where the kernel's launch puts
    it, not at the sum's launch."""
    ops = OPS[:1] + [("sum_partials", 201, 205)] + OPS[1:]
    want = host_spans.split(_ctx(ops), "call")
    assert want.idle_ns["compute"] == 10 * US
    dev, launches = _timeline(ops, lambda t: 3000 * US)
    launches[2] = 110 * US
    assert host_spans.split(_ctx(ops, timeline=(dev, launches)),
                            "call") == want


def test_requests_outside_the_trace_are_left_out(recorded):
    old = [_rec("compute", -900, -800, -1, 0), _rec("prepare", -890, -810,
                                                    0, 0)]
    shifted = [types.SimpleNamespace(**dict(vars(r), parent=r.parent + 2
                                            if r.parent >= 0 else -1))
               for r in RECORDS]
    recorded(old + shifted)
    ctx = _ctx(OPS)
    recorded(RECORDS)
    want = host_spans.split(ctx, "call")
    recorded(old + shifted)
    assert host_spans.split(ctx, "call") == want


def test_nothing_without_a_trace_or_spans(recorded, monkeypatch):
    ctx = _ctx(OPS)
    names = [f"{m}.{u}" for m in ("prep_ms", "idle_prep_pct",
                                  "idle_caller_pct")
             for u in ("call", "sweep")]
    ctx_none = _ctx(OPS)
    ctx_none.trace = None
    for name in names:
        assert _read(name, ctx_none) is None
    recorded([])
    for name in names:
        assert _read(name, ctx) is None
    recorded(None)
    for name in names:
        assert _read(name, ctx) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the spans: its ``utils.timing`` has no ``spans``."""
    monkeypatch.setitem(sys.modules, "nmch_tpu_torch.utils.timing",
                        types.ModuleType("nmch_tpu_torch.utils.timing"))
    assert host_spans.program_spans() is None
    assert _read("prep_ms.call", _ctx(OPS)) is None


def test_dropped_spans_read_nothing(monkeypatch):
    from nmch_tpu_torch.utils import timing
    rec = timing._Recorder()
    rec.dropped = 1
    monkeypatch.setattr(timing, "_recorder", rec)
    assert host_spans.program_spans() is None


def test_spans_the_program_records(monkeypatch):
    """Three ``compute()`` calls on the CPU under a profiler, each given a
    device operation from the end of its ``prepare`` to shortly before
    the end of its ``compute``: the host's preparation of the second and
    third calls is idle card time, the first precedes the trace."""
    from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig
    from nmch_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "_recorder", timing._Recorder())
    p = NMCH_FE(SimConfig(NTPB=128, NB=1, N=4), HestonParams(),
                device="cpu")
    p.init(9)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            p.compute()
    rec = timing.spans()
    calls = [r for r in rec if r.name == "compute"]
    prep = [r for r in rec if r.name == "prepare"]
    assert len(calls) == len(prep) == 3
    ops = [("k", q.end_ns, c.end_ns - 1) for c, q in zip(calls, prep)]
    tr = trace.DeviceTrace()
    tr.ops = ops
    tr.busy_s = sum(e - s for s, e in trace.merged(ops)) / 1e9
    # the device records 5 ms behind the host's clock
    monkeypatch.setattr(host_spans, "device_timeline", lambda tr: (
        [(s - 5_000_000, e - 5_000_000, i) for i, (_, s, e) in
         enumerate(ops)], {i: s for i, (_, s, _) in enumerate(ops)}))
    seconds = (calls[-1].end_ns - calls[0].start_ns) / 1e9
    ctx = run.Context(unit="call", setup_s=1.0,
                      window=window.Window(seconds=seconds, units=3),
                      n_paths=128, N=4, points=0, counts={}, trace=tr)
    s = host_spans.split(ctx, "call")
    assert s.prep_ns == sum(q.end_ns - q.start_ns for q in prep)
    assert s.idle_ns.get("prepare", 0) == sum(q.end_ns - q.start_ns
                                              for q in prep[1:])
    gaps = sum(e - s for s, e in
               zip([o[2] for o in ops], [o[1] for o in ops[1:]]))
    assert sum(s.idle_ns.values()) == gaps
    assert _read("idle_prep_pct.call", ctx) + \
        _read("idle_caller_pct.call", ctx) <= _read("idle_pct.call", ctx)
