"""The benchmark's readers of the QMC engine's spans and kernel
(``portbench/span_ops.py``; ``metrics/qmc_points_ms.call.py``,
``qmc_bridge_ms.call.py``, ``qmc_call_roofline.py``, ``k6_roofline.py``)
on synthetic device operations, launch records and span records, and the
frozen counts they price (``portbench/roofline_qmc.py``)."""

import types

import pytest

from portbench import host_spans, roofline, roofline_qmc, run, span_ops, \
    spec, trace, window

US = 1000       # ns
POINTS = 128    # n_paths: the Sobol' points a call draws


def _rec(name, start, end, parent):
    return types.SimpleNamespace(name=name, start_ns=start * US,
                                 end_ns=None if end is None else end * US,
                                 parent=parent)


def _call(t0, i0):
    """One call's records from t0 us, the first at index i0: compute >
    prepare > (points, bridge, enqueue)."""
    return [_rec("compute", t0, t0 + 1000, -1),
            _rec("prepare", t0 + 10, t0 + 900, i0),
            _rec("prepare.points", t0 + 20, t0 + 300, i0 + 1),
            _rec("prepare.bridge", t0 + 300, t0 + 600, i0 + 1),
            _rec("prepare.enqueue", t0 + 700, t0 + 720, i0 + 1)]


RECORDS = _call(0, 0) + _call(2000, 5)

# (name, launch us or None, device start us, device end us) of each call:
# two point ops (the second launched as points closes and bridge opens),
# a bridge product and an upload, K6, the copy back in compute alone; and
# one op of the caller's and one without a launch record
OPS = []
for t0 in (0, 2000):
    OPS += [("ndtri", t0 + 30, t0 + 40, t0 + 140),
            ("xor", t0 + 300, t0 + 310, t0 + 330),
            ("sgemm", t0 + 310, t0 + 330, t0 + 530),
            ("Memcpy HtoD", t0 + 320, t0 + 530, t0 + 531),
            ("nmch::qmc_sim_paths", t0 + 705, t0 + 710, t0 + 810),
            ("Memcpy DtoH", t0 + 950, t0 + 955, t0 + 957)]
OPS += [("caller", 1500, 1500, 1510), ("lost", None, 1600, 1700)]


def _timeline(ops):
    dev = sorted((s * US, e * US, i + 1) for i, (_, _, s, e) in
                 enumerate(ops))
    return dev, {i + 1: t * US for i, (_, t, _, _) in enumerate(ops)
                 if t is not None}


def _ctx(ops=OPS, units=2, N=1000, n_paths=POINTS, traced=True):
    tr = trace.DeviceTrace()
    tr.ops = sorted((n, s * US, e * US) for n, _, s, e in ops)
    tr.timeline = _timeline(ops)
    win = window.Window(seconds=4e-3, units=units)
    return run.Context(unit="call", setup_s=1.0, window=win,
                       n_paths=n_paths, N=N, points=0, counts={},
                       trace=tr if traced else None)


@pytest.fixture
def recorded(monkeypatch):
    def use(records):
        monkeypatch.setattr(host_spans, "program_spans", lambda: records)
    monkeypatch.setattr(host_spans, "device_timeline",
                        lambda tr: getattr(tr, "timeline", None))
    use(RECORDS)
    return use


def _read(name, ctx):
    return spec.reader(name)(ctx)


def test_each_op_falls_under_the_innermost_span_at_its_launch():
    dev, launches = _timeline(OPS)
    got = [(OPS[corr - 1][0], RECORDS[i].name if i >= 0 else None)
           for (_, _, corr), i in span_ops.innermost(dev, launches,
                                                     RECORDS)]
    call = [("ndtri", "prepare.points"), ("xor", "prepare.bridge"),
            ("sgemm", "prepare.bridge"), ("Memcpy HtoD", "prepare.bridge"),
            ("nmch::qmc_sim_paths", "prepare.enqueue"),
            ("Memcpy DtoH", "compute")]
    assert got == call + [("caller", None)] + call


def test_ties_and_open_spans():
    """A launch at a span's start or end lies in it; a span that never
    closed is left out; so is an op without a launch record."""
    records = [_rec("compute", 0, 100, -1), _rec("prepare", 10, 20, 0),
               _rec("compute", 200, None, -1)]
    ops = [(0, 1, 1), (0, 1, 2), (0, 1, 3), (0, 1, 4), (0, 1, 5)]
    launches = {1: 10 * US, 2: 20 * US, 3: 100 * US, 4: 250 * US}
    got = [(c, i) for (_, _, c), i in span_ops.innermost(ops, launches,
                                                         records)]
    assert got == [(1, 1), (2, 1), (3, 0), (4, -1)]
    assert span_ops.under(records, 1, "compute")
    assert not span_ops.under(records, 0, "prepare")
    assert not span_ops.under(records, -1, "compute")


def test_points_and_bridge_ms_a_call(recorded):
    """The summed device time of the ops under each span, over the calls:
    points 100 us a call; bridge 20 + 200 + 1 us a call."""
    ctx = _ctx()
    assert _read("qmc_points_ms.call", ctx) == pytest.approx(0.100)
    assert _read("qmc_bridge_ms.call", ctx) == pytest.approx(0.221)


WANT_CALL_ROOFLINE = 100 * 2 * POINTS * roofline_qmc.point_work(1000) \
    / roofline.PEAK_LANE_INSTR_PER_S / (2 * 423e-6)


def test_call_roofline_prices_n_paths_points_a_call(recorded):
    """n_paths points a compute record at the frozen work a point, over
    the device time of every op launched inside those calls (each call
    100 + 20 + 200 + 1 + 100 + 2 us; the caller's and the lost op left
    out); a compute record under which no op was launched adds no
    points."""
    assert _read("qmc_call_roofline", _ctx()) == pytest.approx(
        WANT_CALL_ROOFLINE, rel=1e-12)
    recorded(RECORDS + [_rec("compute", 3000, 3100, -1)])
    assert _read("qmc_call_roofline", _ctx()) == pytest.approx(
        WANT_CALL_ROOFLINE, rel=1e-12)


def test_readers_without_spans(recorded):
    """None untraced and without records; where no record carries the
    point and bridge spans (the program before it recorded them: compute
    and prepare alone) those two give nothing and the call's roofline
    still reads its compute spans; no reader raises."""
    names = ("qmc_points_ms.call", "qmc_bridge_ms.call", "qmc_call_roofline")
    for name in names:
        assert _read(name, _ctx(traced=False)) is None
    recorded(None)
    for name in names:
        assert _read(name, _ctx()) is None
    recorded([_rec("compute", t0, t0 + 1000, -1)
              if k == 0 else _rec("prepare", t0 + 10, t0 + 900, i)
              for i, t0 in ((0, 0), (2, 2000)) for k in (0, 1)])
    assert _read("qmc_points_ms.call", _ctx()) is None
    assert _read("qmc_bridge_ms.call", _ctx()) is None
    assert _read("qmc_call_roofline", _ctx()) == pytest.approx(
        WANT_CALL_ROOFLINE, rel=1e-12)


def _k6_split(parts):
    """OPS with each call's 100 us K6 launch split into ``parts``
    launches, as the engine's point chunks split a call's paths."""
    out = []
    for name, t, s, e in OPS:
        if "qmc_sim" not in name:
            out.append((name, t, s, e))
            continue
        w = (e - s) / parts
        out += [(name, t, s + j * w, s + (j + 1) * w) for j in range(parts)]
    return out


@pytest.mark.parametrize("parts", [1, 4])
def test_k6_roofline_reads_its_bytes(parts):
    """K6 by name: 8 N M bytes a call at 3.35 TB/s over its 2 x 100 us,
    whether a call launches it once or in ``parts``; nothing where no
    launch of it was traced."""
    ctx = _ctx(ops=_k6_split(parts), N=1000, n_paths=1 << 18)
    want = 100 * 2 * 8 * 1000 * (1 << 18) / 3.35e12 / 200e-6
    assert _read("k6_roofline", ctx) == pytest.approx(want, rel=1e-12)
    assert _read("k6_roofline", _ctx(
        ops=[o for o in OPS if "qmc_sim" not in o[0]])) is None
    assert _read("k6_roofline", _ctx(traced=False)) is None


@pytest.mark.parametrize("N,want", [(1, 1), (2, 5), (4, 15), (16, 83)])
def test_bridge_work_by_hand(N, want):
    """The terminal node 1; midpoints 5, or 3 against W_0; N - 1
    increments: N = 4 has nodes 2 (a = 0), 1 (a = 0) and 3 (a = 2)."""
    assert roofline_qmc.bridge_work(N) == want


def test_point_work_at_the_cells_size():
    """2N dimensions of a word, the map and the inverse CDF (26 each), the
    two bridges, N Euler steps and the payoff: ~7.7e4 a point, ~0.6 ms
    for 2^18 points at the peak."""
    w = roofline_qmc.point_work(1000)
    assert w == 1 + 2000 * 26 + 2 * roofline_qmc.bridge_work(1000) \
        + 1000 * roofline.EULER_STEP + roofline.PAYOFF_AND_SUMS
    assert 0.55e-3 < (1 << 18) * w / roofline.PEAK_LANE_INSTR_PER_S < 0.65e-3
