"""Host spans of the port (``nmch_tpu_torch/utils/timing.py::span``): they
record only inside a torch profiler's window, nest as the call path does
(``compute`` > ``prepare`` > ``prepare.*``), share a request number per
top-level call, and lie on the clock of the trace's host-side records
(marker ``cuda``).

The card's cases import neither jax nor nmch_tpu:

    python -m pytest tests/test_torch_spans.py -m cuda -q -s --noconftest
"""

import contextlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nmch_tpu_torch import HestonParams, NMCH_EM, NMCH_FE, SimConfig
from nmch_tpu_torch import explore
from nmch_tpu_torch.ops import launch
from nmch_tpu_torch.utils import timing
from nmch_tpu_torch.utils.timing import span, spans, spans_dropped

TINY = SimConfig(NTPB=128, NB=1, N=4)


def _pricer(cls, device="cpu", cfg=TINY):
    p = cls(cfg, HestonParams(), device=device)
    p.init(1234)
    return p


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(records, n0):
    """(name, parent's name or None, request) of the records from n0 on."""
    return [(r.name, None if r.parent < 0 else records[r.parent].name,
             r.request) for r in records[n0:]]


def _check_nested(records, n0):
    for r in records[n0:]:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert p.request == r.request
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        else:
            assert r.parent == -1


def test_nothing_recorded_without_a_profiler():
    n0 = len(spans())
    _pricer(NMCH_FE).compute()
    s = span("compute")
    with s:
        pass
    assert len(spans()) == n0
    assert s is span("prepare") is span("prepare.enqueue")
    assert not isinstance(s, timing.SpanRecord)


@pytest.mark.parametrize("cls", [NMCH_FE, NMCH_EM])
def test_compute_spans_under_a_cpu_profile(cls):
    p = _pricer(cls)
    n0 = len(spans())
    with _cpu_profile():
        p.compute()
        p.compute()
    rec = spans()
    tree = _tree(rec, n0)
    assert [(n, par) for n, par, _ in tree] == [
        ("compute", None), ("prepare", "compute")] * 2
    assert tree[0][2] == tree[1][2] != tree[2][2] == tree[3][2]
    assert rec[n0 + 1].parent == n0 and rec[n0 + 3].parent == n0 + 2
    _check_nested(rec, n0)


def _qmc_pricer(device="cpu", cfg=TINY):
    p = NMCH_FE(cfg, HestonParams(), engine="qmc", device=device)
    p.init(1234)
    return p


def test_qmc_compute_spans_under_a_cpu_profile(monkeypatch):
    """A QMC ``compute()`` records ``prepare.points`` and then
    ``prepare.bridge`` inside ``prepare``; K6's wrapper is called in
    ``prepare`` after both have closed (on a card its ``prepare.enqueue``
    opens there); the records carry no counts (a reader takes the points
    a call draws from n_paths)."""
    import nmch_tpu_torch.ops.fe_qmc_cuda as fe_qmc_cuda
    open_at_k6 = []

    def k6(*args, **kw):
        open_at_k6.append(timing._recorder.records[
            timing._recorder.open].name)
        return fe_qmc_cuda.qmc_payoff_sums_plain(*args, **kw)

    monkeypatch.setattr(fe_qmc_cuda, "qmc_payoff_sums_cuda", k6)
    p = _qmc_pricer()
    n0 = len(spans())
    with _cpu_profile():
        p.compute()
        p.compute()
    rec = spans()
    tree = _tree(rec, n0)
    assert [(n, par) for n, par, _ in tree] == [
        ("compute", None), ("prepare", "compute"),
        ("prepare.points", "prepare"), ("prepare.bridge", "prepare")] * 2
    assert open_at_k6 == ["prepare"] * 2
    assert [r.counts for r in rec[n0:]] == [{}] * 8
    _check_nested(rec, n0)


def test_qmc_spans_change_no_answer():
    """The same seed gives the same prices and CIs with the profiler on
    and off, and off it records nothing."""
    p, q = _qmc_pricer(), _qmc_pricer()
    n0 = len(spans())
    off = [(r.price, r.ci_error) for r in (p.compute() for _ in range(2))]
    assert len(spans()) == n0
    with _cpu_profile():
        on = [(r.price, r.ci_error) for r in (q.compute() for _ in range(2))]
    assert on == off and len(spans()) == n0 + 8


def test_batched_moments_spans_under_a_cpu_profile():
    n0 = len(spans())
    with _cpu_profile():
        m, m2 = explore.batched_moments(TINY, 5, "fe", "cuda", "philox",
                                        False, torch.device("cpu"))
    assert m.shape == (len(explore.grid_points()),)
    rec = spans()
    tree = _tree(rec, n0)
    assert [(n, par) for n, par, _ in tree] == [
        ("prepare", None), ("prepare.grid", "prepare")]
    assert tree[0][2] == tree[1][2]
    _check_nested(rec, n0)


def test_enqueue_span_inside_its_caller(monkeypatch):
    """``call_kernel``'s span, with the library and the stream faked: the
    CPU has neither."""
    calls = []

    class Lib:
        def nmch_fake(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(launch, "load_library", lambda: (Lib(), None))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    n0 = len(spans())
    with _cpu_profile():
        with span("prepare"):
            launch.call_kernel("nmch_fake", "fake", "cuda", 1, 2)
        launch.call_kernel("nmch_fake", "fake", "cuda", 3)
    assert calls == [(1, 2, 7), (3, 7)]
    rec = spans()
    tree = _tree(rec, n0)
    assert [(n, par) for n, par, _ in tree] == [
        ("prepare", None), ("prepare.enqueue", "prepare"),
        ("prepare.enqueue", None)]
    assert tree[0][2] == tree[1][2] != tree[2][2]
    _check_nested(rec, n0)


def test_spans_stop_with_the_profile_and_close_after_it():
    p = _pricer(NMCH_FE)
    n0 = len(spans())
    with _cpu_profile():
        outer = span("compute").__enter__()
    with span("prepare"):
        pass
    outer.__exit__(None, None, None)
    p.compute()
    rec = spans()
    assert [r.name for r in rec[n0:]] == ["compute"]
    _check_nested(rec, n0)
    assert timing._recorder.open == -1


def test_a_span_that_raises_closes_and_restores_its_parent():
    n0 = len(spans())
    with _cpu_profile():
        with span("compute"):
            with pytest.raises(ValueError):
                with span("prepare"):
                    raise ValueError("x")
            with span("prepare.enqueue"):
                pass
    tree = _tree(spans(), n0)
    assert [(n, par) for n, par, _ in tree] == [
        ("compute", None), ("prepare", "compute"),
        ("prepare.enqueue", "compute")]
    _check_nested(spans(), n0)


def test_the_buffer_drops_past_its_bound(monkeypatch):
    monkeypatch.setattr(timing, "_recorder", timing._Recorder())
    monkeypatch.setattr(timing, "SPAN_LIMIT", 3)
    with _cpu_profile():
        for _ in range(5):
            with span("compute"):
                pass
    assert len(spans()) == 3 and spans_dropped() == 2
    assert [r.request for r in spans()] == [1, 2, 3]


# --- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the spans' clock is checked "
                    "against the card's trace)")
    return torch.device("cuda", 0)


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()
                                              * 1000)


def _records(prof, pattern):
    """(device records whose name holds ``pattern``, as (start, end,
    correlation id) sorted by start; {correlation id: (start, end)} of the
    host-side records)."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, host = [], {}
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        if ev.device_type() == cuda:
            if pattern in ev.name():
                ops.append((s, e, ev.correlation_id()))
        elif ev.correlation_id():
            host[ev.correlation_id()] = (s, e)
    return sorted(ops), host


@pytest.mark.cuda
def test_kernels_lie_inside_their_calls_spans(dev):
    """20 traced ``NMCH_FE.compute()`` calls at the CLI's size, the trace
    of the card alone, as the benchmark takes it.  The spans share the
    clock of the trace's host-side records: each ``fe_paths``'s launch
    record lies inside its call's ``prepare.enqueue``, and the kernel, put
    at its launch, ends inside its call's ``compute``.  The device records
    themselves are on a clock whose offset wanders (milliseconds over a
    20 s window on an H100), so the raw offset is printed, not held."""
    p = _pricer(NMCH_FE, dev, SimConfig())
    for _ in range(3):
        p.compute()
    torch.cuda.synchronize()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            p.compute()
        torch.cuda.synchronize()
    rec = spans()[n0:]
    ops, host = _records(prof, "fe_paths")
    calls = [r for r in rec if r.name == "compute"]
    enq = [r for r in rec if r.name == "prepare.enqueue"]
    assert len(calls) == len(enq) == 20
    # a fresh trace may lose its first activity records: pair from the end
    assert 18 <= len(ops) <= 20
    raw = []
    for (s, e, corr), c, q in zip(ops[::-1], calls[::-1], enq[::-1]):
        ls, le = host[corr]
        assert q.start_ns <= ls <= le <= q.end_ns
        assert ls + (e - s) <= c.end_ns
        raw.append(max(c.start_ns - s, e - c.end_ns, q.start_ns - s))
    print(f"raw device records: worst offset {max(raw)} ns (negative: "
          f"every kernel inside its spans)")


@pytest.mark.cuda
def test_em_and_sweep_spans_on_the_card(dev):
    cfg = SimConfig(NTPB=128, NB=40, N=100)
    p = _pricer(NMCH_EM, dev, cfg)
    p.compute()
    explore.batched_moments(cfg, 3, "em", "cuda", "philox", False, dev)
    torch.cuda.synchronize()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CUDA]):
        p.compute()
        mo = explore.batched_moments(cfg, 3, "em", "cuda", "philox", False,
                                     dev)
        torch.stack(mo).tolist()
        mo = explore.batched_moments(cfg, 3, "fe", "cuda", "philox", False,
                                     dev)
        torch.stack(mo).tolist()
    rec = spans()
    assert [(n, par) for n, par, _ in _tree(rec, n0)] == [
        ("compute", None), ("prepare", "compute"),
        ("prepare.consts", "prepare"), ("prepare.enqueue", "prepare"),
        ("prepare", None), ("prepare.grid", "prepare"),
        ("prepare.consts", "prepare"), ("prepare.dispatch", "prepare"),
        ("prepare.copy_in", "prepare"), ("prepare.enqueue", "prepare"),
        ("prepare", None), ("prepare.grid", "prepare"),
        ("prepare.copy_in", "prepare"), ("prepare.enqueue", "prepare")]
    _check_nested(rec, n0)


@pytest.mark.cuda
def test_qmc_ops_lie_under_their_spans_on_the_card(dev):
    """Traced QMC calls at 8,192 paths x N = 100, the ops placed at their
    launch records under the innermost span (``portbench/span_ops.py``):
    K6 ``qmc_sim_paths`` and its second pass ``sum_partials`` alone,
    once each a call, under ``prepare.enqueue``;
    the two bridge products (matrix-multiply kernels) and the upload of
    the bridge matrix under ``prepare.bridge``; under ``prepare.points``
    the words, scrambles and normals, with no product and no K6."""
    from portbench import span_ops
    cfg = SimConfig(NTPB=128, NB=64, N=100)
    p = _qmc_pricer(dev, cfg)
    p.compute()
    torch.cuda.synchronize()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            p.compute()
        torch.cuda.synchronize()
    rec = spans()[n0:]
    cuda = torch.autograd.DeviceType.CUDA
    ops, names, launches = [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        if ev.device_type() == cuda:
            ops.append((s, s + _ns(ev, "duration"), ev.correlation_id()))
            names[ev.correlation_id()] = ev.name()
        elif ev.correlation_id():
            launches[ev.correlation_id()] = s
    ops.sort()
    by_span = {}
    for (_, _, corr), i in span_ops.innermost(ops, launches, rec):
        by_span.setdefault(rec[i].name if i >= 0 else None,
                           []).append(names[corr])
    print({k: sorted(set(v)) for k, v in by_span.items()})
    enq = by_span["prepare.enqueue"]
    assert len(enq) == 6
    assert sum("qmc_sim_paths" in n for n in enq) == 3
    assert sum("sum_partials" in n for n in enq) == 3
    for name, got in by_span.items():
        if name != "prepare.enqueue":
            assert not any("qmc_sim_paths" in n for n in got), name
    gemm = [n for n in by_span["prepare.bridge"] if "gemm" in n.lower()]
    assert len(gemm) >= 6, by_span["prepare.bridge"]
    assert any("HtoD" in n for n in by_span["prepare.bridge"])
    assert len(by_span["prepare.points"]) >= 3 * 20
    assert not any("gemm" in n.lower() for n in by_span["prepare.points"])
