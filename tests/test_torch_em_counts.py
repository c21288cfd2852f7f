"""K2's counts of its work (``csrc/em.cu``: the counter blocks its lanes
drew and, on its round schedule, the block draws its warps executed), how a
traced ``compute()`` records them (``SpanRecord.counts``), and the
benchmark's reader of them (``portbench/metrics/k2_active_lanes.py``).

The card's cases (marker ``cuda``) hold K2's counts to the emulation of
its schedules (``ops/em_schedule.py::emulate``, run on the card, so that
its float32 functions are the kernel's) and import neither jax nor
nmch_tpu:

    python -m pytest tests/test_torch_em_counts.py -m cuda -q --noconftest
"""

import math
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nmch_tpu_torch.methods.em as methods_em
from nmch_tpu_torch import HestonParams, NMCH_EM, SimConfig
from nmch_tpu_torch.ops.em import em_consts, em_consts_table
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda, em_round_schedule
from nmch_tpu_torch.ops.em_schedule import WARP, emulate
from nmch_tpu_torch.rng.philox import split_seed
from nmch_tpu_torch.utils.timing import spans
from portbench import host_spans, run, spec, window

TINY = SimConfig(NTPB=128, NB=1, N=4)
COUNTS = (4096.0, 160.0)       # blocks drawn, warp draws: 80% active


def _counting(fn, counts_=COUNTS):
    """em_moments_cuda whose vector carries K2's two counts, as on a
    card (the plain version here has no warps to count)."""
    def f(*a, counts=False, **kw):
        out = fn(*a, counts=counts, **kw)
        if not counts:
            return out
        return torch.cat([out, torch.tensor(counts_, dtype=torch.float64)])
    return f


@pytest.fixture
def counting(monkeypatch):
    monkeypatch.setattr(methods_em, "em_moments_cuda",
                        _counting(em_moments_cuda))


def _pricer():
    p = NMCH_EM(TINY, HestonParams(), device="cpu")
    p.init(1234)
    return p


def test_compute_record_carries_the_counts_while_profiling(counting):
    """Under a profiler the ``compute`` record carries K2's counts and its
    ``prepare`` record none; the price is the same as unrecorded."""
    p = _pricer()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CPU]):
        traced = p.compute()
    rec = spans()[n0:]
    assert [r.name for r in rec] == ["compute", "prepare"]
    assert rec[0].counts == {"k2.blocks": 4096, "k2.warp_iters": 160}
    assert all(type(v) is int for v in rec[0].counts.values())
    assert rec[1].counts == {}
    q = _pricer()
    assert q.compute().price == traced.price


def test_nothing_recorded_when_off(counting):
    """Off, a call records nothing, counts included."""
    n0 = len(spans())
    r = _pricer().compute()
    assert len(spans()) == n0 and r.price > 0


def test_draws_of_the_step_loops_are_left_out(monkeypatch):
    """A launch on the step loops counts its blocks but not its warps'
    draws (NaN): the record carries the blocks alone, and the reader reads
    nothing from it."""
    monkeypatch.setattr(methods_em, "em_moments_cuda", _counting(
        em_moments_cuda, (4096.0, float("nan"))))
    p = _pricer()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CPU]):
        p.compute()
    assert spans()[n0].counts == {"k2.blocks": 4096}
    assert _read(monkeypatch, spans()[n0:]) is None


def test_plain_version_records_no_counts():
    """On the CPU the plain version returns the moments alone: the record
    carries no counts."""
    p = _pricer()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CPU]):
        p.compute()
    assert spans()[n0].name == "compute" and spans()[n0].counts == {}


def _ctx(trace=True):
    win = window.Window(seconds=1.0, units=2, step_s=[0.5, 0.5])
    return run.Context(unit="call", setup_s=1.0, window=win, n_paths=128,
                       N=4, points=0, counts={},
                       trace=object() if trace else None)


def _read(monkeypatch, records):
    monkeypatch.setattr(host_spans, "program_spans", lambda: records)
    return spec.reader("k2_active_lanes")(_ctx())


def test_reader_gives_the_share_of_the_counts(monkeypatch):
    """100 x the blocks over 32 x the warp draws, summed over the compute
    records that carry counts; other records are left out."""
    rec = [types.SimpleNamespace(name="compute", counts={
               "k2.blocks": 4096, "k2.warp_iters": 160}),
           types.SimpleNamespace(name="prepare", counts={}),
           types.SimpleNamespace(name="compute", counts={
               "k2.blocks": 1000, "k2.warp_iters": 40}),
           types.SimpleNamespace(name="compute", counts={})]
    assert _read(monkeypatch, rec) == pytest.approx(
        100.0 * 5096 / (WARP * 200), rel=1e-15)


def test_reader_reads_the_programs_records(monkeypatch, counting):
    """The share from records of real traced calls."""
    p = _pricer()
    n0 = len(spans())
    with profile(activities=[ProfilerActivity.CPU]):
        p.compute()
        p.compute()
    assert _read(monkeypatch, spans()[n0:]) == pytest.approx(80.0)


def test_reader_gives_nothing_without_counts(monkeypatch):
    """None without records, where the program's records have no counts
    field (as at the parent commit), where none carries K2's counts, and
    in an untraced run."""
    assert _read(monkeypatch, None) is None
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, [types.SimpleNamespace(name="compute")]) \
        is None
    assert _read(monkeypatch, [types.SimpleNamespace(
        name="compute", counts={})]) is None
    monkeypatch.setattr(host_spans, "program_spans", lambda: [
        types.SimpleNamespace(name="compute", counts={
            "k2.blocks": 1, "k2.warp_iters": 1})])
    assert spec.reader("k2_active_lanes")(_ctx(trace=False)) is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", False),
                                             ("philox", True)])
@pytest.mark.parametrize("cut", [128.0, 4000.0])
def test_kernel_counts_are_the_emulations(dev, rng, conditional, cut):
    """At 1,024 paths (32 warps) and N = 1000, K2's blocks are the sum of
    its per-path counters, which equal the emulation's path for path (on
    the schedule K2 ran, em_round_schedule: the step loops at cut 128, the
    round schedule at cut 4000); on the round schedule its warp draws equal
    the emulation's exactly, and the step loops give NaN for them."""
    N, n_paths, epoch = 1000, 1024, 1
    key = split_seed(1234)
    pv = HestonParams().as_tensor("cpu")
    vec, _, ctr = em_moments_cuda(pv, key, epoch, 0, N=N, n_paths=n_paths,
                                  device=dev, rng=rng,
                                  conditional=conditional, poisson_cut=cut,
                                  per_path=True, counts=True)
    m, m2, blocks, warp_draws = vec.tolist()
    assert [m, m2] == torch.stack(em_moments_cuda(
        pv, key, epoch, 0, N=N, n_paths=n_paths, device=dev, rng=rng,
        conditional=conditional, poisson_cut=cut)).tolist()
    assert blocks == ctr.sum().item()
    rounds = bool(em_round_schedule(em_consts_table(pv[None], N, cut), N))
    assert rounds == (cut == 4000.0)
    _, e_ctr, e_iters, _ = emulate(em_consts(pv, N, cut), N,
                                   torch.arange(n_paths, device=dev), epoch,
                                   *key, rng, conditional, rounds)
    assert torch.equal(e_ctr.cpu(), ctr.flatten().cpu())
    assert blocks == e_ctr.sum().item()
    if rounds:
        assert warp_draws == e_iters.sum().item()
    else:
        assert math.isnan(warp_draws)
