"""The harness on the CPU: discovery by name, the result line, the window
arithmetic, the refusals, the frozen work counts, and runs with the timed
path broken underneath, which have to come out not correct.

Runs drive the program's plain versions (``device="cpu"``) at tiny sizes;
the card's own check is ``test_cell_on_the_card`` (marker ``cuda``)."""

import json
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

from portbench import check, guard, roofline, run, spec, trace, window
from portbench.reference.em import COUNTS

TINY = {"NTPB": 128, "NB": 2, "N": 4}
CELLS = ("cli_fe", "cli_em", "explore_batched", "explore_loop")
SEED = 2 ** 31 + 4321


def _run(cell, bench=None, seed=SEED, base=spec.HERE, seconds=0.2):
    bench = spec.load_benchmark() if bench is None else bench
    return run.run_cell(bench, cell, seed, seconds, False, device="cpu",
                        sizes=TINY, base=base)


# --- discovery -------------------------------------------------------------

def test_every_name_in_benchmark_json_has_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        entry, config, traffic = spec.cell(bench, w["name"])
        assert config["name"] == w["config"]
        assert "kind" in traffic and "limits" in traffic
        assert callable(spec.load("kinds", traffic["kind"]).make)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            d = json.load(f)
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        assert d["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_metrics_of_each_cell(cell):
    bench = spec.load_benchmark()
    e2e = {m["name"] for m in spec.metrics_of(bench, cell, False)}
    layer = {m["name"] for m in spec.metrics_of(bench, cell, True)}
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    unit = "call_ms" if cell.startswith("cli") else "point_ms"
    assert unit in e2e
    for m in spec.metrics_of(bench, cell, True):
        assert m["moves"] in e2e


# A kind that no file of the benchmark knows: each step prices the
# configuration's call twice, and a step counts two calls.
PAIRS_KIND = """
import torch

from portbench.kinds.pricer_calls import PricerCalls


class Pairs(PricerCalls):
    def step(self):
        super().step()
        super().step()
        self.steps[-2:] = [self.steps[-2] + self.steps[-1]]
        return 2

    def reference(self, idx, dtype=torch.float32):
        return super().reference([2 * i + j for i in idx for j in (0, 1)],
                                 dtype)


make = Pairs
"""


@pytest.mark.parametrize("new_kind", [False, True])
def test_a_cell_and_a_metric_added_as_files_only(tmp_path, new_kind):
    """A throwaway cell with its own traffic file (of a known kind, or of a
    kind of its own) and per-layer metric, added beside copies of the
    benchmark's files: no file is edited."""
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "kinds"):
        shutil.copytree(spec.HERE / sub, base / sub)
    kind = "pricer_calls"
    if new_kind:
        kind = "pricer_pairs"
        (base / "kinds" / f"{kind}.py").write_text(PAIRS_KIND)
    (base / "traffic" / "fe_calls_short.json").write_text(json.dumps(
        {"kind": kind, "method": "fe", "engine": "cuda",
         "warmup_steps": 1, "checked_steps": 2,
         "limits": {"fe.rel_gap": 1e-9}}))
    (base / "metrics" / "calls_done.py").write_text(
        "def read(ctx):\n    return float(ctx.window.units)\n")
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "cli_fe_short", "config": "nmch_cli",
                               "traffic": "fe_calls_short", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("call_ms"):
            m["workloads"].append("cli_fe_short")
    bench["per_layer"].append({"name": "calls_done", "unit": "calls",
                               "better": "higher", "source":
                               "program_counter", "layer": "harness",
                               "moves": "call_ms",
                               "workloads": ["cli_fe_short"]})
    out = _run("cli_fe_short", bench, base=base)
    assert out["correct"] and out["attempted"] >= 2
    assert out["checks"]["fe.rel_gap"]["value"] == 0.0
    assert {"setup_s", "call_ms", "call_ms_p95"} <= set(out["metrics"])
    if new_kind:
        assert out["attempted"] == 2 * out["harness"]["steps"]
    layer = spec.metrics_of(bench, "cli_fe_short", True)
    assert [m["name"] for m in layer] == ["calls_done"]
    win = window.Window(seconds=1.0, units=7)
    assert spec.reader("calls_done", base)(
        run.Context("call", 1.0, win, 1, 1, 0, {})) == 7.0


# --- the result line --------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_correct(cell):
    out = _run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


# --- window arithmetic -------------------------------------------------------

def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert window.percentile(vals, 95) == 95
    assert window.percentile(vals[::-1], 95) == 95
    assert window.percentile([3.0], 95) == 3.0
    assert window.percentile(list(range(1, 21)), 95) == 19


def test_window_rates_over_all_work(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(window.time, "perf_counter", lambda: next(ticks))
    w = window.run_window(lambda: 2, 3.0)
    # each step takes 0.25 s on this clock, and the window closes when a
    # step ends at or past 3 s
    assert w.seconds >= 3.0 and len(w.step_s) == w.units // 2
    assert w.ms_per_unit() == pytest.approx(1e3 * w.seconds / w.units)
    w2 = window.Window(seconds=2.0, units=1000,
                       step_s=[0.001] * 950 + [0.01] * 50)
    assert w2.ms_per_unit() == 2.0
    assert w2.step_ms_percentile(95) == pytest.approx(1.0)
    w2.step_s.append(0.01)
    assert w2.step_ms_percentile(95) == pytest.approx(10.0)


def test_metric_readers_on_a_synthetic_trace():
    tr = trace.DeviceTrace()
    # K1 200 us, a sum 10 us, a copy 5 us, per call; two calls, 300 us apart
    tr.ops = []
    for t0 in (0, 300_000):
        tr.ops += [("void nmch::fe_paths<1, 1, 0, false>(x)", t0, t0 + 200_000),
                   ("void nmch::sum_partials(double const*)", t0 + 210_000,
                    t0 + 220_000),
                   ("Memcpy DtoH (Device -> Pinned)", t0 + 240_000,
                    t0 + 245_000)]
    tr.busy_s = sum(e - s for s, e in trace.merged(tr.ops)) / 1e9
    win = window.Window(seconds=0.6e-3, units=2, step_s=[0.3e-3, 0.3e-3])
    ctx = run.Context(unit="call", setup_s=1.0, window=win,
                      n_paths=1024, N=1000, points=0,
                      counts={"fe": {}}, trace=tr)
    assert spec.reader("device_ops.call")(ctx) == 3.0
    assert spec.reader("device_ops.sweep")(ctx) is None
    assert spec.reader("idle_pct.call")(ctx) == pytest.approx(
        100 * (1 - 430e-6 / 0.6e-3))
    k1 = spec.reader("k1_roofline")(ctx)
    assert k1 == pytest.approx(100 * 2 * 1024 * roofline.fe_path_work(1000)
                               / roofline.PEAK_LANE_INSTR_PER_S / 400e-6)
    assert spec.reader("k2_roofline")(ctx) is None
    assert spec.reader("k3_roofline")(ctx) is None
    bd = trace.breakdown(tr.ops)
    assert bd["device_ops"][0][0].startswith("nmch::fe_paths")
    assert len(bd["idle_gaps"]) <= 10 and bd["idle_gaps"][0][1] > 0


# --- refusals ---------------------------------------------------------------

def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "cli_fe", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "nmch_tpu", "nmch_tpu.ops.fe", "nmch_tpu_torch",
             "nmch_tpu_torch.ops.fe", "jaxtyping", "nmch_tpuish", "torch"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "nmch_tpu",
        "nmch_tpu.ops.fe"]


def test_run_refuses_when_jax_is_loaded(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "nmch_tpu.fake", object())
    with pytest.raises(run.GuardError, match="nmch_tpu.fake"):
        _run("cli_fe")


def test_run_refuses_when_a_reader_loads_jax(tmp_path):
    """A metric's reader runs after the window; what it loads still
    keeps the result from being printed."""
    import sys
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "kinds"):
        shutil.copytree(spec.HERE / sub, base / sub)
    (base / "metrics" / "setup_s.py").write_text(
        "import sys\n\n\ndef read(ctx):\n"
        "    sys.modules['jax.planted'] = object()\n"
        "    return ctx.setup_s\n")
    try:
        with pytest.raises(run.GuardError, match="before the result.*"
                           "jax.planted"):
            _run("cli_fe", base=base)
    finally:
        sys.modules.pop("jax.planted", None)


# --- frozen work ------------------------------------------------------------

def test_work_counts_repeat_exactly():
    assert roofline.PHILOX_BLOCK == 39
    assert roofline.NORMAL_PAIR_HC == 50
    assert roofline.FE_BLOCK == 165
    assert roofline.fe_path_work(1000) == 82507
    assert roofline.fe_path_work(1001) == 82507 + 39 + 100 + 13
    assert (roofline.TURNS_NORMAL, roofline.ROUND_LARGE, roofline.ROUND_PTRS,
            roofline.ROUND_KNUTH, roofline.ROUND_GAMMA,
            roofline.EM_TERMINAL) == (36, 80, 99, 66, 100, 96)
    counts = dict.fromkeys(COUNTS, 0)
    counts.update(paths=2, steps_large=1000, steps_mid=700, steps_small=300,
                  rounds_large=1000, rounds_ptrs=800, rounds_knuth=500,
                  rounds_gamma=2200, boosts=10)
    assert roofline.em_work(counts, 1000) == (
        2 * 1000 * 12 + 1000 + 700 * 12 + 300 + 1000 * 80 + 800 * 99
        + 500 * 66 + 2200 * 100 + 10 * 6 + 2 * 96)
    assert roofline.PEAK_LANE_INSTR_PER_S == pytest.approx(33.45e12,
                                                           rel=1e-3)


def test_no_file_reads_sass_or_the_ports_counters():
    pattern = re.compile(r"cuobjdump|nvdisasm|\bsass\b|\.launches\b|"
                         r"variant_launches|EM_BLOCK_FLOOR|fe_loop_instr",
                         re.IGNORECASE)
    me = pathlib.Path(__file__).resolve()
    hits = [str(p) for p in spec.HERE.rglob("*")
            if p.is_file() and p.suffix in (".py", ".json")
            and p.resolve() != me and pattern.search(p.read_text())]
    assert hits == []


# --- the comparison ---------------------------------------------------------

def test_judge_and_gaps():
    prog = {"fe": [[1.0, 2.0], [1.5, 3.0]]}
    ref = {"fe": [[1.0, 2.0], [1.5, 3.0 * (1 + 1e-7)]]}
    g = check.gaps(prog, ref)
    assert g["fe.rel_gap"] == pytest.approx(1e-7, rel=1e-6)
    assert check.judge(g, {"fe.rel_gap": 1e-6})[0]
    assert not check.judge(g, {"fe.rel_gap": 1e-8})[0]
    assert not check.judge(g, {"em.rel_gap": 1.0})[0]
    assert not check.judge({"fe.rel_gap": float("nan")},
                           {"fe.rel_gap": 1.0})[0]
    assert check.failed_answers([[1.0, 2.0], [float("nan"), 1.0],
                                 [-1.0, 1.0]]) == 2


# --- runs with the timed path broken underneath -----------------------------

def _pricer_moments(monkeypatch, method, wrap):
    """Wrap the kernel wrapper a pricer calls (its plain version here)."""
    import nmch_tpu_torch.methods.em as mem
    import nmch_tpu_torch.methods.fe as mfe
    mod, name = (mfe, "fe_moments_cuda") if method == "fe" else \
        (mem, "em_moments_cuda")
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


def _sweep_moments(monkeypatch, method, wrap):
    import nmch_tpu_torch.explore as ex
    name = f"{method}_sweep_cuda"
    monkeypatch.setattr(ex, name, wrap(getattr(ex, name)))


def _patch(monkeypatch, cell, method, wrap):
    if cell.startswith("explore_batched"):
        _sweep_moments(monkeypatch, method, wrap)
    else:
        _pricer_moments(monkeypatch, method, wrap)


def _half_batch(fn):
    """Half of the paths left out, the mean taken over the rest."""
    def f(*a, **kw):
        kw["n_paths"] = kw["n_paths"] // 2
        return fn(*a, **kw)
    return f


def _altered(fn):
    """Each answer altered where it is produced (E[X] by a tenth, over
    every limit)."""
    def f(*a, **kw):
        m, m2 = fn(*a, **kw)[:2]
        return m * 1.1, m2
    return f


FAULT_CASES = [(c, m) for c in CELLS
               for m in (("fe",) if c == "cli_fe" else ("em",)
                         if c == "cli_em" else ("fe", "em"))]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell,method", FAULT_CASES)
def test_broken_path_is_not_correct(monkeypatch, fault, cell, method):
    wrap = {"half_batch": _half_batch, "altered": _altered}[fault]
    _patch(monkeypatch, cell, method, wrap)
    out = _run(cell)
    assert out["correct"] is False
    assert out["checks"][f"{method}.rel_gap"]["value"] > \
        out["checks"][f"{method}.rel_gap"]["limit"]


@pytest.mark.parametrize("cell", ["cli_fe", "cli_em", "explore_loop"])
def test_state_left_unchanged_is_not_correct(monkeypatch, cell):
    """The streams' state unchanged by a call: every call redraws the same
    epoch."""
    from nmch_tpu_torch.rng.streams import PathStreams
    monkeypatch.setattr(PathStreams, "next_epoch", lambda self: self.epoch)
    assert _run(cell)["correct"] is False


def test_batched_key_unchanged_is_not_correct(monkeypatch):
    """Every pass of the batched sweep priced under the first pass's key."""
    import nmch_tpu_torch.explore as ex
    orig = ex.batched_moments
    monkeypatch.setattr(ex, "batched_moments",
                        lambda cfg, seed, *a: orig(cfg, 0, *a))
    assert _run("explore_batched")["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The control: the reference with its path state in bfloat16, put in
    the program's place, fails a number of the cell at a small size."""
    bench = spec.load_benchmark()
    entry, config, traffic = spec.cell(bench, cell)
    from portbench import workloads
    wl = workloads.make(dict(config, NTPB=128, NB=2, N=16), traffic, SEED,
                        "cpu")
    wl.warm_up()
    for _ in range(traffic["checked_steps"]):
        wl.step()
    idx = list(range(traffic["checked_steps"]))
    ref, _ = wl.reference(idx)
    ctl, _ = wl.reference(idx, torch.bfloat16)
    correct, checks = check.judge(check.gaps(ctl, ref), traffic["limits"])
    assert not correct, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    bench = spec.load_benchmark()
    out = run.run_cell(bench, cell, SEED, 1.0, False, device=card)
    assert out["correct"], out["checks"]
