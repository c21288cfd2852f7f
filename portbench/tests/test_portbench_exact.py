"""The cell ``cli_em_cut4000`` (configuration ``nmch_cli_exact``, the
strict Poisson cut 4000) on the CPU: its files and metrics, a run at a
small size that comes out correct, and runs with the timed path broken
underneath, which have to come out not correct.

At N = 200 lambda is ~440 at v_0, so PTRS draws most steps, as it does at
the cell's own size."""

import pytest

from portbench import run, spec

CELL = "cli_em_cut4000"
SMALL = {"NTPB": 128, "NB": 2, "N": 200}
SEED = 2 ** 31 + 4321


def _run(seconds=0.2):
    return run.run_cell(spec.load_benchmark(), CELL, SEED, seconds, False,
                        device="cpu", sizes=SMALL)


def test_files_and_metrics_of_the_cell():
    bench = spec.load_benchmark()
    entry, config, traffic = spec.cell(bench, CELL)
    assert entry["chips"] == 1 and config["poisson_cut"] == 4000.0
    assert (traffic["kind"], traffic["method"]) == ("pricer_calls", "em")
    e2e = {m["name"] for m in spec.metrics_of(bench, CELL, False)}
    layer = {m["name"]: m for m in spec.metrics_of(bench, CELL, True)}
    assert {"setup_s", "call_ms", "call_ms_p95"} <= e2e
    assert {"k2_roofline", "k2_active_lanes", "prep_ms.call",
            "idle_pct.call"} <= set(layer)
    assert all(m["moves"] in e2e for m in layer.values())
    assert layer["k2_active_lanes"]["workloads"] == [CELL]


def test_cell_is_correct_and_reports_call_ms():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0
    assert {"setup_s", "call_ms", "call_ms_p95"} <= set(out["metrics"])
    check = out["checks"]["em.rel_gap"]
    assert check["value"] <= check["limit"]


def _half_batch(fn):
    def f(*a, **kw):
        kw["n_paths"] = kw["n_paths"] // 2
        return fn(*a, **kw)
    return f


def _altered(fn):
    def f(*a, **kw):
        m, m2 = fn(*a, **kw)[:2]
        return m * 1.1, m2
    return f


def _normal_branch(fn):
    """The shortcut the cell exists to leave: cut 128."""
    def f(*a, **kw):
        kw["poisson_cut"] = 128.0
        return fn(*a, **kw)
    return f


@pytest.mark.parametrize("fault", [_half_batch, _altered, _normal_branch])
def test_broken_path_is_not_correct(monkeypatch, fault):
    import nmch_tpu_torch.methods.em as mem
    monkeypatch.setattr(mem, "em_moments_cuda", fault(mem.em_moments_cuda))
    out = _run()
    assert out["correct"] is False
    check = out["checks"]["em.rel_gap"]
    assert check["value"] > check["limit"]
