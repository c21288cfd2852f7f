"""The cell ``cli_qmc`` (configuration ``nmch_cli_qmc``, the CLI's
``--engine qmc``) on the CPU: its files and metrics, a run at a small size
that comes out correct, and runs with the point set broken underneath,
which have to come out not correct."""

import pytest

from portbench import run, spec

CELL = "cli_qmc"
SMALL = {"NTPB": 128, "NB": 16, "N": 33}
SEED = 2 ** 31 + 4321


def _run(seconds=0.2):
    return run.run_cell(spec.load_benchmark(), CELL, SEED, seconds, False,
                        device="cpu", sizes=SMALL)


def test_files_and_metrics_of_the_cell():
    bench = spec.load_benchmark()
    entry, config, traffic = spec.cell(bench, CELL)
    assert entry["chips"] == 1 and config["reduced"] == []
    assert (config["scramble"], config["n_shifts"]) == ("lms-shift", 8)
    assert (traffic["kind"], traffic["engine"]) == ("qmc_calls", "qmc")
    assert set(traffic["limits"]) == {"qmc_price.rel_gap",
                                      "qmc_ci.rel_gap"}
    e2e = {m["name"] for m in spec.metrics_of(bench, CELL, False)}
    layer = {m["name"]: m for m in spec.metrics_of(bench, CELL, True)}
    assert e2e == {"setup_s", "call_ms", "call_ms_p95"}
    assert set(layer) == {
        "device_ops.call", "idle_pct.call", "prep_ms.call",
        "idle_prep_pct.call", "idle_caller_pct.call", "k6_roofline",
        "qmc_call_roofline", "qmc_points_ms.call", "qmc_bridge_ms.call"}
    assert all(m["moves"] == "call_ms" for m in layer.values())
    for name in layer:
        assert callable(spec.reader(name))


def test_cell_is_correct_and_reports_call_ms():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "call_ms", "call_ms_p95"}
    assert len(out["checks"]) == 2
    for check in out["checks"].values():
        assert check["value"] <= check["limit"]


def _shift_dropped(fn):
    """Dimension 0 (factor 0's terminal node) keeps its words unshifted."""
    def f(*a, **kw):
        out = fn(*a, **kw).clone()
        out[0] = 0
        return out
    return f


def _factor_negated(fn):
    """Factor 0's normals negated."""
    def f(*a, **kw):
        z1, z2 = fn(*a, **kw)
        return -z1, z2
    return f


@pytest.mark.parametrize("name,fault", [
    ("digital_shifts", _shift_dropped),
    ("qmc_normals_mxu", _factor_negated)])
def test_broken_point_set_is_not_correct(monkeypatch, name, fault):
    import nmch_tpu_torch.ops.fe_qmc as fe_qmc
    monkeypatch.setattr(fe_qmc, name, fault(getattr(fe_qmc, name)))
    out = _run()
    assert out["correct"] is False
    check = out["checks"]["qmc_price.rel_gap"]
    assert check["value"] > check["limit"]
