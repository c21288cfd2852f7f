"""CLI of the PyTorch port against nmch_tpu's (FE and EM), and the no-jax
import rule."""

import json
import subprocess
import sys

import pytest
import torch

from nmch_tpu.cli import run as jax_cli_run
from nmch_tpu_torch import NMCH_EM, cli
from nmch_tpu_torch.cli import build_parser, run as cli_run

torch.set_num_threads(2)

SMALL = ["--NTPB", "256", "--NB", "4", "--N", "30", "--seed", "11"]
SMALL_EM = ["--NTPB", "256", "--NB", "4", "--N", "16", "--seed", "11"]


def _json_run(fn, argv, capsys) -> dict:
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_json_matches_nmch_tpu_scan(capsys):
    got = _json_run(cli_run, ["--json", "--engine", "scan",
                              "--device", "cpu", *SMALL], capsys)
    want = _json_run(jax_cli_run, ["--json", "--engine", "scan", *SMALL],
                     capsys)
    assert set(got) == set(want)
    assert got["engine"] == "scan" and got["n_paths"] == 1024
    assert abs(got["price"] - want["price"]) <= 1e-5 * abs(want["price"])


def test_threefry4_json_matches_nmch_tpu_scan(capsys):
    argv = ["--json", "--engine", "scan", "--rng", "threefry4", *SMALL]
    got = _json_run(cli_run, [*argv, "--device", "cpu"], capsys)
    want = _json_run(jax_cli_run, argv, capsys)
    assert abs(got["price"] - want["price"]) <= 1e-5 * abs(want["price"])
    philox = _json_run(cli_run, ["--json", "--engine", "scan", "--device",
                                 "cpu", *SMALL], capsys)
    assert got["price"] != philox["price"]


@pytest.mark.parametrize("extra", [["--rot", "4"], ["--antithetic"],
                                   ["--rng", "threefry"]])
def test_fe_variants_json_match_nmch_tpu_scan(extra, capsys):
    """--rot 4, --antithetic and --rng threefry: the port's JSON (scan
    engine, and the cuda engine's plain version on the CPU, bitwise the
    scan) against nmch_tpu's --engine scan at rel 1e-5."""
    argv = ["--json", *SMALL, *extra]
    want = _json_run(jax_cli_run, [*argv, "--engine", "scan"], capsys)
    for engine in ("scan", "cuda"):
        got = _json_run(cli_run, [*argv, "--engine", engine, "--device",
                                  "cpu"], capsys)
        assert set(got) == set(want) and got["n_paths"] == 1024
        assert abs(got["price"] - want["price"]) <= 1e-5 * abs(want["price"])
        assert abs(got["ci_error"] - want["ci_error"]) <= \
            1e-4 * want["ci_error"]


def test_stats_block_and_oracle_json(capsys):
    assert cli_run(["--device", "cpu", "--no-warmup", *SMALL]) == 0
    assert "METHOD: FORWARD-EULER" in capsys.readouterr().out
    rec = _json_run(cli_run, ["--json", "--oracle", "--device", "cpu",
                              *SMALL], capsys)
    assert abs(rec["price"] - rec["heston_oracle"]) <= \
        3 * rec["ci_error"] + 2e-3


def test_defaults_match_nmch_tpu():
    a = build_parser().parse_args([])
    assert (a.NTPB, a.NB, a.N, a.seed) == (512, 512, 1000, 1234)
    assert (a.T, a.S_0, a.v_0, a.r) == (1.0, 1.0, 0.1, 0.0)
    assert (a.k, a.rho, a.theta, a.sigma) == (0.5, -0.7, 0.1, 0.3)
    # engine None resolves in run(): cuda, or scan for EM with a stateful
    # family, as nmch_tpu's None resolves to pallas or scan
    assert (a.method, a.engine, a.device, a.rng) == \
        ("fe", None, "cuda", "philox")


@pytest.mark.parametrize("argv,match", [
    (["--method", "em", "--rng", "xorwow", "--engine", "cuda"],
     "requires engine='scan'"),
    (["--method", "em", "--rng", "tpu"], "does not support"),
    (["--rng", "device", "--engine", "scan"], "requires engine='cuda'"),
    (["--rng", "xorwow", "--rot", "4"], "no rot/antithetic"),
    (["--antithetic", "--rot", "1"], "contradicts rot=1"),
    (["--method", "em", "--engine", "qmc"], "FE-only"),
    (["--engine", "pallas"], "invalid choice"),
    (["--method", "em", "--rng", "device"], "does not support"),
    (["--rng", "tpu"], "use rng='device'"),
    (["--engine", "qmc", "--rot", "4"], "no rot/antithetic"),
])
def test_unported_options_are_parser_errors(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        cli_run([*argv, "--device", "cpu", *SMALL])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("method", ["fe", "em"])
def test_greeks_keys_and_labels_match_nmch_tpu(method, capsys):
    """--greeks, as nmch_tpu prints it: the JSON record's "greeks" keys
    (no "price"), in its order, and the stats line's label and d/d keys;
    FE values at the golden's tolerance (tests/test_torch_greeks.py)."""
    argv = ["--method", method, "--greeks", "--engine", "scan",
            *(SMALL if method == "fe" else SMALL_EM)]
    got = _json_run(cli_run, [*argv, "--json", "--device", "cpu"], capsys)
    want = _json_run(jax_cli_run, [*argv, "--json"], capsys)
    assert set(got) == set(want) and "price" not in got["greeks"]
    assert list(got["greeks"]) == list(want["greeks"])
    assert len(got["greeks"]) == 8
    if method == "fe":
        for k, v in want["greeks"].items():
            assert got["greeks"][k] == pytest.approx(v, rel=1e-4, abs=4e-5)

    def label_and_keys(fn, extra):
        assert fn([*argv, *extra]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        label, values = line.split(": ", 1)
        return label, [v.split("=")[0] for v in values.split(", ")]
    assert label_and_keys(cli_run, ["--device", "cpu", "--no-warmup"]) == \
        label_and_keys(jax_cli_run, ["--no-warmup"])


def test_greeks_without_a_counter_rng(capsys):
    """FE with a stateful rng notes and skips the Greeks, EM raises
    greeks()'s ValueError, as nmch_tpu's CLI does."""
    for fn, extra in ((cli_run, ["--device", "cpu"]), (jax_cli_run, [])):
        rec = _json_run(fn, ["--greeks", "--json", "--rng", "xorwow",
                             "--engine", "scan", *SMALL, *extra], capsys)
        assert "greeks" not in rec
        with pytest.raises(ValueError, match="counter rng"):
            fn(["--method", "em", "--greeks", "--rng", "xorwow", *SMALL_EM,
                *extra])


@pytest.mark.parametrize("extra", [
    [], ["--rng", "threefry4"], ["--conditional"], ["--poisson-cut", "24"],
])
def test_em_json_matches_nmch_tpu_scan(extra, capsys):
    argv = ["--method", "em", "--json", "--engine", "scan", *SMALL_EM,
            *extra]
    got = _json_run(cli_run, [*argv, "--device", "cpu"], capsys)
    want = _json_run(jax_cli_run, argv, capsys)
    assert set(got) == set(want)
    assert got["method"] == "em" and got["n_paths"] == 1024
    assert abs(got["price"] - want["price"]) <= 1e-5 * abs(want["price"])


def test_em_stats_block_oracle_and_default_poisson_cut(capsys, monkeypatch):
    assert cli_run(["--method", "em", "--device", "cpu", "--no-warmup",
                    *SMALL_EM]) == 0
    assert "METHOD: EXACT-METHOD" in capsys.readouterr().out
    rec = _json_run(cli_run, ["--method", "em", "--json", "--oracle",
                              "--device", "cpu", "--conditional",
                              *SMALL_EM], capsys)
    assert abs(rec["price"] - rec["heston_oracle"]) <= \
        3 * rec["ci_error"] + 2e-3
    # --poisson-cut unset resolves to the method layer's 128
    made = []

    def spy(*a, **kw):
        made.append(NMCH_EM(*a, **kw))
        return made[-1]
    monkeypatch.setattr(cli, "NMCH_EM", spy)
    for extra in ([], ["--poisson-cut", "4000"]):
        _json_run(cli_run, ["--method", "em", "--json", "--device", "cpu",
                            "--no-warmup", *SMALL_EM, *extra], capsys)
    assert [m.poisson_cut for m in made] == [128.0, 4000.0]
    assert build_parser().parse_args([]).poisson_cut is None


def test_package_and_cli_import_no_jax():
    code = ("import sys, nmch_tpu_torch, nmch_tpu_torch.cli, "
            "nmch_tpu_torch.ops.fe_cuda, nmch_tpu_torch.ops.em, "
            "nmch_tpu_torch.ops.em_cuda, nmch_tpu_torch.ops.sampling, "
            "nmch_tpu_torch.methods.em, nmch_tpu_torch.rng.threefry4, "
            "nmch_tpu_torch._build, nmch_tpu_torch.explore, "
            "nmch_tpu_torch.ops.sweep, nmch_tpu_torch.ops.sweep_cuda, "
            "nmch_tpu_torch.analysis.heatmap, nmch_tpu_torch.rng.sobol, "
            "nmch_tpu_torch.ops.fe_qmc, nmch_tpu_torch.ops.fe_qmc_cuda, "
            "nmch_tpu_torch.rng.threefry, nmch_tpu_torch.rng.device, "
            "nmch_tpu_torch.ops.em_schedule, nmch_tpu_torch.ops.greeks, "
            "nmch_tpu_torch.ops.fe_greeks, nmch_tpu_torch.ops.fe_greeks_cuda, "
            "nmch_tpu_torch.ops.em_greeks, nmch_tpu_torch.ops.em_lrm, "
            "nmch_tpu_torch.ops.em_lrm_cuda, "
            "nmch_tpu_torch.benchmarks.lrm_vs_fd; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'nmch_tpu' not in sys.modules, 'nmch_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


QMC_SMALL = ["--NTPB", "256", "--NB", "8", "--N", "16", "--seed", "11"]


@pytest.mark.parametrize("extra", [["--scramble", "shift"],
                                   ["--scramble", "owen"]])
def test_qmc_json_matches_nmch_tpu(extra, capsys):
    """--engine qmc --json: err is null, the price nmch_tpu's at rel
    1e-5 (its scan form against the port's kernel form).  The default
    lms-shift is held to nmch_tpu in tests/test_torch_qmc.py (its jitted
    LMS scramble is the slowest compile here)."""
    argv = ["--json", "--engine", "qmc", *QMC_SMALL, *extra]
    got = _json_run(cli_run, [*argv, "--device", "cpu"], capsys)
    want = _json_run(jax_cli_run, argv, capsys)
    assert set(got) == set(want)
    assert got["engine"] == "qmc" and got["err"] is None is want["err"]
    assert abs(got["price"] - want["price"]) <= 1e-5 * abs(want["price"])
    assert got["ci_error"] > 0


def test_qmc_stats_block_prints_the_rqmc_ci(capsys):
    assert cli_run(["--engine", "qmc", "--device", "cpu", "--no-warmup",
                    "--oracle", *QMC_SMALL]) == 0
    out = capsys.readouterr().out
    assert "= n/a (RQMC replicate CI: " in out
    assert "RQMC 95% CI (shift-replicate spread): " in out
    assert "Semi-analytic Heston price" in out


@pytest.mark.parametrize("argv", [["--scramble", "owen"],
                                  ["--engine", "scan", "--scramble", "shift"],
                                  ["--method", "em", "--scramble", "owen"]])
def test_scramble_outside_qmc_is_a_note_and_ignored(argv, capsys):
    """As in nmch_tpu: a note on stderr, then the run prices as without
    the flag."""
    small = SMALL_EM if "em" in argv else SMALL
    assert cli_run(["--json", "--device", "cpu", "--no-warmup", *argv,
                    *small]) == 0
    out, err = capsys.readouterr()
    rec = json.loads(out.strip().splitlines()[-1])
    plain = [a for a in argv if a not in ("--scramble", "owen", "shift")]
    want = _json_run(cli_run, ["--json", "--device", "cpu", "--no-warmup",
                               *plain, *small], capsys)
    assert rec["price"] == want["price"] and rec["err"] is not None
    assert "note: --scramble applies to --method fe --engine qmc" in err
