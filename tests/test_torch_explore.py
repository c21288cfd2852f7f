"""The port's exploration sweep and heatmap against nmch_tpu's: the grid,
the CSV (same header and (method, k, theta, sigma) bytes, err at rel
1e-4) in loop and batched modes, the parser's refusals, and the heatmap
copy's pivot tables."""

import importlib.util
import math

import numpy as np
import pytest
import torch

from nmch_tpu import explore as jexplore
from nmch_tpu_torch import explore

torch.set_num_threads(2)

SMALL = ["--NTPB", "128", "--NB", "1", "--N", "4"]
ERR_REL = 1e-4


def test_grid_points_equal_nmch_tpu():
    pts = explore.grid_points()
    assert pts == jexplore.grid_points()
    assert len(pts) == 200
    for lo, hi in ((0.1, 10.0), (0.01, 0.5), (0.1, 1.0)):
        assert explore._grid(lo, hi) == jexplore._grid(lo, hi)
    assert explore.feasible(10.0, 0.5, 0.1) and \
        not explore.feasible(0.1, 0.01, 1.0)
    pm = explore.grid_params()
    assert pm.dtype == torch.float32 and pm.shape == (200, 8)
    assert pm[:, 4:].tolist() == torch.tensor(
        [[k, -0.7, th, s] for k, th, s in pts], dtype=torch.float32).tolist()


def _rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [[f.strip() for f in ln.split(",")] for ln in lines[1:]]


@pytest.mark.parametrize("method", ["fe", "em"])
@pytest.mark.parametrize("batched", [False, True])
def test_csv_matches_nmch_tpu(method, batched, tmp_path):
    mode = ["--batched"] if batched else []
    got_path, want_path = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert explore.run(["--engine", "scan", "--device", "cpu", *SMALL,
                        "--methods", method, *mode,
                        "--out", str(got_path)]) == 0
    assert jexplore.run(["--engine", "scan", *SMALL, "--methods", method,
                         *mode, "--out", str(want_path)]) == 0
    head, got = _rows(got_path)
    want_head, want = _rows(want_path)
    assert head == want_head == "method, k, theta, sigma, execution_time, err"
    assert len(got) == len(want) == 200
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        assert float(g[4]) > 0
        assert abs(float(g[5]) - float(w[5])) <= ERR_REL * float(w[5])
    if batched:    # one amortised time for the whole grid
        assert len({r[4] for r in got}) == 1


def test_batched_scan_fe_takes_the_rng_where_nmch_tpu_drops_it(tmp_path):
    """nmch_tpu/explore.py:142-143 prices the batched scan-engine FE sweep
    with fe_sweep_scan, which has no rng argument (sweep_pallas.py:215),
    so its --rng threefry4 CSV is its philox CSV.  The port passes the
    rng on (ROADMAP.md Queue 3)."""
    errs = {}
    for pkg, extra in ((jexplore, []), (explore, ["--device", "cpu"])):
        for rng in ("philox", "threefry4"):
            path = tmp_path / f"{pkg.__name__}_{rng}.csv"
            assert pkg.run(["--engine", "scan", *extra, *SMALL, "--methods",
                            "fe", "--batched", "--rng", rng,
                            "--out", str(path)]) == 0
            errs[pkg, rng] = [r[5] for r in _rows(path)[1]]
    assert errs[jexplore, "philox"] == errs[jexplore, "threefry4"]
    assert errs[explore, "philox"] != errs[explore, "threefry4"]


def test_loop_mode_timed_reps_and_engine_cuda_on_cpu(tmp_path, capsys):
    """--timed-reps queues that many computes per point; engine cuda on
    the CPU runs the wrappers' plain versions."""
    assert explore.run(["--device", "cpu", "--NTPB", "128", "--NB", "1",
                        "--N", "2", "--methods", "fe", "--rng",
                        "threefry4", "--timed-reps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("method, k") and len(lines) == 201
    errs = [float(ln.split(",")[5]) for ln in lines[1:]]
    assert all(math.isfinite(e) and e >= 0 for e in errs)


@pytest.mark.parametrize("argv,match", [
    (["--rng", "xorwow"], "with EM needs --engine scan"),
    (["--rng", "mrg32k3a", "--batched"], "needs loop mode"),
    (["--batched", "--timed-reps", "2"], "loop mode only"),
    (["--timed-reps", "0"], ">= 1"),
    (["--methods", "fe,bogus"], "unknown method"),
    (["--engine", "pallas"], "invalid choice"),
    (["--device", "meta"], "neither cpu nor cuda"),
])
def test_parser_errors(argv, match, capsys):
    device = [] if "--device" in argv else ["--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        explore.run([*argv, *device, *SMALL])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_out_is_not_truncated_by_a_bad_methods(tmp_path, capsys):
    out = tmp_path / "sweep.csv"
    out.write_text("keep me\n")
    with pytest.raises(SystemExit):
        explore.run(["--methods", "fx", "--out", str(out), "--device",
                     "cpu"])
    assert out.read_text() == "keep me\n"
    capsys.readouterr()


def test_cuda_device_without_a_card_is_a_parser_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        explore.run(["--batched", *SMALL])      # the default asks for a card
    assert e.value.code == 2
    assert "is_available" in capsys.readouterr().err


def test_heatmap_copy_matches_nmch_tpu(tmp_path):
    for mod in ("pandas", "matplotlib", "seaborn"):
        if importlib.util.find_spec(mod) is None:
            pytest.skip(f"{mod} is not installed")
    from nmch_tpu.analysis import heatmap as jheat
    from nmch_tpu_torch.analysis import heatmap as theat
    csv = tmp_path / "sweep.csv"
    assert explore.run(["--engine", "scan", "--device", "cpu", *SMALL,
                        "--batched", "--out", str(csv)]) == 0
    got, want = theat.load_sweep(str(csv)), jheat.load_sweep(str(csv))
    assert got.equals(want) and len(got) == 400
    for method in ("fe", "em"):
        for sigma in sorted(got["sigma"].unique()):
            piv = [d[(d["method"] == method) & (d["sigma"] == sigma)]
                   .pivot_table(index="k", columns="theta", values="err",
                                aggfunc="mean") for d in (got, want)]
            assert piv[0].equals(piv[1]) and not piv[0].empty
            assert np.isfinite(piv[0].to_numpy()[~np.isnan(
                piv[0].to_numpy())]).all()
    outdir = tmp_path / "plots"
    outdir.mkdir()
    assert theat.run([str(csv), "--outdir", str(outdir)]) == 0
    pngs = sorted(p.name for p in outdir.iterdir())
    assert pngs == sorted(["fe_err_group1.png", "fe_err_group2.png",
                           "fe_err_group3.png", "em_err_group1.png",
                           "em_err_group2.png", "em_err_group3.png"])
    assert all((outdir / p).stat().st_size > 1000 for p in pngs)
