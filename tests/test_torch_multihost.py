"""Multi-process pricing of the PyTorch port (gloo ranks on the CPU).

Runs ``python -m nmch_tpu_torch.examples.multihost --cpu`` (P processes,
one rank each, meeting through a ``file://`` store in a temporary
directory) and holds the sharded moments, which ``--json`` prints at full
precision, to the port's single run (rel 1e-12: the same draws, only the
float64 grouping differs) and the price line to ``nmch_tpu``'s
single-device golden (rel 2e-6, as ``tests/test_multihost.py``; QMC 2e-5).
Each rank runs one torch thread (OMP_NUM_THREADS=1).
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import nmch_tpu_torch
from nmch_tpu.ops.fe import fe_moments_scan as j_fe_moments_scan, \
    path_index_grid as j_path_index_grid
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch.ops.em import FAST_POISSON_CUT, em_moments_scan
from nmch_tpu_torch.ops.fe import fe_moments_scan, path_index_grid
from nmch_tpu_torch.params import HestonParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(os.path.abspath(nmch_tpu_torch.__file__))
K01 = split_seed(1234)
PV = HestonParams().as_tensor("cpu")


def _run_multihost(processes: int, paths_per_chip: int, N: int,
                   method: str = "fe", engine: str = "scan", extra=()):
    """The rank-0 price line and every rank's JSON record."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "nmch_tpu_torch.examples.multihost", "--cpu",
         f"--processes={processes}", f"--paths-per-chip={paths_per_chip}",
         f"--N={N}", f"--method={method}", f"--engine={engine}", "--json",
         "--timeout=240", *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    n_paths = paths_per_chip * processes
    m = re.search(
        rf"hosts={processes} chips={processes} paths={n_paths} "
        rf"{method}/{engine}: price=([0-9.]+)", out.stdout)
    assert m, out.stdout[-2000:] + out.stderr[-1000:]
    recs = sorted((json.loads(line) for line in out.stdout.splitlines()
                   if line.startswith("{")), key=lambda r: r["rank"])
    assert [r["rank"] for r in recs] == list(range(processes))
    assert all(r["world"] == processes and r["backend"] == "gloo"
               and r["package"] == PACKAGE
               and (r["m"], r["m2"]) == (recs[0]["m"], recs[0]["m2"])
               for r in recs)
    return float(m.group(1)), (recs[0]["m"], recs[0]["m2"])


def _close(got, want, rel):
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * abs(w), (got, want)


def _jax_fe(n_paths, N):
    ms, _ = jax.jit(j_fe_moments_scan, static_argnums=1)(
        JHestonParams().as_array(), N, j_path_index_grid(n_paths),
        jnp.uint32(0), *K01)
    return float(ms)


def test_two_process_fe_matches_single():
    n_paths, N = 4096, 25
    price, mom = _run_multihost(2, n_paths // 2, N)
    _close(mom, [x.item() for x in fe_moments_scan(
        PV, N, path_index_grid(n_paths), 0, *K01)], 1e-12)
    assert price == pytest.approx(_jax_fe(n_paths, N), rel=2e-6)


def test_four_process_em_matches_single():
    """EM across four processes: the default cut resolves to
    FAST_POISSON_CUT on every rank."""
    n_paths, N = 2048, 8
    price, mom = _run_multihost(4, n_paths // 4, N, method="em")
    _close(mom, [x.item() for x in em_moments_scan(
        PV, N, path_index_grid(n_paths), 0, *K01,
        poisson_cut=FAST_POISSON_CUT)], 1e-12)
    from nmch_tpu.ops.em import em_moments_scan as j_em_moments_scan
    ms, _ = jax.jit(j_em_moments_scan, static_argnums=1)(
        JHestonParams().as_array(), N, j_path_index_grid(n_paths),
        jnp.uint32(0), *K01)
    assert price == pytest.approx(float(ms), rel=2e-6)


def test_failed_ranks_exit_nonzero():
    """Arguments every rank refuses (n_paths not a multiple of 128 x 3):
    the launcher returns nonzero and prints no price."""
    out = subprocess.run(
        [sys.executable, "-m", "nmch_tpu_torch.examples.multihost", "--cpu",
         "--processes=3", "--paths-per-chip=100", "--N=4", "--timeout=120"],
        capture_output=True, text=True, timeout=200, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode != 0
    assert "price=" not in out.stdout
    assert "multiple of 128*n_devices=384" in out.stderr


@pytest.mark.slow
def test_four_process_fe_matches_single():
    n_paths, N = 4096, 25
    price, mom = _run_multihost(4, n_paths // 4, N)
    _close(mom, [x.item() for x in fe_moments_scan(
        PV, N, path_index_grid(n_paths), 0, *K01)], 1e-12)
    assert price == pytest.approx(_jax_fe(n_paths, N), rel=2e-6)


@pytest.mark.slow
def test_two_process_qmc_matches_single():
    """QMC point-range sharding across processes."""
    from nmch_tpu.ops.fe_qmc import fe_moments_qmc as j_fe_moments_qmc
    from nmch_tpu_torch.ops.fe_qmc import fe_moments_qmc
    n_paths, N = 4096, 16
    price, mom = _run_multihost(2, n_paths // 2, N, engine="qmc")
    m1, m21 = (x.item() for x in fe_moments_qmc(PV, 0, *K01, N=N,
                                                n_paths=n_paths,
                                                device="cpu"))
    assert mom[0] == pytest.approx(m1, rel=2e-6)
    assert mom[1] == pytest.approx(m21, rel=2e-4)
    ms, _ = j_fe_moments_qmc(JHestonParams().as_array(), jnp.uint32(0),
                             *K01, N=N, n_paths=n_paths, n_shifts=8,
                             sim="scan")
    assert price == pytest.approx(float(ms), rel=2e-5)


@pytest.mark.slow
def test_two_process_stateful_family_matches_single():
    """xorwow across processes: the skip-ahead gives each rank a disjoint
    path range of the same per-path streams."""
    from nmch_tpu.ops.fe_xorwow import fe_moments_xorwow as j_xorwow
    from nmch_tpu_torch.ops.fe_xorwow import fe_moments_xorwow
    n_paths, N = 4096, 12
    price, mom = _run_multihost(2, n_paths // 2, N, extra=("--rng=xorwow",))
    _close(mom, [x.item() for x in fe_moments_xorwow(
        PV, N, path_index_grid(n_paths), 0, 1234)], 1e-12)
    ms, _ = jax.jit(j_xorwow, static_argnums=(1, 4))(
        JHestonParams().as_array(), N, j_path_index_grid(n_paths),
        jnp.uint32(0), 1234)
    assert price == pytest.approx(float(ms), rel=2e-6)
