"""NMCH_FE(engine="qmc") held to the benchmark's plain QMC reference
(``portbench/reference/qmc.py``) at the parameters of
``portbench/configs/nmch_cli_qmc.json`` and a small size, and the
reference's parts held to their definitions: the unscrambled Sobol' words
to scipy's, the bridge to the covariance of Brownian increments.

On the CPU the engine runs K6's plain version on the dense bridge product
of its fast normals; the reference builds the same point set from the
Joe-Kuo table, inverts the normal CDF exactly and runs the bridge's
recursion, so the two agree to rounding and to the fast inverse CDF."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.special import ndtri
from scipy.stats import qmc as scipy_qmc

from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig
from portbench import check
from portbench.reference import qmc
from portbench.reference.rng import key_words

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "nmch_cli_qmc.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "traffic" /
                     "qmc_calls.json").read_text())["limits"]
NTPB, NB = 128, 16
N_PATHS = NTPB * NB             # 8 replicates of 256 points
CALLS = 2


def _calls(seed, N, calls=CALLS):
    """(price, CI) of the pricer's first ``calls`` compute() calls."""
    p = NMCH_FE(SimConfig(NTPB=NTPB, NB=NB, N=N),
                HestonParams(**CONFIG["params"]), engine="qmc",
                rng=CONFIG["rng"], scramble=CONFIG["scramble"], device="cpu")
    p.init(seed)
    return [(r.price, r.ci_error) for r in (p.compute()
                                            for _ in range(calls))]


def _reference(seed, N, epoch, dtype=torch.float32):
    return qmc.price_and_ci(dict(CONFIG, N=N), key_words(seed), epoch,
                            N_PATHS, "cpu", dtype)


@pytest.mark.parametrize("N", [16, 33])
@pytest.mark.parametrize("seed", [2 ** 31 + 4321, 97, 2 ** 33 + 5])
def test_pricer_matches_the_reference(seed, N):
    """Two calls (epochs 0 and 1) of the pricer the cell runs.

    Price: rel 1e-5.  The fast inverse CDF is within 2.3e-6 of ndtri on z
    and shifts the price by ~2.2e-6 relative at these sizes; the dense
    product and the recursion differ only in float32 rounding (1e-8).

    CI: the program's half-width is 1.96 sqrt(n/(n-1) (m2 - m^2) / n) of
    the moments it synthesises from the t-based CI, which carries the
    factor (1.96 / z_0.975) sqrt(n/(n-1)) (2.6e-4 at 2,048 paths) over
    t_0.975,7 s / sqrt(8).  With that factor applied, rel 1e-4: the
    rounding differences move each replicate mean by ~1e-8 against a
    spread of ~1e-3 (the readings were up to 1.4e-5)."""
    factor = (1.96 / ndtri(0.975)) * np.sqrt(N_PATHS / (N_PATHS - 1))
    for epoch, (price, ci) in enumerate(_calls(seed, N)):
        want_price, want_ci = _reference(seed, N, epoch)
        assert price == pytest.approx(want_price, rel=1e-5, abs=0)
        assert ci == pytest.approx(want_ci * factor, rel=1e-4, abs=0)


def _methods(answers):
    a = np.array(answers)
    return {"qmc_price": a[:, :1], "qmc_ci": a[:, 1:]}


def test_bfloat16_control_reads_far_from_the_program():
    """The reference with its normals, bridge and steps in bfloat16 (the
    control of ``portbench.calibrate``) reads at least 10x each of the
    cell's limits (price, CI) from the program, and the float32
    reference within each."""
    seed, N = 2 ** 31 + 4321, 33
    got = _methods(_calls(seed, N))
    assert set(LIMITS) == {f"{m}.rel_gap" for m in got}
    for dtype, far in ((torch.bfloat16, True), (torch.float32, False)):
        ref = _methods([_reference(seed, N, e, dtype)
                        for e in range(CALLS)])
        for name, gap in check.gaps(got, ref).items():
            limit = LIMITS[name]
            assert (gap > 10 * limit) if far else (gap < limit), \
                (dtype, name, gap)


def test_configuration_states_the_programs_replicate_count():
    """The reference takes its replicate count from the configuration's
    ``n_shifts``; the pricer takes none (it runs the engine's default), so
    the key has to state that default."""
    import inspect
    from nmch_tpu_torch.ops.fe_qmc import DEFAULT_N_SHIFTS
    assert CONFIG["n_shifts"] == DEFAULT_N_SHIFTS
    assert "n_shifts" not in inspect.signature(NMCH_FE).parameters


@pytest.mark.parametrize("d,n", [(64, 1024), (2000, 256)])
def test_unscrambled_words_are_scipys(d, n):
    """The directions from the Joe-Kuo table and the words in their
    direct form, over 2^30: scipy's unscrambled Sobol' points, exactly."""
    words = qmc.sobol_words(qmc.directions(d), n)
    pts = scipy_qmc.Sobol(d=d, scramble=False).random(n)
    assert np.array_equal(words.numpy().T / 2.0 ** qmc.BITS, pts)


@pytest.mark.parametrize("N", [16, 33, 1000])
def test_bridge_has_the_covariance_of_brownian_increments(N):
    """The recursion is linear, dW = B z: on the unit vectors in float64,
    B B^T = dt I (each increment's variance dt, no correlation between
    steps) within 1e-6 dt, since its weights are float32 as the program's
    (the readings were 2e-8 to 2.1e-7 dt); on 2^15 unit normals in
    float32, the sample covariance within 6 standard errors of dt I."""
    T = CONFIG["params"]["T"]
    dt = T / N
    sqrt_dt = float(np.sqrt(np.float32(dt)))
    B = qmc.bridge_increments(torch.eye(N, dtype=torch.float64), N,
                              sqrt_dt, torch.float64)
    eye = torch.eye(N, dtype=torch.float64)
    torch.testing.assert_close(B @ B.T, dt * eye, rtol=0, atol=1e-6 * dt)
    if N > 33:
        return
    M = 1 << 15
    z = torch.randn(N, M, generator=torch.Generator().manual_seed(5))
    dW = qmc.bridge_increments(z, N, sqrt_dt, torch.float32).double()
    sample = dW @ dW.T / M
    err = (sample - dt * eye).abs().max()
    assert err < 6 * dt * np.sqrt(2.0 / M)


def test_reference_and_kind_import_no_program_or_jax():
    """In a fresh process, the reference and the cell's kind load without
    loading jax, nmch_tpu or nmch_tpu_torch."""
    code = (
        "import sys\n"
        "import portbench.reference.qmc\n"
        "from portbench import spec\n"
        "spec.load('kinds', 'qmc_calls')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'nmch_tpu',\n"
        "              'nmch_tpu_torch'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    for name in ("reference/qmc.py", "kinds/qmc_calls.py"):
        src = (ROOT / "portbench" / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|nmch_tpu)",
                             src, re.M), name
