"""NMCH_EM at the reference's exact law, the strict Poisson cut 4000, held
to the benchmark's plain reference (``portbench/reference/em.py``) at the
parameters of ``portbench/configs/nmch_cli_exact.json``.

On the CPU the cuda engine runs its plain version, which takes the same
float32 draws as the reference and sums in float64, so the moments agree
to rounding of the sums.  At N = 200 lambda is ~440 at v_0, between the
two cuts: at cut 4000 PTRS draws most steps, at cut 128 the rounded
normal, so the regime is what the test exercises."""

import json
import pathlib

import pytest
import torch

from nmch_tpu_torch import HestonParams, NMCH_EM, SimConfig
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda
from portbench.reference.em import em_payoffs, payoffs
from portbench.reference.fe import moments, param_rows
from portbench.reference.rng import key_words

torch.set_num_threads(2)

CONFIG = json.loads((pathlib.Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "nmch_cli_exact.json").read_text())
SIZES = {"NTPB": 128, "NB": 2, "N": 200}
N_PATHS = SIZES["NTPB"] * SIZES["NB"]
CALLS = 2


def _rows(n):
    return param_rows([CONFIG["params"]] * n)


@pytest.mark.parametrize("seed", [2 ** 31 + 4321, 97])
def test_exact_law_calls_match_the_reference(seed):
    """Two compute() calls of the pricer the cell runs (engine cuda, its
    plain version here) against the reference's payoffs of epochs 0 and
    1: both moments to 1e-12 relative, and the reference's counts show
    that PTRS drew the steps."""
    assert CONFIG["poisson_cut"] == 4000.0
    pricer = NMCH_EM(SimConfig(**SIZES), HestonParams(**CONFIG["params"]),
                     engine="cuda", rng=CONFIG["rng"],
                     poisson_cut=CONFIG["poisson_cut"], device="cpu")
    pricer.init(seed)
    got = torch.tensor([[r.price, r.price_squared] for r in
                        (pricer.compute() for _ in range(CALLS))],
                       dtype=torch.float64)
    pay, counts = payoffs(dict(CONFIG, **SIZES), _rows(CALLS),
                          key_words(seed), range(CALLS), N_PATHS, "cpu")
    want = torch.stack(moments(pay), 1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    assert counts["rounds_ptrs"] > 0
    assert counts["steps_mid"] > counts["steps_small"] + counts["steps_large"]


def test_the_cut_decides_the_regime():
    """At the same paths, cut 128 sends most steps to the rounded normal
    and cut 4000 most to PTRS; at each cut the plain version's per-path
    counters are the reference's."""
    seed = 2 ** 31 + 4321
    key = key_words(seed)
    regime = {}
    for cut in (128.0, CONFIG["poisson_cut"]):
        _, counts, ctr = em_payoffs(_rows(1), key, [0], SIZES["N"], N_PATHS,
                                    cut, "cpu")
        _, _, _, got = em_moments_cuda(
            HestonParams(**CONFIG["params"]).as_tensor("cpu"), key, 0, 0,
            N=SIZES["N"], n_paths=N_PATHS, device="cpu", rng=CONFIG["rng"],
            poisson_cut=cut, per_path=True)
        assert torch.equal(got.flatten(), ctr.flatten())
        regime[cut] = max(("steps_small", "steps_mid", "steps_large"),
                          key=counts.get)
    assert regime == {128.0: "steps_large", 4000.0: "steps_mid"}
