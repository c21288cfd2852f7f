"""K2's lookahead counter (``csrc/em.cu``: ``em_paths`` draws through
``csrc/em_path.cuh``'s ``AheadCounter``): that it gives the plain counter's
bits.

K4 (``em_sweep_paths``) keeps the plain counter, and point p of a sweep is
K2 at epoch epoch0 + p, so a one-point sweep is K2's plain-counter twin.
The card's cases (marker ``cuda``) hold the two bitwise equal path for path
at explore's 5,120 paths (40 blocks, under one wave, where the lookahead
pays most) and N = 1000; they import neither jax nor nmch_tpu:

    python -m pytest tests/test_torch_em_ahead.py -m cuda -q --noconftest
"""

import math
import pathlib

import pytest
import torch

from nmch_tpu_torch import HestonParams
from nmch_tpu_torch.explore import grid_params
from nmch_tpu_torch.ops import em_cuda
from nmch_tpu_torch.ops.em import em_consts_table
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda, em_round_schedule
from nmch_tpu_torch.ops.sweep_cuda import em_sweep_cuda


def _header_note(path: pathlib.Path) -> str:
    """The comment block that opens a source file."""
    lines = []
    for line in path.read_text().splitlines():
        if not line.startswith("//"):
            break
        lines.append(line[2:].strip())
    return " ".join(lines)


def test_em_cu_note_names_the_lookahead_counter():
    csrc = pathlib.Path(em_cuda.__file__).parents[1] / "csrc"
    note = _header_note(csrc / "em.cu")
    assert "em_paths draws through em_path.cuh's lookahead counter" in note
    assert "AheadCounter" in note and "one wave" in note


# --- on the card --------------------------------------------------------------

N, PATHS, EPOCH = 1000, 5120, 3
KEY = (1234, 5678)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _point(which: str):
    """(params (8,), poisson_cut, round schedule?) of a case: the CLI's
    constants at cut 128 or 4000, or the first explore point (cut 128) on
    the step loops or on the round schedule."""
    if which.startswith("cli"):
        cut = float(which[3:])
        pv = HestonParams().as_tensor("cpu")
    else:
        cut = 128.0
        pm = grid_params()
        rounds = em_round_schedule(em_consts_table(pm, N, cut), N)
        want = which == "explore_rounds"
        pv = pm[int(torch.nonzero(rounds == want)[0])]
    rounds = bool(em_round_schedule(em_consts_table(pv[None], N, cut), N))
    return pv, cut, rounds


@pytest.mark.cuda
@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("which", ["cli128", "cli4000", "explore_steps",
                                   "explore_rounds"])
def test_lookahead_counter_is_bitwise_the_plain_counter(dev, which, rng,
                                                        conditional):
    """At 5,120 paths K2 gives every path's payoff and final counter
    bitwise K4's (the plain counter), and the same moments, on the step
    loops (cli128, an explore point) and on the round schedule (cli4000,
    an explore point); its counts are its paths' blocks drawn and, on the
    round schedule only, its warps' draws."""
    pv, cut, rounds = _point(which)
    assert rounds == (which in ("cli4000", "explore_rounds"))
    kw = dict(N=N, n_paths=PATHS, device=dev, rng=rng,
              conditional=conditional, poisson_cut=cut)
    vec, pay, ctr = em_moments_cuda(pv, KEY, EPOCH, 0, per_path=True,
                                    counts=True, **kw)
    m, m2, s_pay, s_ctr = em_sweep_cuda(pv[None], KEY, EPOCH, per_path=True,
                                        **kw)
    assert torch.equal(pay.reshape(-1).view(torch.int32).cpu(),
                       s_pay.reshape(-1).view(torch.int32).cpu())
    assert torch.equal(ctr.reshape(-1).cpu().long(),
                       s_ctr.reshape(-1).cpu().long())
    vec = vec.cpu()
    assert vec[:2].tolist() == [m.item(), m2.item()]
    assert vec[2].item() == ctr.sum().item() > 0
    assert math.isnan(vec[3].item()) != rounds
