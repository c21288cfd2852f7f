"""The benchmark's plain reference against the port's plain goldens and the
oracle, on the CPU at small sizes.  The tests may import the port; the
reference may not."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from nmch_tpu_torch import explore
from nmch_tpu_torch.ops.em import EmConsts, em_consts_table, \
    payoffs_from_consts
from nmch_tpu_torch.ops.fe import fe_terminal, path_index_grid
from nmch_tpu_torch.rng.philox import philox4x32, split_seed
from portbench.reference import em as ref_em
from portbench.reference import fe as ref_fe
from portbench.reference import grid as ref_grid
from portbench.reference.oracle import heston_call_undiscounted
from portbench.reference.rng import BlockWindow, key_words

BASE = dict(T=1.0, S_0=1.0, v_0=0.1, r=0.0, k=0.5, rho=-0.7, theta=0.1,
            sigma=0.3)
GRID = {"k": [0.1, 10.0], "theta": [0.01, 0.5], "sigma": [0.1, 1.0],
        "steps": 5}
SEEDS = (1234, 2 ** 31 + 12345, (7 << 32) + 99)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_match_the_port(seed):
    assert key_words(seed) == tuple(int(w) for w in split_seed(seed))


def test_block_window_is_philox():
    key = key_words(2 ** 31 + 5)
    ep = torch.tensor([[3], [9]])
    path = torch.arange(128).reshape(1, 128)
    win = BlockWindow(ep, path, key, width=8)
    ctr = torch.randint(0, 20, (2, 128))
    for _ in range(3):
        words = win.words(ctr, 4)
        for r in range(4):
            want = philox4x32(ctr + r, ep, path, 0, *key)
            for got, w in zip(words, want):
                assert torch.equal(got[r], w)
        ctr = ctr + torch.randint(0, 4, ctr.shape)


def test_grid_is_explores():
    assert ref_grid.grid_points(GRID) == explore.grid_points()
    assert len(ref_grid.grid_points(GRID)) == 200


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("N", [7, 16])
def test_fe_payoffs_bitwise_the_port(seed, N):
    key = key_words(seed)
    pts = [BASE, dict(BASE, k=2.0, theta=0.3, sigma=0.8, rho=-0.2, r=0.05)]
    rows = ref_fe.param_rows(pts)
    epochs = [0, 2 ** 32 - 1]
    got = ref_fe.fe_payoffs(rows, key, epochs, N, 256, "cpu", chunk=3)
    path = path_index_grid(256)
    for i, e in enumerate(epochs):
        S_T, _ = fe_terminal(torch.from_numpy(rows[i]), N, path, e, *key)
        want = torch.clamp_min(S_T - float(rows[i, 1]), 0.0).reshape(-1)
        assert torch.equal(got[i], want)


def _em_points():
    """Grid points over every Poisson regime and the Gamma boost: (0.1,
    0.5, 1.0) has d = 0.1, the heaviest PTRS and Knuth load."""
    pts = explore.grid_points()
    pick = [0, 37, 120, 199, pts.index((0.1, 0.5, 1.0))]
    return [dict(BASE, k=pts[i][0], theta=pts[i][1], sigma=pts[i][2])
            for i in pick]


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("cut", [128.0, 4000.0])
def test_em_payoffs_and_counters_bitwise_the_port(seed, cut):
    key = key_words(seed)
    rows = ref_fe.param_rows(_em_points())
    N, n = 12, 256
    epochs = list(range(5, 5 + rows.shape[0]))
    pay, counts, ctr = ref_em.em_payoffs(rows, key, epochs, N, n, cut, "cpu")
    tab = em_consts_table(torch.from_numpy(rows), N, cut)
    for i, e in enumerate(epochs):
        c = EmConsts(*(float(v) for v in tab[i]))
        want, want_ctr = payoffs_from_consts(c, N, path_index_grid(n), e,
                                             *key, "philox", False)
        assert torch.equal(pay[i], want.reshape(-1))
        assert torch.equal(ctr[i], want_ctr.reshape(-1))
    assert counts["paths"] == rows.shape[0] * n
    assert counts["boosts"] > 0 and counts["rounds_knuth"] > 0
    assert counts["rounds_ptrs"] > 0
    assert counts["steps_small"] + counts["steps_mid"] + \
        counts["steps_large"] == rows.shape[0] * n * N


def test_em_constants_are_the_ports():
    rows = ref_fe.param_rows(_em_points())
    tab = em_consts_table(torch.from_numpy(rows), 1000, 128.0)
    mine = ref_em.em_constants(rows, 1000, 128.0)
    for j, name in enumerate(ref_em.CONST_NAMES):
        assert torch.equal(mine[name], tab[:, j]), name


@pytest.mark.parametrize("method", ["fe", "em"])
def test_prices_near_the_oracle(method):
    """The reference's price within 4 CIs (plus FE's Euler bias) of the
    semi-analytic oracle."""
    rows = ref_fe.param_rows([BASE])
    key = key_words(2 ** 31 + 3)
    if method == "fe":
        pay = ref_fe.fe_payoffs(rows, key, [0], 32, 8192, "cpu")
        bias = 5e-3
    else:
        pay, _, _ = ref_em.em_payoffs(rows, key, [0], 8, 8192, 128.0, "cpu")
        bias = 0.0
    m, m2 = (float(x[0]) for x in ref_fe.moments(pay))
    ci = 1.96 * np.sqrt(max(m2 - m * m, 0.0) / 8192)
    assert abs(m - heston_call_undiscounted(BASE)) < 4 * ci + bias


@pytest.mark.parametrize("method", ["fe", "em"])
def test_control_precision_differs(method):
    """The control (path state in bfloat16) gives other payoffs."""
    rows = ref_fe.param_rows([BASE])
    key = key_words(11)
    if method == "fe":
        hi = ref_fe.fe_payoffs(rows, key, [1], 16, 256, "cpu")
        lo = ref_fe.fe_payoffs(rows, key, [1], 16, 256, "cpu", torch.bfloat16)
    else:
        hi = ref_em.em_payoffs(rows, key, [1], 8, 256, 128.0, "cpu")[0]
        lo = ref_em.em_payoffs(rows, key, [1], 8, 256, 128.0, "cpu",
                               torch.bfloat16)[0]
    assert not torch.equal(hi, lo)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.fe, portbench.reference.em, "
            "portbench.reference.grid, portbench.reference.oracle, "
            "portbench.reference.rng, portbench.roofline, portbench.check, "
            "portbench.window, portbench.guard, portbench.spec; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nmch_tpu', 'nmch_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
