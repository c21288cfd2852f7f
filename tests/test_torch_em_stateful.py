"""EM with the stateful families (xorwow, mrg32k3a) on the scan engine of
the PyTorch port against nmch_tpu's em_moments_scan with ``seed``.

Per path, the final 6-word state must equal nmch_tpu's on at least 99.9%
of the paths (measured: all), and the moments over the paths whose state
and payoff (rel 1e-4) agree at rel 1e-5, as tests/test_torch_em.py holds
the counter families: torch's CPU log/exp are not XLA's bit for bit, so a
rare path can take another accept/reject decision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmch_tpu
from nmch_tpu.ops import em as jem
from nmch_tpu.ops.fe import path_index_grid as j_path_index_grid
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu_torch import HestonParams, NMCH_EM, SimConfig, explore
from nmch_tpu_torch.ops import em as tem
from nmch_tpu_torch.ops import sampling as ts
from nmch_tpu_torch.ops.fe import path_index_grid

torch.set_num_threads(2)

N_PATHS, N = 2048, 8
SHARE = 0.999
REL = 1e-5
PATH_REL = 1e-4
PARAMS = [JHestonParams(),                              # PTRS (lam ~ 70)
          JHestonParams(sigma=1.0, theta=0.01, k=1.0)]  # Knuth, alpha < 1


@functools.lru_cache(maxsize=None)
def _jax_per_path(rng, conditional, cut, seed):
    def f(pv, pidx, epoch):
        lo = pidx.astype(jnp.uint32)
        hi = jnp.zeros_like(lo)
        scan = jem.em_moments_scan(pv, N, pidx, epoch, 0, 0, rng=rng,
                                   conditional=conditional, poisson_cut=cut,
                                   seed=seed)
        if conditional:
            m, s, _, _, st = jem.em_path_law(pv, N, lo, hi, epoch, 0, 0,
                                             rng=rng, poisson_cut=cut,
                                             seed=seed)
            return jem.em_conditional_payoff(m, s, pv[1]), st, scan
        S_T, _, _, st = jem.em_terminal_core(pv, N, lo, hi, epoch, 0, 0,
                                             rng=rng, poisson_cut=cut,
                                             seed=seed)
        return jnp.maximum(S_T - pv[1], 0.0), st, scan
    return jax.jit(f)


def _moments(pay: np.ndarray):
    pay = pay.astype(np.float64)
    return np.array([pay.mean(), (pay * pay).mean()])


@pytest.mark.parametrize("rng,conditional,cut", [
    ("xorwow", False, None), ("xorwow", False, 64.0),
    ("xorwow", True, None), ("xorwow", True, 64.0),
    ("mrg32k3a", False, 64.0), ("mrg32k3a", True, None)])
def test_per_path_state_and_moments_match_nmch_tpu(rng, conditional, cut):
    seed, epoch = 1234, 2
    for p in PARAMS:
        pv = p.as_array()
        j_pay, j_st, scan = _jax_per_path(rng, conditional, cut, seed)(
            pv, j_path_index_grid(N_PATHS), jnp.uint32(epoch))
        t_pay, t_st = tem.em_payoffs(torch.from_numpy(np.array(pv)), N,
                                     path_index_grid(N_PATHS), epoch, 0, 0,
                                     rng=rng, conditional=conditional,
                                     poisson_cut=cut, seed=seed)
        assert isinstance(t_st, tuple) and len(t_st) == 6
        same = np.ones(N_PATHS, dtype=bool)
        for a, b in zip(t_st, j_st):
            same &= a.numpy().ravel() == np.asarray(b).astype(np.int64).ravel()
        assert same.mean() >= SHARE
        j_pay = np.asarray(j_pay).ravel()
        t_pay = t_pay.numpy().ravel()
        agree = same & (np.abs(t_pay - j_pay)
                        <= PATH_REL * np.abs(j_pay) + 1e-7)
        assert agree.mean() >= SHARE
        np.testing.assert_allclose(_moments(t_pay[agree]),
                                   _moments(j_pay[agree]), rtol=REL)
        got = np.array([float(x) for x in tem.em_moments_scan(
            torch.from_numpy(np.array(pv)), N, path_index_grid(N_PATHS),
            epoch, 0, 0, rng=rng, conditional=conditional, poisson_cut=cut,
            seed=seed)])
        slack = _moments(np.abs(t_pay - j_pay) * ~agree) \
            + _moments(np.abs(t_pay + j_pay) * ~agree)
        want = np.array([float(x) for x in scan])
        assert (np.abs(got - want) <= REL * np.abs(want) + slack).all()


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_stream_draw_is_four_recurrence_steps_and_sel_is_per_lane(rng):
    seed, pidx = 9, path_index_grid(256)
    st = ts.stream_state_init(rng, seed, pidx, 1)
    *ws, nxt = ts.make_stream_draw4(rng, 1, pidx, None, 0, 0)(st)
    if rng == "xorwow":
        from nmch_tpu_torch.rng.xorwow import xorwow_step as step
        s, d = st[:5], st[5]
        for w in ws:
            o, s, d = step(s, d)
            assert torch.equal(o, w)
        assert all(torch.equal(a, b) for a, b in zip(nxt, s + (d,)))
    else:
        from nmch_tpu_torch.rng.mrg32k3a import mrg_step as step
        s1, s2 = st[:3], st[3:]
        for w in ws:
            z, s1, s2 = step(s1, s2)
            assert torch.equal(z, w)
        assert all(torch.equal(a, b) for a, b in zip(nxt, s1 + s2))
    pred = pidx % 2 == 0
    mixed = ts._sel(pred, nxt, st)
    assert all(torch.equal(m[pred], n[pred]) and torch.equal(m[~pred],
                                                             o[~pred])
               for m, n, o in zip(mixed, nxt, st))


def test_stateful_rng_needs_the_seed():
    with pytest.raises(ValueError, match="needs the integer seed"):
        tem.em_payoffs(HestonParams().as_tensor("cpu"), 2,
                       path_index_grid(128), 0, 0, 0, rng="xorwow")


EM_CFG = SimConfig(NTPB=256, NB=4, N=8, seed=3)


def test_method_on_the_scan_engine_matches_nmch_tpu(tmp_path):
    """NMCH_EM(rng="xorwow", engine="scan"): epochs continue, prices at
    rel 1e-5 of nmch_tpu's (measured per path above), and a checkpoint
    resumes the stream."""
    m = NMCH_EM(EM_CFG, HestonParams(), engine="scan", rng="xorwow",
                device="cpu")
    jm = nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(NTPB=256, NB=4, N=8, seed=3),
                          nmch_tpu.HestonParams(), engine="scan",
                          rng="xorwow")
    m.init(3)
    jm.init(3)
    r1, j1 = m.compute(), jm.compute()
    ck = str(tmp_path / "ck.json")
    m.save_state(ck)
    r2, j2 = m.compute(), jm.compute()
    assert r1.price != r2.price
    for r, j in ((r1, j1), (r2, j2)):
        assert abs(r.price - j.price) <= REL * j.price
    m2 = NMCH_EM(EM_CFG, HestonParams(), engine="scan", rng="xorwow",
                 device="cpu")
    m2.load_state(ck)
    assert m2.compute().price == r2.price


@pytest.mark.parametrize("kw,match", [
    ({"rng": "xorwow"}, "requires engine='scan'"),          # default: cuda
    ({"rng": "mrg32k3a", "engine": "cuda"}, "requires engine='scan'"),
    ({"rng": "xorwow", "engine": "scan",
      "cfg": SimConfig(NTPB=2**16, NB=2**15)}, "2\\^31"),
])
def test_method_refusals(kw, match):
    cfg = kw.pop("cfg", EM_CFG)
    with pytest.raises(ValueError, match=match):
        NMCH_EM(cfg, HestonParams(), device="cpu", **kw)


def test_method_epoch_bound():
    m = NMCH_EM(EM_CFG, HestonParams(), engine="scan", rng="mrg32k3a",
                device="cpu")
    m.init(3)
    m.streams.epoch = 2**27
    with pytest.raises(ValueError, match="epochs per path block"):
        m.compute()


def test_explore_em_with_xorwow_on_the_scan_engine(capsys):
    assert explore.run(["--methods", "em", "--rng", "xorwow", "--engine",
                        "scan", "--device", "cpu", "--NTPB", "128", "--NB",
                        "1", "--N", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 201 and lines[1].startswith("em, ")
