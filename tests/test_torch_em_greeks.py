"""EM sensitivities of the PyTorch port against nmch_tpu's.

The pathwise trio (``ops/em_greeks.py::em_price_and_greeks``), CRN
central differences (``em_greeks_fd``) and the score-function estimator
(``ops/em_lrm.py::em_greeks_lrm``) against their ``nmch_tpu``
counterparts at N = 16 x 16,384 paths on the same (seed, epoch) streams,
on the CPU, where the port's plain versions stand in for the card's
kernels (K2's law build, K2 conditional, K2-LRM).  torch's CPU log and
exp are not XLA's, so a rare path takes another sampler decision than
nmch_tpu's; the tolerances are stated per test from that: a flipped path
moves a price by ~1e-5, the trio and the LRM Greeks by less than 1e-5
(seen: < 1e-6), an FD difference by ~1e-5 / (2 h) (seen: 2.1e-4 on
sigma, h = 0.015).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma as sp_digamma

import nmch_tpu
from nmch_tpu.ops import em as jem_law, em_greeks as jem, em_lrm as jlrm
from nmch_tpu.ops.fe import path_index_grid as j_path_index_grid
from nmch_tpu_torch import HestonParams, NMCH_EM, SimConfig
from nmch_tpu_torch.ops import em_greeks, em_lrm
from nmch_tpu_torch.ops.em import em_consts, em_moments_scan, \
    path_law_from_consts, payoffs_from_consts
from nmch_tpu_torch.ops.em_cuda import em_law_cuda, em_moments_cuda
from nmch_tpu_torch.ops.em_lrm_cuda import em_lrm_scores_cuda
from nmch_tpu_torch.ops.fe import path_index_grid
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

N, NP = 16, 16384
KEY = tuple(int(w) for w in split_seed(1234))
P = HestonParams()
UNDERFLOW = HestonParams(k=0.5, theta=0.01, sigma=1.0)


def _pv(p=P):
    return p.as_tensor("cpu")


def _floats(d):
    return {k: float(v) for k, v in d.items()}


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("fix_strike", [False, True])
def test_pathwise_trio_matches_nmch_tpu(rng, fix_strike):
    jp, jg = jem.em_price_and_greeks(P.as_array(), jnp.uint32(0), *KEY, N=N,
                                     n_paths=NP, rng=rng,
                                     fix_strike=fix_strike)
    tp, tg = em_greeks.em_price_and_greeks(_pv(), 0, *KEY, N=N, n_paths=NP,
                                           rng=rng, fix_strike=fix_strike,
                                           device="cpu")
    assert float(tp) == pytest.approx(float(jp), rel=1e-5)
    assert list(tg) == list(em_greeks.PATHWISE_PARAMS)
    for name in tg:
        assert float(tg[name]) == pytest.approx(float(jg[name]), rel=1e-4,
                                                abs=1e-5), name
    # ATM-homogeneous delta is the price at S_0 = 1; fixed-strike ~ Phi(d1)
    if fix_strike:
        assert 0.4 < float(tg["S_0"]) < 0.75
    else:
        assert float(tg["S_0"]) == pytest.approx(float(tp), rel=1e-3)


def test_pathwise_price_is_the_conditional_estimator():
    price, _ = em_greeks.em_price_and_greeks(_pv(), 2, *KEY, N=N,
                                             n_paths=NP, device="cpu")
    m, _ = em_moments_scan(_pv(), N, path_index_grid(NP), 2, *KEY,
                           conditional=True)
    assert price.item() == pytest.approx(m.item(), rel=1e-6)


def test_law_build_on_cpu_is_path_law():
    kw = dict(N=12, n_paths=1024, device="cpu", rng="threefry4",
              poisson_cut=128.0)
    before = em_law_cuda.launches, em_moments_cuda.launches
    m, m2, v_T, vI = em_law_cuda(_pv(), KEY, 4, 512, **kw)
    path = path_index_grid(1024, 512)
    _, _, pT, pI, _ = path_law_from_consts(
        em_consts(_pv(), 12, 128.0), 12, path, torch.zeros_like(path), 4,
        *KEY, "threefry4")
    assert torch.equal(v_T, pT) and torch.equal(vI, pI)
    assert [m, m2] == list(em_moments_cuda(_pv(), KEY, 4, 512,
                                           conditional=True, **kw))
    assert (em_law_cuda.launches, em_moments_cuda.launches) == before
    with pytest.raises(ValueError, match="EM kernel takes"):
        em_law_cuda(_pv(), KEY, 4, 512, **{**kw, "rng": "xorwow"})


def test_crn_fd_matches_nmch_tpu():
    jf = jem.em_greeks_fd(P.as_array(), jnp.uint32(0), *KEY, N=N,
                          n_paths=NP)
    tf = em_greeks.em_greeks_fd(_pv(), 0, *KEY, N=N, n_paths=NP,
                                device="cpu")
    assert set(tf) == set(jf) == set(em_greeks.FD_PARAMS)
    for name in tf:
        assert float(tf[name]) == pytest.approx(float(jf[name]), abs=2e-3), \
            name


def test_crn_fd_of_the_trio_matches_pathwise():
    """For (S_0, r, rho) the variance path is parameter-free, so CRN
    central differences land on the pathwise gradient (O(h^2))."""
    _, g = em_greeks.em_price_and_greeks(_pv(), 0, *KEY, N=8, n_paths=4096,
                                         device="cpu")
    fd = em_greeks.em_greeks_fd(_pv(), 0, *KEY, N=8, n_paths=4096,
                                params=em_greeks.PATHWISE_PARAMS,
                                rel_bump=1e-3, device="cpu")
    for name in em_greeks.PATHWISE_PARAMS:
        assert float(g[name]) == pytest.approx(float(fd[name]), rel=5e-2,
                                               abs=5e-4), name


SHARE = 0.999       # paths whose counter and payoff agree (test_torch_em.py)
PATH_REL = 1e-4     # a path's payoff, torch's CPU log/exp vs XLA's


@functools.lru_cache(maxsize=None)
def _jax_cond_payoffs(n_paths):
    """nmch_tpu's per-path conditional payoffs and final counters at the
    strict cut (em_path_law, em_conditional_payoff), in one jitted
    function."""
    def f(pv, k0, k1):
        lo = j_path_index_grid(n_paths).astype(jnp.uint32)
        m, s, _, _, ctr = jem_law.em_path_law(pv, N, lo, jnp.zeros_like(lo),
                                              jnp.uint32(0), k0, k1)
        return jem_law.em_conditional_payoff(m, s, pv[1]), ctr
    return jax.jit(f)


@pytest.mark.parametrize("params,n_paths", [(P, NP), (UNDERFLOW, 2048)],
                         ids=["default", "gamma_underflow"])
def test_lrm_matches_nmch_tpu(params, n_paths):
    """Small Gamma shapes (d = 0.01) underflow v' to 0 on many lanes; the
    floors keep every score finite, as in nmch_tpu.

    Held per path as test_torch_em.py holds EM paths: each path's final
    counter and conditional payoff against nmch_tpu's, agreeing on >=
    SHARE of paths.  A flipped path (another sampler decision, from
    torch's CPU log/exp against XLA's) moves the estimators by its own
    terms, so they enter the bars as slack:
    * the price: the flipped paths' payoff differences over n_paths;
    * a Greek: the control variate's shift (those differences times the
      mean score), plus each flipped path's own explicit and score terms
      on either side, taken at the port's values (``lrm_scores_plain``).
    UNDERFLOW at 2048 paths flips one path (56): price slack 6.0e-6 (the
    price is 6.0e-6 apart), Greek slack from 8.6e-5 (k) to 2.7e-3 (theta,
    whose mean score is ~420; 2.3e-3 apart).  The default case flips
    none, so its bars stay rel 1e-5 and rel 1e-4 / abs 1e-5."""
    jp, jg = jlrm.em_greeks_lrm(params.as_array(), jnp.uint32(0), *KEY,
                                N=N, n_paths=n_paths)
    tp, tg = em_lrm.em_greeks_lrm(_pv(params), 0, *KEY, N=N,
                                  n_paths=n_paths, device="cpu")
    j_pay, j_ctr = (np.asarray(x).ravel() for x in _jax_cond_payoffs(
        n_paths)(params.as_array(), *KEY))
    t_pay, t_ctr = payoffs_from_consts(
        em_consts(_pv(params), N), N, path_index_grid(n_paths), 0, *KEY,
        "philox", True)
    t_pay, t_ctr = t_pay.numpy().ravel(), t_ctr.numpy().ravel()
    agree = (t_ctr == j_ctr.astype(np.int64)) & (
        np.abs(t_pay - j_pay) <= PATH_REL * np.abs(j_pay) + 1e-7)
    assert agree.mean() >= SHARE
    d_pay = (t_pay - j_pay).astype(np.float64)[~agree]
    slack = {name: 0.0 for name in tg}
    if d_pay.size:
        out = em_lrm.lrm_plain(_pv(params), KEY, 0, 0, N=N, n_paths=n_paths)
        scores = out[2:].reshape(5, -1).double().numpy()
        flip = np.flatnonzero(~agree)
        hc = np.abs(t_pay[flip] - float(tp))
        for f, h, dh in zip(flip, hc, np.abs(d_pay)):
            one = out[:, f // 128, f % 128].reshape(7, 1, 1)
            _, explicit = em_lrm.lrm_from_scores(_pv(params), N, one[0],
                                                 one[1], one[2:])
            for q, name in enumerate(tg):
                slack[name] += 2.0 * (abs(float(explicit[name]))
                                      + (h + dh) * abs(scores[q, f])) \
                    / n_paths
        for q, name in enumerate(tg):
            slack[name] += abs(d_pay.sum()) / n_paths * abs(
                scores[q].mean())
    assert abs(float(tp) - float(jp)) <= 1e-5 * abs(float(jp)) \
        + np.abs(d_pay).sum() / n_paths
    assert list(tg) == list(em_lrm.LRM_PARAMS)
    for name in tg:
        assert np.isfinite(float(tg[name])), name
        assert abs(float(tg[name]) - float(jg[name])) <= max(
            1e-4 * abs(float(jg[name])), 1e-5) + slack[name], name


def test_lrm_price_is_the_conditional_estimator():
    price, _ = em_lrm.em_greeks_lrm(_pv(), 1, *KEY, N=N, n_paths=4096,
                                    device="cpu")
    m, _ = em_moments_scan(_pv(), N, path_index_grid(4096), 1, *KEY,
                           conditional=True)
    assert price.item() == pytest.approx(m.item(), rel=1e-6)


def test_lrm_wrapper_on_cpu_is_the_plain_loop():
    before = em_lrm_scores_cuda.launches
    out = em_lrm_scores_cuda(_pv(UNDERFLOW), KEY, 3, 256, N=9, n_paths=512,
                             device="cpu", rng="threefry4")
    want = em_lrm.lrm_scores_plain(
        em_consts(_pv(UNDERFLOW), 9, None),
        em_lrm.lrm_jacobian(_pv(UNDERFLOW), 9), 9, path_index_grid(512, 256),
        3, *KEY, "threefry4")
    assert out.shape == (7, 4, 128) and torch.equal(out, want)
    assert bool(torch.isfinite(out).all())
    assert em_lrm_scores_cuda.launches == before
    with pytest.raises(ValueError, match="rng"):
        em_lrm_scores_cuda(_pv(), KEY, 0, 0, N=2, n_paths=128, device="cpu",
                           rng="xorwow")


def test_lrm_jacobian_matches_nmch_tpus():
    import jax
    p5 = jnp.asarray([P.T, P.v_0, P.k, P.theta, P.sigma], jnp.float32)
    want = np.asarray(jax.jacfwd(lambda q: jlrm._transition_consts(q, N))(
        p5))
    # torch's exp is not XLA's: one entry 5e-6 apart (relative)
    np.testing.assert_allclose(em_lrm.lrm_jacobian(_pv(), N).numpy(), want,
                               rtol=1e-5, atol=0)


def test_digamma_matches_scipy():
    z = torch.tensor(np.linspace(0.05, 100.0, 4001), dtype=torch.float32)
    got = em_lrm.digamma(z).double().numpy()
    assert np.abs(got - sp_digamma(z.double().numpy())).max() < 1e-6


def test_nmch_em_greeks_api_and_epochs():
    cfg = SimConfig(NTPB=128, NB=2, N=N)
    m = NMCH_EM(cfg, P, engine="scan", device="cpu")
    j = nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(NTPB=128, NB=2, N=N),
                         nmch_tpu.HestonParams(), engine="scan")
    with pytest.raises(RuntimeError, match="init"):
        m.greeks()
    m.init(3)
    j.init(3)
    with pytest.raises(ValueError, match="not both"):
        m.greeks(fd=True, lrm=True)
    for kw, epochs in (({}, 1), ({"fd": True}, 2), ({"lrm": True}, 2)):
        before = m.streams.epoch
        got, want = m.greeks(**kw), _floats(j.greeks(**kw))
        assert m.streams.epoch == before + epochs
        assert list(got) == list(want)
        assert got["price"] == pytest.approx(want["price"], rel=1e-5)
        for name in ("S_0", "r", "rho"):
            assert got[name] == pytest.approx(want[name], rel=1e-4,
                                              abs=1e-5), name
    # the streams line up after 5 epochs of Greeks
    assert m.compute().price == pytest.approx(j.compute().price, rel=1e-5)
    s = NMCH_EM(cfg, P, engine="scan", rng="xorwow", device="cpu")
    s.init(3)
    with pytest.raises(ValueError, match="counter rng"):
        s.greeks()


def test_lrm_vs_fd_table_on_cpu(capsys):
    """benchmarks/lrm_vs_fd.py's table from the port's script (plain
    versions on the CPU, tiny size): its header and one row per N and
    parameter, each with both estimators' mean +- std."""
    from nmch_tpu_torch.benchmarks import lrm_vs_fd
    assert lrm_vs_fd.main(["--device", "cpu", "--n-paths", "128",
                           "--epochs", "2", "--Ns", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "n_paths=128 epochs=2"
    assert lines[1].split() == ["N", "param", "oracle", "LRM", "mean+-std",
                                "CRN-FD", "mean+-std", "winner"]
    rows = [ln.split() for ln in lines[2:]]
    assert [(r[0], r[1]) for r in rows] == [
        ("2", p) for p in em_lrm.LRM_PARAMS]
    assert all(r[-1] in ("LRM", "FD") for r in rows)
