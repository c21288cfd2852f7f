"""Method layer of the PyTorch port against nmch_tpu's (lifecycle, stats
block, typed errors, stream continuation, checkpoints, oracles), for
NMCH_FE and NMCH_EM."""

import dataclasses
import io
import contextlib

import numpy as np
import pytest
import torch

import nmch_tpu
from nmch_tpu.oracle import black_scholes as j_bs
from nmch_tpu.oracle import heston as j_heston
from nmch_tpu import results as j_results
import nmch_tpu_torch
from nmch_tpu_torch import HestonParams, NMCH_EM, NMCH_FE, SimConfig, \
    SimResult
from nmch_tpu_torch.oracle import black_scholes as t_bs
from nmch_tpu_torch.oracle import heston as t_heston
from nmch_tpu_torch.rng.streams import PathStreams

torch.set_num_threads(2)

CFG = SimConfig(NTPB=256, NB=4, N=40)          # 1024 paths


def _pricer(**kw):
    return NMCH_FE(CFG, HestonParams(), **{"engine": "scan",
                                           "device": "cpu", **kw})


def test_lifecycle():
    m = _pricer()
    m.init(1234)
    res = m.compute()
    assert 0.05 < res.price < 0.2
    assert res.price_squared > res.price ** 2
    assert m.get_strike_price() == res.price
    assert m.get_price_squared() == res.price_squared
    assert m.get_err() == res.err > 0
    assert m.get_execution_time() > 0 and m.get_init_time() >= 0
    m.finalize()
    assert m.streams is None


def test_print_stats_byte_identical_to_nmch_tpu():
    res = SimResult(price=0.1234567, price_squared=0.0456789, n_paths=4096,
                    exec_time_ms=12.345678, init_time_ms=0.012345)
    params = dict(T=0.75, S_0=1.1, v_0=0.09, r=0.02, k=1.5, rho=-0.5,
                  theta=0.08, sigma=0.4)
    cfg = dict(NTPB=128, NB=32, N=250, seed=9)
    outs = []
    for pkg, m in ((nmch_tpu_torch, _pricer()),
                   (nmch_tpu, nmch_tpu.NMCH_FE(
                       nmch_tpu.SimConfig(), nmch_tpu.HestonParams(),
                       engine="scan"))):
        m.params = pkg.HestonParams(**params)
        m.cfg = pkg.SimConfig(**cfg)
        m.result = pkg.SimResult(**dataclasses.asdict(res))
        m.init_time_ms = res.init_time_ms
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.print_stats()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].startswith("Base parameters:\nNTPB    = 128\n")


def test_compute_before_init_raises():
    with pytest.raises(RuntimeError, match="init"):
        _pricer().compute()


@pytest.mark.parametrize("kw,match", [
    ({"rng": "device"}, "requires engine='cuda'"),
    ({"rng": "tpu", "engine": "cuda"}, "use rng='device'"),
    ({"rng": "tpu"}, "use rng='device'"),
    ({"rng": "mrg32k3a", "rot": 2}, "no rot/antithetic"),
    ({"rng": "xorwow", "antithetic": True}, "no rot/antithetic"),
    ({"rng": "bogus"}, "unknown rng"),
    ({"rot": 1, "antithetic": True}, "contradicts rot=1"),
    ({"rot": 3}, "rot must be"),
    ({"engine": "qmc", "rng": "device"}, "rng must stay 'philox'"),
    ({"engine": "qmc", "rot": 4}, "no rot/antithetic"),
    ({"engine": "qmc", "antithetic": True}, "no rot/antithetic"),
    ({"engine": "qmc", "rng": "threefry4"}, "rng must stay 'philox'"),
    ({"engine": "qmc", "scramble": "sobol"}, "unknown scramble"),
    ({"scramble": "owen"}, "engine='qmc' only"),
    ({"engine": "scan", "scramble": "shift"}, "engine='qmc' only"),
    ({"engine": "pallas"}, "unknown engine"),
    ({"device": "meta"}, "neither cpu nor cuda"),
    ({"rng": "xorwow", "rot": 8}, "no rot/antithetic"),
    ({"rot": 16}, "rot must be 1, 2, 4 or 8"),
])
def test_unsupported_options_raise_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        _pricer(**kw)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        NMCH_FE(CFG, HestonParams(), engine="cuda", device="cuda")
    with pytest.raises(RuntimeError):
        NMCH_FE(CFG, HestonParams())          # the defaults ask for a card


def test_setters_continue_streams_and_reinit_reproduces():
    m = _pricer()
    m.init(1234)
    p1 = m.compute().price
    p2 = m.compute().price
    assert p1 != p2                       # the stream continued
    m.set_theta(0.2)
    m.set_sigma(0.5)
    m.set_k(2.0)
    assert (m.params.theta, m.params.sigma, m.params.k) == (0.2, 0.5, 2.0)
    assert m.streams.epoch == 2
    assert np.isfinite(m.compute().price)
    m2 = _pricer()
    m2.init(1234)
    assert m2.compute().price == p1


def test_cuda_engine_on_cpu_equals_scan_engine():
    prices = []
    for engine in ("cuda", "scan"):
        m = _pricer(engine=engine)
        m.init(5)
        prices.append((m.compute().price, m.compute().price_squared))
    assert prices[0] == prices[1]


def test_threefry4_cuda_engine_on_cpu_equals_scan_engine():
    prices = []
    for engine in ("cuda", "scan"):
        m = _pricer(engine=engine, rng="threefry4")
        m.init(5)
        prices.append((m.compute().price, m.compute().price_squared))
    assert prices[0] == prices[1]
    m = _pricer()
    m.init(5)
    assert m.compute().price != prices[0][0]     # philox: another stream


ROT_CFG = SimConfig(NTPB=256, NB=4, N=10)      # 1024 groups


@pytest.mark.parametrize("kw,rel", [
    ({"antithetic": True}, 1e-5), ({"rot": 4}, 1e-5), ({"rot": 8}, 2e-4)])
def test_rotation_sampling_matches_nmch_tpu_scan(kw, rel):
    """NMCH_FE with rot 2 (antithetic), 4, 8 on the scan engine, and on
    the cuda engine's plain version (device cpu, bitwise the scan), price
    within rel 1e-5 of nmch_tpu's scan engine at two epochs (rot 8: rel
    2e-4, the jitted XLA rounding that tests/test_torch_rot.py measures;
    op by op the two agree within 1e-6)."""
    jm = nmch_tpu.NMCH_FE(nmch_tpu.SimConfig(NTPB=256, NB=4, N=10),
                          nmch_tpu.HestonParams(), engine="scan", **kw)
    jm.init(1234)
    want = [jm.compute() for _ in range(2)]
    for engine in ("scan", "cuda"):
        m = NMCH_FE(ROT_CFG, HestonParams(), engine=engine, device="cpu",
                    **kw)
        assert m.rot == jm.rot and m.antithetic == jm.antithetic
        m.init(1234)
        for w in want:
            got = m.compute()
            for a, b in ((got.price, w.price),
                         (got.price_squared, w.price_squared)):
                assert abs(a - b) <= rel * abs(b)


@pytest.mark.parametrize("kw", [{"rot": 4}, {"rot": 8}, {"rng": "threefry"},
                                {"rng": "threefry", "antithetic": True}])
def test_rot_and_threefry_cuda_engine_on_cpu_equals_scan_engine(kw):
    prices = []
    for engine in ("cuda", "scan"):
        m = _pricer(engine=engine, **kw)
        m.init(5)
        prices.append((m.compute().price, m.compute().price_squared))
    assert prices[0] == prices[1]
    m = _pricer()
    m.init(5)
    assert m.compute().price != prices[0][0]


def test_device_rng_on_the_cuda_engine_prices_within_oracle_bar():
    """rng="device" (cuda engine only; its plain version on the CPU) at
    rot 1 and 4: finite, reproducible, within 3 ci + 2e-3 of the oracle."""
    for rot in (1, 4):
        m = _pricer(engine="cuda", rng="device", rot=rot)
        m.init(1234)
        res = m.compute()
        m2 = _pricer(engine="cuda", rng="device", rot=rot)
        m2.init(1234)
        assert m2.compute().price == res.price
        oracle = t_heston.heston_call_undiscounted(m.params)
        assert abs(res.price - oracle) <= 3 * res.ci_error + 2e-3


def test_params_and_config_cross_package():
    jp = nmch_tpu.HestonParams(k=1.3, rho=0.2)
    tp_ = HestonParams.from_array(np.asarray(jp.as_array()))
    np.testing.assert_array_equal(tp_.as_array(), np.asarray(jp.as_array()))
    assert tp_.as_array().dtype == np.float32
    assert tp_.as_tensor("cpu").dtype == torch.float32
    assert dataclasses.asdict(HestonParams()) == \
        dataclasses.asdict(nmch_tpu.HestonParams())
    assert dataclasses.asdict(SimConfig()) == \
        dataclasses.asdict(nmch_tpu.SimConfig())
    assert SimConfig.from_n_paths(4096, NTPB=256).n_paths == 4096


def test_streams_state_dict_roundtrip():
    s = PathStreams(seed=2**40 + 3, n_paths=1024)
    s.next_epoch()
    s2 = PathStreams.from_state_dict(s.state_dict())
    assert s2 == s and s2.next_epoch() == 1
    assert tuple(map(int, s2.key_words)) == (3, 256)


@pytest.mark.parametrize("mean,mean_sq,n", [
    (0.1197, 0.0454, 1 << 18), (0.5, 0.2, 2), (0.3, 0.01, 100), (1.0, 1.0, 1),
])
def test_ci_formulas_equal_nmch_tpu(mean, mean_sq, n):
    for name in ("reference_err", "correct_ci_error"):
        a = getattr(nmch_tpu_torch, name)(mean, mean_sq, n)
        b = getattr(j_results, name)(mean, mean_sq, n)
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_oracles_equal_nmch_tpu():
    # one parameter set: each heston_call solves a 2000-node Gauss-Legendre
    # eigenproblem, which is slow under the parallel test run
    kw = {"k": 2.0, "theta": 0.05, "sigma": 0.6, "rho": 0.3, "r": 0.05,
          "T": 0.5}
    tp_, jp = HestonParams(**kw), nmch_tpu.HestonParams(**kw)
    assert t_heston.heston_call_undiscounted(tp_) == \
        j_heston.heston_call_undiscounted(jp)
    assert t_bs.reference_true_price(tp_.S_0, tp_.K, tp_.r, tp_.sigma) == \
        j_bs.reference_true_price(jp.S_0, jp.K, jp.r, jp.sigma)


def test_checkpoint_from_nmch_tpu_resumes_the_stream(tmp_path):
    """A checkpoint nmch_tpu writes after one compute() loads into the
    port, whose next price agrees with nmch_tpu's next price."""
    jcfg = nmch_tpu.SimConfig(NTPB=256, NB=4, N=40, seed=77)
    jm = nmch_tpu.NMCH_FE(jcfg, nmch_tpu.HestonParams(theta=0.12),
                          engine="scan")
    jm.init(77)
    jm.compute()
    path = tmp_path / "ckpt.json"
    jm.save_state(str(path))
    want = jm.compute().price

    m = _pricer()
    m.load_state(str(path))
    assert m.streams.epoch == 1 and m.params.theta == 0.12
    got = m.compute().price
    assert abs(got - want) <= 1e-5 * abs(want)

    # and the port's own checkpoint round-trips exactly
    m.save_state(str(path))
    m2 = _pricer()
    m2.load_state(str(path))
    assert m2.compute().price == m.compute().price


def test_rot4_checkpoint_from_nmch_tpu_resumes_the_stream(tmp_path):
    """A checkpoint nmch_tpu writes at rot 4 resumes the port's rot-4
    stream at the same epoch, with nmch_tpu's next moments (rel 1e-5), on
    the scan engine and the cuda engine's plain version."""
    jm = nmch_tpu.NMCH_FE(nmch_tpu.SimConfig(NTPB=256, NB=4, N=10, seed=77),
                          nmch_tpu.HestonParams(theta=0.12), engine="scan",
                          rot=4)
    jm.init(77)
    jm.compute()
    path = tmp_path / "ckpt.json"
    jm.save_state(str(path))
    want = jm.compute()
    for engine in ("scan", "cuda"):
        m = NMCH_FE(ROT_CFG, HestonParams(), engine=engine, device="cpu",
                    rot=4)
        m.load_state(str(path))
        assert m.streams.epoch == 1 and m.params.theta == 0.12
        got = m.compute()
        assert abs(got.price - want.price) <= 1e-5 * want.price
        assert abs(got.price_squared - want.price_squared) <= \
            1e-5 * want.price_squared


def test_save_before_init_raises(tmp_path):
    with pytest.raises(RuntimeError):
        _pricer().save_state(str(tmp_path / "x.json"))


# --- NMCH_EM ------------------------------------------------------------

EM_CFG = SimConfig(NTPB=256, NB=4, N=8)       # 1024 paths


def _em(**kw):
    return NMCH_EM(EM_CFG, HestonParams(), **{"engine": "scan",
                                              "device": "cpu", **kw})


@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", True)])
def test_em_lifecycle_and_stream_continuation(rng, conditional):
    m = _em(rng=rng, conditional=conditional)
    with pytest.raises(RuntimeError, match="init"):
        m.compute()
    m.init(1234)
    r1 = m.compute()
    r2 = m.compute()
    assert r1.price != r2.price                  # the stream continued
    assert 0.05 < r1.price < 0.25 and r1.price_squared > r1.price ** 2
    assert m.get_err() == r2.err > 0 and m.streams.epoch == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m.print_stats()
    assert "METHOD: EXACT-METHOD" in buf.getvalue()
    m.finalize()
    assert m.streams is None
    m2 = _em(rng=rng, conditional=conditional)
    m2.init(1234)
    assert m2.compute().price == r1.price


def test_em_print_stats_byte_identical_to_nmch_tpu():
    res = SimResult(price=0.1234567, price_squared=0.0456789, n_paths=4096,
                    exec_time_ms=12.345678, init_time_ms=0.012345)
    outs = []
    for pkg, m in ((nmch_tpu_torch, _em()),
                   (nmch_tpu, nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(),
                                               nmch_tpu.HestonParams(),
                                               engine="scan"))):
        m.params = pkg.HestonParams(theta=0.08, sigma=0.4)
        m.cfg = pkg.SimConfig(NTPB=128, NB=32, N=250, seed=9)
        m.result = pkg.SimResult(**dataclasses.asdict(res))
        m.init_time_ms = res.init_time_ms
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.print_stats()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw,match", [
    ({"rng": "mrg32k3a", "engine": "cuda"}, "requires engine='scan'"),
    ({"rng": "xorwow", "engine": "cuda"}, "requires engine='scan'"),
    ({"rng": "tpu"}, "unknown rng"),
    ({"rng": "threefry"}, "unknown rng"),
    ({"engine": "pallas"}, "unknown engine"),
    ({"device": "meta"}, "neither cpu nor cuda"),
])
def test_em_unsupported_options_raise_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        _em(**kw)


def test_em_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        NMCH_EM(EM_CFG, HestonParams())           # the defaults ask for a card


def test_em_poisson_cut_default_is_the_method_layers_128():
    assert _em().poisson_cut == 128.0 == \
        nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(), nmch_tpu.HestonParams(),
                         engine="scan").poisson_cut
    assert _em(poisson_cut=4000).poisson_cut == 4000.0
    # at N=100 (lambda ~ 220) the default's normal branch draws another
    # stream than curand's 4000 (PTRS)
    cfg = SimConfig(NTPB=128, NB=1, N=100)
    prices = []
    for cut in (None, 128.0, 4000.0):
        m = NMCH_EM(cfg, HestonParams(), engine="scan", device="cpu",
                    poisson_cut=cut)
        m.init(3)
        prices.append(m.compute().price)
    assert prices[0] == prices[1] != prices[2]


def test_em_greeks_keys_match_nmch_tpus():
    """NMCH_EM.greeks's keys, in nmch_tpu's order, for the pathwise and
    the LRM estimators (fd: tests/test_torch_cli.py), and its checks'
    words."""
    cfg = SimConfig(NTPB=128, NB=1, N=4)
    m = NMCH_EM(cfg, HestonParams(), engine="cuda", device="cpu")
    j = nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(NTPB=128, NB=1, N=4),
                         nmch_tpu.HestonParams(), engine="scan")
    m.init(5)
    j.init(5)
    for kw in ({}, {"lrm": True}):
        assert list(m.greeks(**kw)) == list(j.greeks(**kw))
    with pytest.raises(ValueError, match="not both"):
        m.greeks(fd=True, lrm=True)


def test_em_cuda_engine_on_cpu_equals_scan_engine():
    prices = []
    for engine in ("cuda", "scan"):
        m = _em(engine=engine, poisson_cut=16.0)
        m.init(5)
        prices.append((m.compute().price, m.compute().price_squared))
    assert prices[0] == prices[1]


@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", True)])
def test_em_checkpoint_from_nmch_tpu_resumes_the_stream(tmp_path, rng,
                                                        conditional):
    """A checkpoint nmch_tpu's NMCH_EM writes after one compute() loads
    into the port at the same epoch, whose next price agrees with
    nmch_tpu's next price (measured: rel 2e-8 to 1e-7)."""
    jm = nmch_tpu.NMCH_EM(nmch_tpu.SimConfig(NTPB=256, NB=4, N=8, seed=77),
                          nmch_tpu.HestonParams(theta=0.12), engine="scan",
                          rng=rng, conditional=conditional)
    jm.init(77)
    jm.compute()
    path = tmp_path / "ckpt.json"
    jm.save_state(str(path))
    epoch = jm.streams.epoch
    want = jm.compute().price

    m = _em(rng=rng, conditional=conditional)
    m.load_state(str(path))
    assert m.streams.epoch == epoch == 1 and m.params.theta == 0.12
    got = m.compute().price
    assert abs(got - want) <= 1e-5 * abs(want)


# --- NMCH_FE(engine="qmc") -----------------------------------------------

QMC_CFG = SimConfig(NTPB=256, NB=8, N=16)     # 2048 points, 8 replicates


def test_qmc_lifecycle_streams_and_synthesized_moments():
    m = _pricer(engine="qmc")
    m.cfg = QMC_CFG
    assert m.scramble == "lms-shift" and m.synthesized_moments
    m.init(1234)
    r1, r2 = m.compute(), m.compute()
    assert r1.price != r2.price and m.streams.epoch == 2
    assert r1.synthesized_moments and np.isnan(r1.err) and r1.ci_error > 0
    oracle = t_heston.heston_call_undiscounted(m.params)
    assert abs(r1.price - oracle) < 4 * r1.ci_error + 2e-3
    m2 = _pricer(engine="qmc")
    m2.cfg = QMC_CFG
    m2.init(1234)
    assert m2.compute().price == r1.price
    # the other engines keep accumulated moments
    assert not _pricer().synthesized_moments


@pytest.mark.parametrize("scramble,n_paths,want", [
    ("auto", 1 << 21, "owen"), ("auto", (1 << 21) - 1024, "lms-shift"),
    ("shift", 1 << 21, "shift"), ("lms-shift", 1 << 21, "lms-shift"),
])
def test_qmc_scramble_auto_resolution_matches_nmch_tpu(scramble, n_paths,
                                                       want):
    """Constructed, not run: "auto" is owen from 2^21 points, as in
    nmch_tpu; non-qmc engines resolve to the lms-shift passthrough."""
    cfg = SimConfig.from_n_paths(n_paths, NTPB=1024)
    got = NMCH_FE(cfg, HestonParams(), engine="qmc", device="cpu",
                  scramble=scramble).scramble
    jcfg = nmch_tpu.SimConfig(NTPB=cfg.NTPB, NB=cfg.NB, N=cfg.N)
    assert got == want == nmch_tpu.NMCH_FE(
        jcfg, nmch_tpu.HestonParams(), engine="qmc",
        scramble=scramble).scramble
    assert _pricer(scramble="lms-shift").scramble == "lms-shift"


def test_qmc_print_stats_byte_identical_to_nmch_tpu():
    """The synthesized-moments branch prints the RQMC CI in place of the
    reference err."""
    res = SimResult(price=0.1197, price_squared=0.0144, n_paths=1 << 18,
                    exec_time_ms=250.5, init_time_ms=0.01,
                    synthesized_moments=True)
    outs = []
    for pkg, m in ((nmch_tpu_torch, _pricer(engine="qmc")),
                   (nmch_tpu, nmch_tpu.NMCH_FE(
                       nmch_tpu.SimConfig(), nmch_tpu.HestonParams(),
                       engine="qmc"))):
        m.cfg = pkg.SimConfig()
        m.result = pkg.SimResult(**dataclasses.asdict(res))
        m.init_time_ms = res.init_time_ms
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.print_stats()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "= n/a (RQMC replicate CI: " in outs[0]
