"""FE pathwise Greeks of the PyTorch port against nmch_tpu's jax.grad.

The reverse-mode golden (``ops/greeks.py``) and G1's plain version, the
forward-mode tangents (``ops/fe_greeks.py``), against
``nmch_tpu.ops.greeks.fe_price_and_greeks`` on the same (seed, epoch)
draws, N = 32 and 33 x 16,384 paths, every counter rng, both strike
conventions.  Stated tolerances (measured on the CPU, this file's cases):
the golden against nmch_tpu, price rel 1e-6, Greeks |diff| <= 4e-5 + 1e-4
|want| (max seen 1.2e-5, threefry4's sigma: the float64 sqrt derivative
and XLA's float32 one round apart on paths where v nears 0); forward mode
against the golden, price rel 1e-6, Greeks |diff| <= 5e-7 + 1e-5 |want|
(max seen 1.3e-7).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmch_tpu
from nmch_tpu.ops import greeks as jgreeks
from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig
from nmch_tpu_torch.ops import fe_greeks, greeks
from nmch_tpu_torch.ops.fe import fe_moments_scan, path_index_grid
from nmch_tpu_torch.ops.fe_greeks_cuda import fe_greeks_cuda
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

NP = 16384
KEY = tuple(int(w) for w in split_seed(1234))
EPOCH = 3
CASES = [(rng, fix, 32) for rng in greeks.COUNTER_RNGS
         for fix in (False, True)] + \
    [(rng, False, 33) for rng in greeks.COUNTER_RNGS]
CSRC = Path(greeks.__file__).resolve().parent.parent / "csrc"


def _pv(p=None):
    return (p or HestonParams()).as_tensor("cpu")


def _vec(price, g):
    return np.array([float(price)] + [float(g[n]) for n in
                                       greeks.PARAM_NAMES])


@pytest.fixture(scope="module")
def jax_greeks():
    """nmch_tpu's (price, 8 Greeks) per case, each compiled once."""
    out = {}
    for rng, fix, N in CASES:
        p, g = jgreeks.fe_price_and_greeks(
            HestonParams().as_array(), jnp.uint32(EPOCH), *KEY, N=N,
            n_paths=NP, rng=rng, fix_strike=fix)
        out[rng, fix, N] = _vec(p, g)
    return out


@pytest.fixture(scope="module")
def golden():
    return {(rng, fix, N): _vec(*greeks.fe_price_and_greeks(
        _pv(), EPOCH, *KEY, N=N, n_paths=NP, rng=rng, fix_strike=fix))
        for rng, fix, N in CASES}


def _close(got, want, atol, rtol):
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got[1:], want[1:], atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden_matches_nmch_tpu(case, golden, jax_greeks):
    _close(golden[case], jax_greeks[case], atol=4e-5, rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_mode_plain_matches_golden(case, golden, jax_greeks):
    rng, fix, N = case
    price, grads = fe_greeks.fe_greeks_plain(
        _pv(), KEY, EPOCH, 0, N=N, n_paths=NP, rng=rng, fix_strike=fix)
    got = np.array([price.item(), *grads.tolist()])
    _close(got, golden[case], atol=5e-7, rtol=1e-5)
    _close(got, jax_greeks[case], atol=4e-5, rtol=1e-4)


def test_golden_price_is_fe_moments_scans(golden):
    for N in (32, 33):
        m, _ = fe_moments_scan(_pv(), N, path_index_grid(NP), EPOCH, *KEY)
        assert golden["philox", False, N][0] == pytest.approx(m.item(),
                                                              rel=1e-6)


def test_delta_conventions_and_signs(golden):
    atm, fixed = golden["philox", False, 32], golden["philox", True, 32]
    # price is linear in S_0 at K = S_0, r = 0: dP/dS_0 = P at S_0 = 1
    assert atm[2] == pytest.approx(atm[0], rel=1e-4)
    assert 0.3 < fixed[2] < 0.8 and fixed[2] != atm[2]
    assert atm[3] > 0.0     # dP/dv_0
    # only delta sees the strike convention
    np.testing.assert_array_equal(np.delete(atm, 2), np.delete(fixed, 2))


def test_remat_matches_no_remat():
    kw = dict(N=32, n_paths=2048, rng="threefry4")
    p, g = greeks.fe_price_and_greeks(_pv(), 0, *KEY, remat=False, **kw)
    pr, gr = greeks.fe_price_and_greeks(_pv(), 0, *KEY, remat=True, **kw)
    assert p.item() == pr.item()
    for n in greeks.PARAM_NAMES:
        assert g[n].item() == pytest.approx(gr[n].item(), rel=1e-6,
                                            abs=1e-9), n
    # remat=None takes the checkpointed path above N = 512
    p5, g5 = greeks.fe_price_and_greeks(_pv(), 0, *KEY, N=513,
                                        n_paths=128)
    assert np.isfinite(_vec(p5, g5)).all()


def test_greeks_sweep_matches_single_points():
    pm = torch.stack([_pv(), _pv(HestonParams(k=2.0, sigma=0.5,
                                              theta=0.2))])
    for epoch0 in (5, 2**32 - 1):
        prices, grads = greeks.fe_greeks_sweep(pm, epoch0, *KEY, N=16,
                                               n_paths=2048)
        assert prices.shape == (2,) and grads.shape == (2, 8)
        for row in range(2):
            p1, g1 = greeks.fe_price_and_greeks(
                pm[row], (epoch0 + row) % 2**32, *KEY, N=16, n_paths=2048)
            assert prices[row].item() == p1.item()
            assert grads[row].tolist() == [g1[n].item()
                                           for n in greeks.PARAM_NAMES]


def test_sweep_row_matches_nmch_tpu_sweep():
    pm = np.stack([HestonParams().as_array(),
                   HestonParams(k=2.0, sigma=0.5, theta=0.2).as_array()])
    jp, jg = jgreeks.fe_greeks_sweep(jnp.asarray(pm), jnp.uint32(5), *KEY,
                                     N=16, n_paths=2048)
    tp, tg = greeks.fe_greeks_sweep(torch.from_numpy(pm), 5, *KEY, N=16,
                                    n_paths=2048)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=4e-5,
                               rtol=1e-4)


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    before = fe_greeks_cuda.launches
    kw = dict(N=17, n_paths=1024, rng="threefry", fix_strike=True)
    got = fe_greeks_cuda(_pv(), KEY, 7, 256, device="cpu", per_path=True,
                         **kw)
    want = fe_greeks.fe_greeks_plain(_pv(), KEY, 7, 256, per_path=True,
                                     **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2].shape == (9, 1024)
    assert fe_greeks_cuda.launches == before
    for rng in ("device", "xorwow"):
        with pytest.raises(ValueError, match="counter rng"):
            fe_greeks_cuda(_pv(), KEY, 0, 0, N=4, n_paths=128,
                           device="cpu", rng=rng)
    with pytest.raises(ValueError, match="multiple of 128"):
        fe_greeks_cuda(_pv(), KEY, 0, 0, N=4, n_paths=100, device="cpu")


def test_consts_jacobian_structure_and_kernel_masks():
    """The constants' Jacobian is zero outside _DEPS (checked inside), its
    T column is dense (at r != 0), and G1's compile-time masks are _DEPS
    and V_DIRS."""
    J = fe_greeks.consts_jacobian(_pv(HestonParams(r=0.05)), 33)
    assert J.shape == (6, 8) and bool((J[:, 0] != 0).all())
    src = (CSRC / "fe_greeks.cu").read_text()
    masks = {k: int(v, 16) for k, v in re.findall(
        r"constexpr unsigned (kDep\w+) = (0x[0-9A-F]+)u", src)}

    def bits(dirs):
        return sum(1 << d for d in dirs)
    deps = fe_greeks._DEPS
    assert masks == {"kDepV": bits(fe_greeks.V_DIRS),
                     "kDepA": bits(deps["A"]), "kDepB": bits(deps["B"]),
                     "kDepC": bits(deps["C"]),
                     "kDepRho": bits(deps["rho_sd"]),
                     "kDepR": bits(deps["one_rdt"])}
    assert deps["rho_sd"] == deps["rhoc_sd"]


def test_nmch_fe_greeks_api_and_epochs():
    cfg = SimConfig(NTPB=512, NB=4, N=16)
    m = NMCH_FE(cfg, HestonParams(), engine="scan", device="cpu")
    j = nmch_tpu.NMCH_FE(nmch_tpu.SimConfig(NTPB=512, NB=4, N=16),
                         nmch_tpu.HestonParams(), engine="scan")
    with pytest.raises(RuntimeError, match="init"):
        m.greeks()
    m.init(7)
    j.init(7)
    got, want = m.greeks(), j.greeks()
    assert list(got) == list(want) == ["price",
                                       *sorted(greeks.PARAM_NAMES)]
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               atol=4e-5, rtol=1e-4)
    # greeks() took epoch 0; compute() draws epoch 1 in both packages
    assert m.streams.epoch == 1
    assert m.compute().price == pytest.approx(j.compute().price, rel=1e-5)
    # any engine, rot or antithetic: the plain Euler paths of the rng
    r = NMCH_FE(cfg, HestonParams(), engine="cuda", rot=4, device="cpu")
    r.init(7)
    plain = NMCH_FE(cfg, HestonParams(), engine="scan", device="cpu")
    plain.init(7)
    assert r.greeks() == plain.greeks()
    for rng, engine in (("xorwow", "scan"), ("mrg32k3a", "cuda"),
                        ("device", "cuda")):
        s = NMCH_FE(cfg, HestonParams(), engine=engine, rng=rng,
                    device="cpu")
        s.init(7)
        with pytest.raises(ValueError, match="counter rng"):
            s.greeks()
