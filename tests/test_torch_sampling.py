"""Poisson and Gamma samplers of the PyTorch port against nmch_tpu's.

Per lane, over 4096 lanes with staggered start counters (measured on the
CPU, philox and threefry4 alike):

* Poisson, lam in {3, 30, 300, 5000} (Knuth, PTRS, normal approximation),
  cut None and 128: N_p and the final counter equal on 100% of lanes;
* Gamma, alpha in {0.3, 2.5, 40}: the final counter equal on 100% of
  lanes; gamma bitwise equal on 58% / 84% / 97% of lanes and within rel
  4.3e-6 on all: torch's CPU log/exp/rsqrt are not XLA's, and the
  alpha < 1 boost U^(1/alpha) amplifies their last-bit differences.

The bar is 99.9% of lanes (a rounding difference may flip one lane's
accept/reject decision), and rel 1e-5 for gamma.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.ops import sampling as js
from nmch_tpu_torch.ops import sampling as ts

torch.set_num_threads(2)

SHAPE = (32, 128)
N_LANES = SHAPE[0] * SHAPE[1]
PATH_LO = (np.arange(N_LANES, dtype=np.uint32) * 7 + 11).reshape(SHAPE)
CTR0 = (np.arange(N_LANES, dtype=np.uint32) % 5).reshape(SHAPE)
K0, K1 = 0x1234, 0xABCD
SHARE = 0.999


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_poisson(cut, rng):
    return jax.jit(lambda lam, ctr, ep: js.poisson_from_stream(
        lam, ctr, ep, jnp.asarray(PATH_LO), jnp.zeros(SHAPE, jnp.uint32),
        K0, K1, rng=rng, large_cut=cut))


@functools.lru_cache(maxsize=None)
def _jax_gamma(rng):
    return jax.jit(lambda a, ctr, ep: js.gamma_ms_from_stream(
        a, ctr, ep, jnp.asarray(PATH_LO), jnp.zeros(SHAPE, jnp.uint32),
        K0, K1, rng=rng))


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("cut", [None, 128.0])
@pytest.mark.parametrize("lam", [3.0, 30.0, 300.0, 5000.0])
def test_poisson_per_lane_matches_nmch_tpu(lam, cut, rng):
    # +-1% spread so that lanes differ in lambda as they do in a path
    lamv = (np.full(SHAPE, lam, np.float32)
            * (1 + 0.01 * np.sin(np.arange(N_LANES))).reshape(SHAPE)
            ).astype(np.float32)
    want, want_ctr = _jax_poisson(cut, rng)(jnp.asarray(lamv),
                                            jnp.asarray(CTR0), jnp.uint32(2))
    got, got_ctr = ts.poisson_from_stream(
        torch.from_numpy(lamv), _t(CTR0), 2, _t(PATH_LO),
        torch.zeros(SHAPE, dtype=torch.int64), K0, K1, rng=rng,
        large_cut=cut)
    assert got.dtype == torch.float32 and got_ctr.dtype == torch.int64
    assert (np.asarray(want) == got.numpy()).mean() >= SHARE
    assert (np.asarray(want_ctr).astype(np.int64)
            == got_ctr.numpy()).mean() >= SHARE
    assert (got_ctr.numpy() > CTR0).all()      # every lane drew a block


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("alpha", [0.3, 2.5, 40.0])
def test_gamma_per_lane_matches_nmch_tpu(alpha, rng):
    av = np.full(SHAPE, alpha, np.float32)
    want, want_ctr = _jax_gamma(rng)(jnp.asarray(av), jnp.asarray(CTR0),
                                     jnp.uint32(5))
    got, got_ctr = ts.gamma_ms_from_stream(
        torch.from_numpy(av), _t(CTR0), 5, _t(PATH_LO),
        torch.zeros(SHAPE, dtype=torch.int64), K0, K1, rng=rng)
    want = np.asarray(want)
    close = np.abs(want - got.numpy()) <= 1e-5 * np.abs(want)
    assert close.mean() >= SHARE
    assert (np.asarray(want_ctr).astype(np.int64)
            == got_ctr.numpy()).mean() >= SHARE
    assert (got.numpy() > 0).all()


def test_poisson_cut_below_ten_keeps_knuth():
    """At a cut below 10, lanes under lam = 10 stay on Knuth (the JAX
    code's select order: small first), the rest take the normal branch."""
    lamv = np.where(np.arange(N_LANES) % 2, 3.0, 50.0).astype(
        np.float32).reshape(SHAPE)
    want, want_ctr = _jax_poisson(5.0, "philox")(
        jnp.asarray(lamv), jnp.asarray(CTR0), jnp.uint32(0))
    got, got_ctr = ts.poisson_from_stream(
        torch.from_numpy(lamv), _t(CTR0), 0, _t(PATH_LO),
        torch.zeros(SHAPE, dtype=torch.int64), K0, K1, large_cut=5.0)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(np.asarray(want_ctr).astype(np.int64),
                                  got_ctr.numpy())


def test_lgamma_kp1_matches_nmch_tpu():
    """rel 1e-6 of the Stirling term's size |zz ln zz| (plus the value):
    near k ~ 0.5 the shifted form cancels O(1) terms to -0.12, where the
    plain relative difference reaches 2e-6 (measured: 9.9e-8 on the
    scaled bar; 2.2e-7 plain relative for k >= 3)."""
    rng = np.random.default_rng(3)
    ks = np.concatenate([
        np.array([0, 0.5, 1, 2, 2.7, 3.2, 5, 8, 9, 20, 47.3, 100, 200, 1000,
                  2500, 4000, 5000], np.float32),
        (rng.random(4096) * 6000).astype(np.float32)])
    want = np.asarray(jax.jit(js.lgamma_kp1)(jnp.asarray(ks)))
    got = ts.lgamma_kp1(torch.from_numpy(ks)).numpy()
    zz = ks.astype(np.float64) + 3
    scale = np.abs(want) + zz * np.log(zz)
    assert (np.abs(want - got) <= 1e-6 * scale).all()
    big = ks >= 3
    assert (np.abs(want - got)[big] <= 1e-6 * np.abs(want[big])).all()
    for k, g in zip(ks[:17], got[:17]):
        assert abs(g - math.lgamma(k + 1)) <= 1e-4 * max(1.0, abs(g))


@pytest.mark.parametrize("lam", [10.0, 35.0, 300.0, 1500.0, 3999.0])
def test_ptrs_log_accept_rhs_matches_nmch_tpu(lam):
    """rel 1e-6 of the size of the terms that cancel (|value| + |w - lam|,
    the O(sqrt(lam)) pair of the cancellation-free form): the value is
    O(1-10) after they cancel, where the plain relative difference
    reaches 1.9e-6 at lam = 3999 (measured: 1.1e-7 on the scaled bar)."""
    rng = np.random.default_rng(int(lam))
    kfs = np.maximum(np.floor(lam + math.sqrt(lam) * rng.normal(size=4096)),
                     0.0).astype(np.float32)
    kfs[:3] = [0.0, 1.0, 2.0]
    lamf, loglam = np.float32(lam), np.float32(math.log(lam))
    want = np.asarray(jax.jit(js.ptrs_log_accept_rhs)(
        jnp.asarray(kfs), jnp.float32(lamf), jnp.float32(loglam)))
    got = ts.ptrs_log_accept_rhs(torch.from_numpy(kfs), float(lamf),
                                 float(loglam)).numpy()
    scale = np.abs(want) + np.abs(kfs + 1.0 - lamf)
    assert (np.abs(want - got) <= 1e-6 * scale).all()


def test_ptrs_constants_are_true_float32_divisions():
    """PTRS's b, a, 1/alpha and v_r bitwise nmch_tpu's float32 arithmetic
    (numpy's, IEEE like XLA's and the kernel's) over lam in [10, 4000];
    the reciprocal-times-number form that a Python number over a tensor
    gives in torch is not (it moved the plain version off the card's
    kernel at explore's point (0.1, 0.5, 1.0), N=1000)."""
    lam = np.linspace(10.0, 4000.0, 1 << 16, dtype=np.float32)
    s_np = np.sqrt(lam.astype(np.float64)).astype(np.float32)
    f = np.float32
    b = f(0.931) + f(2.53) * s_np
    want = (b, f(-0.059) + f(0.02483) * b,
            f(1.1239) + f(1.1328) / (b - f(3.4)),
            f(0.9277) - f(3.6224) / (b - f(2.0)))
    got = ts.ptrs_constants(torch.from_numpy(s_np))
    for w, g in zip(want, got):
        assert np.array_equal(w.view(np.uint32), g.numpy().view(np.uint32))
    bt = torch.from_numpy(b)
    assert not torch.equal(1.1328 / (bt - 3.4),
                           torch.full_like(bt, 1.1328) / (bt - 3.4))


@pytest.mark.parametrize("rng,match", [
    ("mrg32k3a", "stateful family"), ("xorwow", "stateful family"),
    ("tpu", "unknown"),
])
def test_lane_draw_refuses_other_rngs(rng, match):
    """No lane draw at a counter for a stateful family (it draws from a
    state, make_stream_draw4) or an unknown rng; the stream draw takes the
    stateful families and refuses the rest."""
    with pytest.raises(ValueError, match=match):
        ts.make_lane_draw4(rng)
    if rng in ts.STATEFUL_RNGS:
        st = tuple(_t(np.array([1, 2, 3])) for _ in range(6))
        *ws, nxt = ts.make_stream_draw4(rng, 0, 0, 0, 0, 0)(st)
        assert len(ws) == 4 and len(nxt) == 6
        return
    with pytest.raises(ValueError, match=match):
        ts.make_stream_draw4(rng, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
def test_stream_draw_is_lane_draw_plus_one(rng):
    ctr = _t(np.array([0, 5, 2**32 - 1]))
    lo = _t(np.array([3, 4, 5]))
    w = ts.make_lane_draw4(rng)(ctr, 7, lo, 0, K0, K1)
    *ws, nxt = ts.make_stream_draw4(rng, 7, lo, 0, K0, K1)(ctr)
    assert all(torch.equal(a, b) for a, b in zip(w, ws))
    assert nxt.tolist() == [1, 6, 0]          # u32 wraparound
