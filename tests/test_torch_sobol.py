"""Sobol' points and their randomizations in the PyTorch port, bitwise
against nmch_tpu's (rng/sobol.py), and the QMC engine's inverse normal CDF
(rng/normal.py::ndtri_fast_pm) within 1 ulp of nmch_tpu's."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import ndtri as scipy_ndtri

from nmch_tpu.rng import normal as jn
from nmch_tpu.rng import sobol as js
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch.rng import normal as tn
from nmch_tpu_torch.rng import sobol as ts

torch.set_num_threads(2)

K0, K1 = (int(w) for w in split_seed(1234))
EDGE = np.array([0, 1, 2**29 - 1, 2**29, 2**30 - 2, 2**30 - 1], np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _words(seed: int, shape, high: int = 2**30) -> np.ndarray:
    w = np.random.default_rng(seed).integers(0, high, size=shape,
                                             dtype=np.uint64)
    w = w.astype(np.uint32)
    w.reshape(-1)[:len(EDGE)] = EDGE
    return w


def test_direction_numbers_equal_nmch_tpu_and_scipy():
    v = ts.direction_numbers(64)
    assert v.dtype == np.uint32 and v.shape == (64, 30)
    np.testing.assert_array_equal(v, js.direction_numbers(64))
    from scipy.stats import qmc
    x = ts.sobol_dims_u32(ts.gray_codes(1 << 10), ts.direction_numbers(16))
    np.testing.assert_array_equal(
        x.numpy().T / 2.0 ** 30,
        qmc.Sobol(d=16, scramble=False).random_base2(10))


@pytest.mark.parametrize("n,base", [(4096, 0), (4096, 3 * 4096),
                                    (8 * 2048, 8192), (2000, 0), (96, 32)])
def test_sobol_words_bitwise(n, base):
    """Direct ladder and hi/lo factoring, with a base offset, and the
    unaligned n = 2000 (16-point low blocks)."""
    v = js.direction_numbers(32)
    g = ts.gray_codes(n, base)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(js.gray_codes(n, base=jnp.uint32(base))))
    want = np.asarray(js.sobol_dims_u32_hilo(n, v, base=jnp.uint32(base)))
    np.testing.assert_array_equal(ts.sobol_dims_u32_hilo(n, v, base=base)
                                  .numpy(), want)
    np.testing.assert_array_equal(ts.sobol_dims_u32(g, _t(v)).numpy(), want)


@pytest.mark.parametrize("epoch", [0, 1, 2**32 - 1])
def test_digital_shifts_and_owen_seeds_bitwise(epoch):
    reps = (np.arange(8, dtype=np.uint64) + epoch * 8) % 2**32
    d_j = jnp.arange(64, dtype=jnp.uint32)[:, None]
    r_j = jnp.asarray(reps.astype(np.uint32))[None, :]
    d_t, r_t = torch.arange(64)[:, None], _t(reps)[None, :]
    s = ts.digital_shifts(d_t, r_t, K0, K1)
    assert s.shape == (64, 8) and int(s.max()) < 2**30
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(js.digital_shifts(d_j, r_j, K0, K1)))
    np.testing.assert_array_equal(
        ts.owen_seeds(d_t, r_t, K0, K1).numpy(),
        np.asarray(js.owen_seeds(d_j, r_j, K0, K1)))
    # the scalar-epoch form of the scatter bridge's shifts
    np.testing.assert_array_equal(
        ts.digital_shifts(torch.arange(64), epoch, K0, K1).numpy(),
        np.asarray(js.digital_shifts(jnp.arange(64, dtype=jnp.uint32),
                                     jnp.uint32(epoch), K0, K1)))


@pytest.mark.parametrize("epoch", [0, 7, 2**32 - 1])
def test_lms_scramble_directions_bitwise(epoch):
    v = js.direction_numbers(64)
    got = ts.lms_scramble_directions(v, epoch, K0, K1)
    want = np.asarray(js.lms_scramble_directions(v, jnp.uint32(epoch), K0,
                                                 K1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != v).mean() > 0.5


def test_parity_is_popcount_low_bit():
    w = _words(3, (1 << 12,), 2**32)
    want = np.array([bin(int(x)).count("1") & 1 for x in w])
    np.testing.assert_array_equal(ts._parity(_t(w)).numpy(), want)


def test_reverse_bits_and_owen_scramble_bitwise():
    w32 = _words(4, (1 << 12,), 2**32)
    w32[-2:] = [0xFFFFFFFF, 0x80000001]
    np.testing.assert_array_equal(
        ts._reverse_bits32(_t(w32)).numpy(),
        np.asarray(js._reverse_bits32(jnp.asarray(w32))))
    x = _words(5, (16, 1 << 10))
    seed = _words(6, (16, 1), 2**32)
    seed[0, 0] = 0xFFFFFFFF
    got = ts.owen_scramble(_t(x), _t(seed))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(js.owen_scramble(jnp.asarray(x), jnp.asarray(seed))))
    assert int(got.max()) < 2**30


def test_mul_lo32_is_the_u32_product():
    a = _words(7, (1 << 12,), 2**32)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6, 0xFFFFFFFF):
        want = (a.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(ts._mul_lo32(_t(a), c).numpy(),
                                      want.astype(np.int64))


def test_pm_sign_and_u01_from_words_bitwise():
    x = _words(8, (1 << 14,))
    pm_j, neg_j = js.pm_sign_from_words(jnp.asarray(x))
    pm_t, neg_t = ts.pm_sign_from_words(_t(x))
    assert pm_t.dtype == torch.float32
    np.testing.assert_array_equal(pm_t.numpy().view(np.uint32),
                                  np.asarray(pm_j).view(np.uint32))
    np.testing.assert_array_equal(neg_t.numpy(), np.asarray(neg_j))
    u_t = ts.u01_from_words(_t(x))
    np.testing.assert_array_equal(
        u_t.numpy().view(np.uint32),
        np.asarray(js.u01_from_words(jnp.asarray(x))).view(np.uint32))
    assert float(u_t.min()) > 0 and float(u_t.max()) < 1


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def test_ndtri_fast_pm_within_one_ulp_of_nmch_tpu():
    """Over every pm the Sobol' map emits near both tails, the split at
    s = 2.6, and random words; also accurate against scipy."""
    x = np.concatenate([_words(9, (1 << 16,)),
                        np.arange(2**16, dtype=np.uint32),
                        (2**29 - 1 - np.arange(2**12)).astype(np.uint32)])
    pm = ts.pm_sign_from_words(_t(x))[0]
    pm = torch.cat([pm, torch.tensor([2.0 ** -31, 2.0 ** -30, 0.0045,
                                      0.0046, 0.5], dtype=torch.float32)])
    got = tn.ndtri_fast_pm(pm).numpy()
    want = np.asarray(jn.ndtri_fast_pm(jnp.asarray(pm.numpy())))
    assert got.dtype == np.float32
    assert _ulps(got, want) <= 1
    # against scipy over nmch_tpu's range (its bar, tests/test_qmc.py, is
    # 5e-6 on random u; the words just below 2^29, pm -> 1/2, reach 6.9e-6
    # in both packages)
    exact = -scipy_ndtri(pm.numpy().astype(np.float64))
    keep = pm.numpy() >= 2.0 ** -24
    assert np.abs(got[keep] - exact[keep]).max() < 1e-5


def test_ndtri_fast_within_one_ulp_of_nmch_tpu():
    u = np.random.default_rng(10).uniform(2**-24, 1 - 2**-24, 1 << 16)
    u = np.concatenate([u, [2**-24, 0.5, 1 - 2**-24]]).astype(np.float32)
    got = tn.ndtri_fast(torch.from_numpy(u)).numpy()
    assert _ulps(got, np.asarray(jn.ndtri_fast(jnp.asarray(u)))) <= 1
