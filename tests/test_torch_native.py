"""The port's binding of the native C++ library (``nmch_tpu_torch/native.py``).

The cases of ``tests/test_native.py`` against the port's oracle,
``results.py`` and EM engine, each also checking that the port's binding
returns what ``nmch_tpu.native`` returns for the same inputs.  The library
is built by the port's locked loader in a module fixture, not while the
file is collected, and only then is ``nmch_tpu.native`` called, so this
file adds no concurrent ``make`` of its own.  It skips only when the
build fails.
"""

import math

import numpy as np
import pytest
import torch

from nmch_tpu import native as jax_native
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu_torch import native
from nmch_tpu_torch.oracle import heston_call as py_heston, norm_cdf_as
from nmch_tpu_torch.ops.em import em_moments_scan
from nmch_tpu_torch.ops.fe import path_index_grid
from nmch_tpu_torch.params import HestonParams
from nmch_tpu_torch.results import reference_err
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

PARAMS = [
    {},
    dict(k=2.0, theta=0.04, sigma=0.5, rho=-0.3, v_0=0.04),
    dict(r=0.03, T=2.0),
    dict(sigma=1.0, theta=0.01, k=1.0),   # Feller violated
]


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("make -C native failed (no C++ toolchain)")
    if jax_native._lib is None:
        # this process tried nmch_tpu's loader while collecting
        # tests/test_native.py, perhaps while another worker's make was
        # still writing; the library is in place now
        jax_native._tried = False
    assert jax_native.load() is not None
    return lib


@pytest.mark.parametrize("kw", PARAMS)
def test_native_oracle_matches_python(lib, kw):
    p = HestonParams(**kw)
    got = native.heston_call(p)
    assert got == pytest.approx(py_heston(p), abs=1e-9)
    assert got == jax_native.heston_call(JHestonParams(**kw))


def test_native_norm_cdf_parity(lib):
    for x in (-3.0, -0.5, 0.0, 0.7, 2.5, 11.0):
        assert lib.nmch_norm_cdf_as(x) == pytest.approx(norm_cdf_as(x),
                                                        abs=1e-12)
        assert lib.nmch_norm_cdf_as(x) == \
            jax_native.load().nmch_norm_cdf_as(x)


def test_native_reference_err_parity(lib):
    got = native.reference_err_native(0.12, 0.045, 262144)
    assert got == pytest.approx(reference_err(0.12, 0.045, 262144),
                                rel=1e-12)
    assert got == jax_native.reference_err_native(0.12, 0.045, 262144)


def test_cpu_mc_validates_oracle(lib):
    """Fully independent path: C++ Euler + xoshiro vs semi-analytic."""
    p = HestonParams()
    m, m2 = native.cpu_fe_moments(p, N=200, n_paths=20000, seed=7)
    err = reference_err(m, m2, 20000)
    assert abs(m - py_heston(p)) < 3 * err + 2e-3   # CI + Euler bias
    assert (m, m2) == jax_native.cpu_fe_moments(JHestonParams(), N=200,
                                                n_paths=20000, seed=7)


def test_cpu_mc_deterministic_per_seed(lib):
    p = HestonParams()
    a = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=42)
    b = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=42)
    c = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=43)
    assert a == b
    assert a != c
    assert a == jax_native.cpu_fe_moments(JHestonParams(), N=50,
                                          n_paths=2000, seed=42)


def test_cpu_em_validates_oracle(lib):
    """The independent C++ Broadie-Kaya pricer (libstdc++ poisson/gamma
    samplers) lands on the semi-analytic price."""
    p = HestonParams()
    m, m2 = native.cpu_em_moments(p, N=100, n_paths=20000, seed=7)
    err = reference_err(m, m2, 20000)
    assert abs(m - py_heston(p)) < 3 * err + 1e-3
    assert (m, m2) == jax_native.cpu_em_moments(JHestonParams(), N=100,
                                                n_paths=20000, seed=7)


def test_cpu_em_conditional_tightens_ci(lib):
    p = HestonParams()
    m_s, m2_s = native.cpu_em_moments(p, N=64, n_paths=20000, seed=9)
    m_c, m2_c = native.cpu_em_moments(p, N=64, n_paths=20000, seed=9,
                                      conditional=True)
    e_s = reference_err(m_s, m2_s, 20000)
    e_c = reference_err(m_c, m2_c, 20000)
    assert abs(m_c - m_s) < 3 * math.hypot(e_s, e_c)
    assert e_c < e_s
    assert (m_c, m2_c) == jax_native.cpu_em_moments(
        JHestonParams(), N=64, n_paths=20000, seed=9, conditional=True)


def test_cpu_em_cross_validates_port_engine(lib):
    """Native C++ EM vs the port's EM golden: two implementations of the
    same exact scheme (other samplers, other RNGs) agree within their
    combined CIs."""
    p = HestonParams()
    n = 16384
    m_n, m2_n = native.cpu_em_moments(p, N=32, n_paths=n, seed=3)
    m_t, m2_t = (x.item() for x in em_moments_scan(
        p.as_tensor("cpu"), 32, path_index_grid(n), 0, *split_seed(3)))
    e_n = reference_err(m_n, m2_n, n)
    e_t = reference_err(m_t, m2_t, n)
    assert abs(m_n - m_t) < 3 * math.hypot(e_n, e_t)
    assert np.isfinite([m_t, m2_t]).all()
