"""Plain sweeps and sweep wrappers of the PyTorch port against nmch_tpu.

The plain sweep (``ops/sweep.py``) carries the points on a leading axis;
point p must be the port's single-point plain version at epoch
(epoch0 + p) mod 2^32, bitwise, and agree with ``nmch_tpu``'s
``fe_sweep_scan``/``em_sweep_scan`` and its sweep kernels in interpret
mode.  EM is compared per path, with the bars of test_torch_em.py
(torch's CPU log/exp are not XLA's): final counters, and paths whose
payoff also agrees, on >= 99.9% of paths; moments over the agreeing paths
at rel 1e-5, the whole-grid moments at rel 1e-5 plus the disagreeing
paths' own payoff differences.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.explore import grid_points as j_grid_points
from nmch_tpu.ops import em as jem
from nmch_tpu.ops.sweep_pallas import em_sweep_pallas, em_sweep_scan, \
    fe_sweep_pallas, fe_sweep_scan
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch.explore import grid_params
from nmch_tpu_torch.ops import em as tem
from nmch_tpu_torch.ops import fe as tfe
from nmch_tpu_torch.ops.sweep import em_sweep_plain, fe_sweep_plain, \
    sweep_epochs
from nmch_tpu_torch.ops.sweep_cuda import em_sweep_cuda, fe_sweep_cuda

torch.set_num_threads(2)

REL = 1e-5
SHARE = 0.999
PATH_REL = 1e-4
SEED = 1234
WRAP = 2**32 - 4          # epoch0 + p wraps within the points below
EM_PARAMS = [             # tests/test_torch_em.py's PARAMS
    JHestonParams(),
    JHestonParams(sigma=1.0, theta=0.01, k=1.0),
    JHestonParams(v_0=0.4, theta=0.4, rho=-0.3),
]


def _points(n: int):
    """The first and last n/2 grid points: sigma = 0.1 and sigma = 1.0,
    which between them take every sampler regime."""
    pts = j_grid_points()
    return pts[:n // 2] + pts[-(n // 2):]


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _key():
    k0, k1 = split_seed(SEED)
    return int(k0), int(k1)


# --- em_consts_table -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_consts(N: int):
    """nmch_tpu's float32 em_path_law constants on a (P, 8) matrix."""
    def consts(pm):
        T, S_0, v_0, r, k, rho, theta, sigma = (pm[:, i] for i in range(8))
        dt = T / jnp.float32(N)
        exp_kdt = jnp.exp(-k * dt)
        sig2 = sigma * sigma
        one_m = np.float32(1.0) - exp_kdt
        log_s0 = jnp.log(S_0)
        return jnp.stack([
            v_0, S_0, np.float32(2.0) * k * exp_kdt / (sig2 * one_m),
            np.float32(2.0) * k * theta / sig2,
            sig2 * one_m / (np.float32(2.0) * k), dt * np.float32(0.5),
            log_s0, log_s0 + r * T, rho / sigma, k * theta * T, k,
            np.float32(1.0) - rho * rho], axis=1)
    return jax.jit(consts)


@pytest.mark.parametrize("cut", [None, 128.0])
def test_em_consts_table_rows_are_em_consts_bitwise(cut):
    """All 200 grid points at N=1000 and test_torch_em.py's parameters:
    each row equals the scalar em_consts and nmch_tpu's float32
    constants, bit for bit."""
    pm = torch.cat([grid_params(),
                    torch.from_numpy(np.stack([
                        np.asarray(p.replace(S_0=1.3, r=0.05).as_array())
                        for p in EM_PARAMS]))])
    N = 1000
    table = tem.em_consts_table(pm, N, cut)
    assert table.dtype == torch.float32 and table.shape == (203, 13)
    want = np.asarray(_jax_consts(N)(pm.numpy()))
    np.testing.assert_array_equal(table[:, :12].numpy().view(np.uint32),
                                  want.view(np.uint32))
    for row, pv in zip(table, pm):
        assert row.tolist() == list(tem.em_consts(pv, N, cut))


# --- FE ------------------------------------------------------------------

@pytest.mark.parametrize("epoch0", [0, WRAP])
def test_fe_sweep_plain_matches_nmch_tpu_philox(epoch0):
    pts = _points(6)
    pm = grid_params(pts)
    N, n_paths = 16, 1024
    got = fe_sweep_plain(pm, _key(), epoch0, N=N, n_paths=n_paths)
    scan = fe_sweep_scan(jnp.asarray(pm.numpy()), SEED, epoch0, N=N,
                         n_paths=n_paths)
    pallas = fe_sweep_pallas(jnp.asarray(pm.numpy()),
                             jnp.asarray(_key(), jnp.uint32),
                             jnp.uint32(epoch0), N=N, n_paths=n_paths,
                             n_points=len(pts), interpret=True)
    for want in (scan, pallas):
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and g.shape == (len(pts),)
            assert (_rel(g.numpy(), w) <= REL).all()


@pytest.mark.parametrize("epoch0,N", [(0, 16), (WRAP, 15)])
def test_fe_sweep_plain_matches_nmch_tpu_threefry4(epoch0, N):
    """fe_sweep_scan has no rng argument, so threefry4 is held to the
    sweep kernel in interpret mode."""
    pts = _points(4)
    pm = grid_params(pts)
    got = fe_sweep_plain(pm, _key(), epoch0, N=N, n_paths=512,
                         rng="threefry4")
    want = fe_sweep_pallas(jnp.asarray(pm.numpy()),
                           jnp.asarray(_key(), jnp.uint32),
                           jnp.uint32(epoch0), N=N, n_paths=512,
                           n_points=len(pts), rng="threefry4",
                           interpret=True)
    for g, w in zip(got, want):
        assert (_rel(g.numpy(), w) <= REL).all()


@pytest.mark.parametrize("rng", ["philox", "threefry4", "device"])
@pytest.mark.parametrize("epoch0", [0, WRAP])
def test_fe_sweep_point_is_the_single_point_run_bitwise(rng, epoch0):
    """Point p is the single-point run at epoch (epoch0 + p) mod 2^32,
    base_path 0: the scan golden and K1's plain version (for "device",
    the card's stream in place of the TPU kernel's hardware generator,
    which has no nmch_tpu oracle on the CPU)."""
    pm = grid_params(_points(4))
    N, n_paths = 9, 256
    m, m2 = fe_sweep_plain(pm, _key(), epoch0, N=N, n_paths=n_paths,
                           rng=rng)
    for p, pv in enumerate(pm):
        epoch = (epoch0 + p) & 0xFFFFFFFF
        one = tfe.fe_moments_scan(pv, N, tfe.path_index_grid(n_paths),
                                  epoch, *_key(), rng=rng)
        k1 = tfe.fe_moments_kernel_plain(pv, _key(), epoch, 0, N=N,
                                         n_paths=n_paths, rng=rng)
        for want in (one, k1):
            assert torch.equal(m[p], want[0]) and torch.equal(m2[p], want[1])


def test_sweep_epochs_wrap():
    e = sweep_epochs(WRAP, 6, "cpu")
    assert e.shape == (6, 1, 1)
    assert e.flatten().tolist() == [2**32 - 4, 2**32 - 3, 2**32 - 2,
                                    2**32 - 1, 0, 1]


# --- EM ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_em_per_path(rng, conditional, cut, N):
    """nmch_tpu's per-path payoffs and final counters of one point."""
    def f(pv, pidx, epoch, k0, k1):
        lo = pidx.astype(jnp.uint32)
        hi = jnp.zeros_like(lo)
        if conditional:
            m, s, _, _, ctr = jem.em_path_law(pv, N, lo, hi, epoch, k0, k1,
                                              rng=rng, poisson_cut=cut)
            return jem.em_conditional_payoff(m, s, pv[1]), ctr
        S_T, _, _, ctr = jem.em_terminal_core(pv, N, lo, hi, epoch, k0, k1,
                                              rng=rng, poisson_cut=cut)
        return jnp.maximum(S_T - pv[1], 0.0), ctr
    return jax.jit(f)


def _moments(pay: np.ndarray):
    pay = pay.astype(np.float64)
    return np.array([pay.mean(), (pay * pay).mean()])


@pytest.mark.parametrize("rng,conditional,cut,epoch0", [
    ("philox", False, 128.0, 0),
    ("threefry4", True, 128.0, WRAP),
    ("philox", True, None, WRAP),
])
def test_em_sweep_plain_matches_nmch_tpu(rng, conditional, cut, epoch0):
    pts = _points(6)
    pm = grid_params(pts)
    N, n_paths = 16, 512
    k0, k1 = _key()
    m, m2, t_pay, t_ctr = em_sweep_plain(
        pm, (k0, k1), epoch0, N=N, n_paths=n_paths, rng=rng,
        conditional=conditional, poisson_cut=cut, per_path=True)
    assert t_pay.shape == t_ctr.shape == (len(pts), n_paths // 128, 128)
    f = _jax_em_per_path(rng, conditional, cut, N)
    pidx = jnp.arange(n_paths, dtype=jnp.uint32).reshape(-1, 128)
    slack = np.zeros((len(pts), 2))
    for p in range(len(pts)):
        j_pay, j_ctr = f(pm[p].numpy(), pidx,
                         jnp.uint32((epoch0 + p) & 0xFFFFFFFF),
                         np.uint32(k0), np.uint32(k1))
        j_pay = np.asarray(j_pay).ravel()
        j_ctr = np.asarray(j_ctr).astype(np.int64).ravel()
        tp = t_pay[p].numpy().ravel()
        same_ctr = t_ctr[p].numpy().ravel() == j_ctr
        assert same_ctr.mean() >= SHARE
        agree = same_ctr & (np.abs(tp - j_pay)
                            <= PATH_REL * np.abs(j_pay) + 1e-7)
        assert agree.mean() >= SHARE
        np.testing.assert_allclose(_moments(tp[agree]),
                                   _moments(j_pay[agree]), rtol=REL)
        slack[p] = _moments(np.abs(tp - j_pay) * ~agree) \
            + _moments(np.abs(tp + j_pay) * ~agree)
        assert float(m[p]) == float(tem.moments_f64(t_pay[p])[0])

    # the whole grid: nmch_tpu's jitted sweep and its sweep kernel
    got = np.stack([m.numpy(), m2.numpy()], axis=1)
    scan = em_sweep_scan(jnp.asarray(pm.numpy()), SEED, epoch0, N=N,
                         n_paths=n_paths, rng=rng, conditional=conditional,
                         poisson_cut=cut)
    pallas = em_sweep_pallas(jnp.asarray(pm.numpy()),
                             jnp.asarray((k0, k1), jnp.uint32),
                             jnp.uint32(epoch0), N=N, n_paths=n_paths,
                             n_points=len(pts), rng=rng,
                             conditional=conditional, poisson_cut=cut,
                             interpret=True)
    for want in (scan, pallas):
        want = np.stack([np.asarray(w, np.float64) for w in want], axis=1)
        assert (np.abs(got - want) <= REL * np.abs(want) + slack).all()


@pytest.mark.parametrize("rng,conditional,epoch0", [
    ("philox", False, WRAP), ("threefry4", True, 0)])
def test_em_sweep_point_is_the_single_point_run_bitwise(rng, conditional,
                                                        epoch0):
    pm = grid_params(_points(4))
    N, n_paths, cut = 8, 256, 64.0
    m, m2, pay, ctr = em_sweep_plain(pm, _key(), epoch0, N=N,
                                     n_paths=n_paths, rng=rng,
                                     conditional=conditional,
                                     poisson_cut=cut, per_path=True)
    for p, pv in enumerate(pm):
        one_pay, one_ctr = tem.em_payoffs(
            pv, N, tfe.path_index_grid(n_paths), (epoch0 + p) & 0xFFFFFFFF,
            *_key(), rng=rng, conditional=conditional, poisson_cut=cut)
        assert torch.equal(pay[p], one_pay) and torch.equal(ctr[p], one_ctr)
        one = tem.moments_f64(one_pay)
        assert torch.equal(m[p], one[0]) and torch.equal(m2[p], one[1])


# --- the wrappers on the CPU ----------------------------------------------

def test_wrappers_on_cpu_are_the_plain_sweep_bitwise():
    pm = grid_params(_points(4))
    kw = dict(N=7, n_paths=256, device="cpu")
    launches = (fe_sweep_cuda.launches, em_sweep_cuda.launches,
                dict(fe_sweep_cuda.variant_launches),
                dict(em_sweep_cuda.variant_launches))
    for rng in ("threefry4", "device"):
        for a, b in zip(fe_sweep_cuda(pm, _key(), WRAP, rng=rng, **kw),
                        fe_sweep_plain(pm, _key(), WRAP, rng=rng, **kw)):
            assert torch.equal(a, b)
    got = em_sweep_cuda(pm, _key(), 3, conditional=True, poisson_cut=64.0,
                        per_path=True, **kw)
    want = em_sweep_plain(pm, _key(), 3, conditional=True, poisson_cut=64.0,
                          per_path=True, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == torch.float64 and got[3].dtype == torch.int64
    # no kernel was launched
    assert launches == (fe_sweep_cuda.launches, em_sweep_cuda.launches,
                        fe_sweep_cuda.variant_launches,
                        em_sweep_cuda.variant_launches)


@pytest.mark.parametrize("fn", [fe_sweep_cuda, em_sweep_cuda])
@pytest.mark.parametrize("kwargs,match", [
    ({"params_matrix": torch.zeros(0, 8)}, "P=0"),
    ({"params_matrix": torch.zeros(65536, 8)}, "1 to 65535"),
    ({"params_matrix": torch.zeros(4, 7)}, r"\(P, 8\)"),
    ({"params_matrix": torch.zeros(4, 8, dtype=torch.float64)}, "float32"),
    ({"n_paths": 200}, "multiple of 128"),
    ({"N": 0}, "N="),
    ({"epoch0": 2**32}, "uint32"),
    ({"seed_words": (-1, 0)}, "uint32"),
    ({"rng": "tpu"}, "use rng='device'"),
    ({"rng": "bogus"}, "kernel takes 'philox'"),
    ({"device": "meta"}, "neither cpu nor cuda"),
])
def test_wrappers_reject_bad_arguments(fn, kwargs, match):
    args = dict(params_matrix=torch.zeros(4, 8), seed_words=(1, 2),
                epoch0=0, N=4, n_paths=128, device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        fn(args.pop("params_matrix"), args.pop("seed_words"),
           args.pop("epoch0"), **args)
