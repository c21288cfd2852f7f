"""The QMC engine of the PyTorch port (ops/fe_qmc.py, ops/fe_qmc_cuda.py)
against nmch_tpu's (ops/fe_qmc.py), its Pallas kernel K6 run in interpret
mode, and the checkpoint hand-over between the two packages.

Sizes stay at <= 8 x 4096 points and N <= 32."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import nmch_tpu
from nmch_tpu.ops import fe_qmc as jq
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig, SimResult
from nmch_tpu_torch.ops import fe_qmc as tq
from nmch_tpu_torch.ops.fe_qmc_cuda import qmc_payoff_sums_cuda
from nmch_tpu_torch.oracle import heston_call_undiscounted

torch.set_num_threads(2)

K0, K1 = (int(w) for w in split_seed(3))
P = HestonParams()
PV = P.as_tensor("cpu")
PJ = nmch_tpu.HestonParams().as_array()
CPU = torch.device("cpu")


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _scale_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


def _increments(N: int, M: int, seed: int = 0):
    """Brownian increments of dt = 1/N from numpy, float32 (N, M)."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((2, N, M)) * np.sqrt(1.0 / N)).astype(
        np.float32)
    return d[0], d[1]


@pytest.mark.parametrize("N", [1, 2, 7, 16, 100])
def test_bb_plan_and_increment_matrix_bitwise(N):
    got, want = tq.bb_plan(N), jq.bb_plan(N)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    A = tq.bb_increment_matrix(N)
    assert A.dtype == np.float32 and A.flags.c_contiguous
    np.testing.assert_array_equal(A.view(np.uint32),
                                  jq.bb_increment_matrix(N).view(np.uint32))


@pytest.mark.parametrize("scramble,base", [("lms-shift", 0),
                                           ("shift", 2048),
                                           ("owen", 0)])
def test_qmc_normals_and_increments_mxu_match_nmch_tpu(scramble, base):
    """Bridge-ordered normals within 1 ulp, the increments (one float32
    product against XLA's) at rel 1e-5 of their scale."""
    N, n, R = 16, 2048, 8
    kw = dict(n_shifts=R, scramble=scramble, base=base)
    z_t = tq.qmc_normals_mxu(N, n, 1, K0, K1, device=CPU, **kw)
    z_j = jq.qmc_normals_mxu(N, n, jnp.uint32(1), K0, K1, **kw)
    for a, b in zip(z_t, z_j):
        assert a.shape == (N, R * n)
        ai = a.numpy().view(np.int32).astype(np.int64)
        bi = np.asarray(b).view(np.int32).astype(np.int64)
        assert np.abs(ai - bi).max() <= 1
    d_t = tq.qmc_increments_mxu(N, n, 1, K0, K1, PV[0], device=CPU, **kw)
    d_j = jq.qmc_increments_mxu(N, n, jnp.uint32(1), K0, K1, PJ[0], **kw)
    for a, b in zip(d_t, d_j):
        assert a.dtype == torch.float32
        assert _scale_err(a, b) <= 1e-5


def test_qmc_increments_scatter_matches_nmch_tpu_and_mxu_law():
    """The scatter bridge (torch.special.ndtri) against nmch_tpu's
    (jax.scipy ndtri) at rel 1e-5 of the scale; per step, the increments
    of both constructions have the Brownian variance dt."""
    N, n = 8, 1024
    d_t = tq.qmc_increments(N, n, 2, K0, K1, PV[0], device=CPU)
    d_j = jq.qmc_increments(N, n, jnp.uint32(2), K0, K1, PJ[0])
    for a, b in zip(d_t, d_j):
        assert _scale_err(a, b) <= 1e-5
        var = a.double().var(dim=1) * N
        assert float((var - 1).abs().max()) < 0.1


def test_sim_payoff_per_path_matches_nmch_tpu():
    d1, d2 = _increments(16, 8 * 1024)
    got = tq._sim_payoff(PV, 16, torch.from_numpy(d1), torch.from_numpy(d2))
    want = np.asarray(jq._sim_payoff(PJ, 16, jnp.asarray(d1),
                                     jnp.asarray(d2)))
    assert got.dtype == torch.float32
    # rel 1e-5 of the payoffs' scale S_0 = 1 (near-zero payoffs have no
    # relative accuracy: XLA's scan lands a few ulps of S_T away)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [15, 16])
def test_plain_k6_matches_interpreted_pallas_k6(N):
    """Per-replicate sums at rel 1e-5 (nmch_tpu sums in float32, the port
    in float64); the wrapper on CPU tensors is the plain version."""
    R = 8
    d1, d2 = _increments(N, R * 1024, seed=N)
    s, s2 = tq.qmc_payoff_sums_plain(PV, torch.from_numpy(d1),
                                     torch.from_numpy(d2), R)
    assert s.dtype == torch.float64 and s.shape == (R,)
    js_, js2 = jq.qmc_payoff_sums_pallas(PJ, jnp.asarray(d1),
                                         jnp.asarray(d2), R, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js_), rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5)
    before = qmc_payoff_sums_cuda.launches
    w, w2 = qmc_payoff_sums_cuda(PV, torch.from_numpy(d1),
                                 torch.from_numpy(d2), R)
    assert qmc_payoff_sums_cuda.launches == before    # no kernel on the CPU
    assert torch.equal(w, s) and torch.equal(w2, s2)


def test_plain_k6_ragged_replicates_equal_per_path_sums():
    """n = 2000 paths per replicate (no 1024-path tiles): each
    replicate's sums are those of its own paths."""
    N, R, n = 8, 8, 2000
    d1, d2 = (torch.from_numpy(x) for x in _increments(N, R * n, seed=5))
    s, s2 = tq.qmc_payoff_sums_plain(PV, d1, d2, R)
    for r in (0, R - 1):
        sl = slice(r * n, (r + 1) * n)
        one, one2 = tq.qmc_payoff_sums_plain(PV, d1[:, sl].contiguous(),
                                             d2[:, sl].contiguous(), 1)
        assert torch.equal(one[0], s[r]) and torch.equal(one2[0], s2[r])


@pytest.mark.parametrize("scramble", ["lms-shift", "shift", "owen"])
def test_fe_moments_qmc_matches_nmch_tpu(scramble):
    """The port's kernel form (sim="cuda", the plain K6 on the CPU) and
    scan form against nmch_tpu's scan engine: m at rel 1e-5, m2 at rel
    2e-4 (the bar tests/test_qmc.py sets for the same rounding gap)."""
    kw = dict(N=16, n_paths=8 * 2048, scramble=scramble)
    # interpret=True (no effect on the scan engine) shares the compile
    # with the checkpoint test's NMCH_FE on the CPU
    mj, m2j = jq.fe_moments_qmc(PJ, jnp.uint32(1), np.uint32(K0),
                                np.uint32(K1), sim="scan", interpret=True,
                                **kw)
    for sim in ("cuda", "scan"):
        m, m2 = tq.fe_moments_qmc(PV, 1, K0, K1, sim=sim, device=CPU, **kw)
        assert m.dtype == torch.float64
        assert _rel(m, mj) <= 1e-5
        assert _rel(m2, m2j) <= 2e-4
    oracle = heston_call_undiscounted(P)
    res = SimResult(float(m), float(m2), 8 * 2048, synthesized_moments=True)
    assert abs(res.price - oracle) < 4 * res.ci_error + 2e-3


def test_chunked_matches_unchunked_and_chunk_schedule():
    m1, m21 = tq.fe_moments_qmc(PV, 2, K0, K1, N=16, n_paths=8 * 4096,
                                device=CPU)
    m2, m22 = tq.fe_moments_qmc(PV, 2, K0, K1, N=16, n_paths=8 * 4096,
                                max_chunk=1024, device=CPU)
    assert _rel(m2, m1) <= 2e-6 and _rel(m22, m21) <= 2e-4
    # nmch_tpu's schedule: a non-dividing cap rounds down to a divisor,
    # the 2^29-element cap per factor halves the CLI's 2^21 points
    assert tq.qmc_chunk(2048, 16, 8, 768) == 512
    assert tq.qmc_chunk(1 << 15, 1000, 8, None) == 1 << 15
    assert tq.qmc_chunk(1 << 18, 1000, 8, None) == 1 << 16
    assert tq.qmc_chunk(3 * 5, 4, 8, 4) == 3


def test_dyadic_bridge_exact_covariance_and_pow2_equivalence():
    Npad, levels = 16, 4
    B = tq._dyadic_refine(torch.eye(Npad), 1.0, levels).double().numpy()
    np.testing.assert_allclose(B @ B.T, np.eye(Npad) / Npad, atol=1e-7)
    kw = dict(N=16, n_paths=8 * 512, device=CPU)
    m_m, m2_m = tq.fe_moments_qmc(PV, 1, K0, K1, bridge="mxu", **kw)
    m_d, m2_d = tq.fe_moments_qmc(PV, 1, K0, K1, bridge="dyadic", **kw)
    assert _rel(m_d, m_m) <= 1e-5 and _rel(m2_d, m2_m) <= 1e-4
    d_t = tq.qmc_increments_dyadic(12, 512, 1, K0, K1, PV[0], n_shifts=2,
                                   device=CPU)
    d_j = jq.qmc_increments_dyadic(12, 512, jnp.uint32(1), K0, K1, PJ[0],
                                   n_shifts=2)
    for a, b in zip(d_t, d_j):
        assert a.shape == (12, 1024) and _scale_err(a, b) <= 1e-5


def test_ndtri_precise_mode():
    """torch.special.ndtri prices the same integral as the fast
    polynomial, within nmch_tpu's bar (tests/test_qmc.py), and its
    normals lie within 1e-5 of nmch_tpu's precise ones (jax.scipy's
    ndtri)."""
    kw = dict(N=16, n_paths=8 * 2048)
    m_f, _ = tq.fe_moments_qmc(PV, 1, K0, K1, device=CPU, **kw)
    m_p, _ = tq.fe_moments_qmc(PV, 1, K0, K1, ndtri_mode="precise",
                               device=CPU, **kw)
    assert abs(float(m_p) - float(m_f)) < 5e-5
    zkw = dict(n_shifts=2, scramble="shift", ndtri_mode="precise")
    z_t = tq.qmc_normals_mxu(8, 1024, 1, K0, K1, device=CPU, **zkw)
    z_j = jq.qmc_normals_mxu(8, 1024, jnp.uint32(1), K0, K1, **zkw)
    for a, b in zip(z_t, z_j):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-5


def test_rqmc_moments_from_means_match_nmch_tpu():
    means = np.random.default_rng(4).normal(0.12, 1e-3, 8)
    m, m2 = tq.rqmc_moments_from_means(torch.from_numpy(means), 1 << 14, 8)
    mj, m2j = jq.rqmc_moments_from_means(jnp.asarray(means, jnp.float32),
                                         1 << 14, 8)
    assert _rel(m, mj) <= 1e-6 and _rel(m2, m2j) <= 1e-6
    # the synthesized moments encode t_7 * std(means) / sqrt(8), times
    # SimResult's sample-variance factor sqrt(n / (n - 1)) and its 1.96
    # over the exact quantile that the synthesis divides by
    from scipy.stats import t
    n = 1 << 14
    res = SimResult(float(m), float(m2), n, synthesized_moments=True)
    want = t.ppf(0.975, 7) * means.std(ddof=1) / np.sqrt(8) \
        * np.sqrt(n / (n - 1)) * 1.96 / 1.959963984540054
    assert abs(res.ci_error - want) <= 1e-6 * want


def test_qmc_beats_plain_mc_at_the_same_paths():
    from nmch_tpu_torch.ops.fe import fe_moments_scan, path_index_grid
    n, N = 8 * 2048, 32
    q = SimResult(*map(float, tq.fe_moments_qmc(PV, 0, K0, K1, N=N,
                                                n_paths=n, device=CPU)),
                  n, synthesized_moments=True)
    mc = SimResult(*map(float, fe_moments_scan(PV, N, path_index_grid(n), 0,
                                               K0, K1)), n)
    assert q.ci_error < mc.ci_error / 4
    assert abs(q.price - heston_call_undiscounted(P)) < 5 * q.ci_error + 2e-3


@pytest.mark.parametrize("kw,match", [
    ({"sim": "pallas"}, "unknown sim"),
    ({"n_shifts": 1}, "must be >= 2"),
    ({"n_paths": 8 * 128 + 4}, "divisible"),
    ({"scramble": "sobol"}, "unknown scramble"),
    ({"bridge": "scatter"}, "unknown bridge"),
    ({"ndtri_mode": "exact"}, "unknown ndtri_mode"),
])
def test_fe_moments_qmc_argument_checks(kw, match):
    args = {"N": 4, "n_paths": 8 * 128, "device": CPU, **kw}
    with pytest.raises(ValueError, match=match):
        tq.fe_moments_qmc(PV, 0, K0, K1, **args)


def test_wrapper_argument_checks():
    d1, d2 = (torch.from_numpy(x) for x in _increments(4, 64))
    bad = [
        ((PV.double(), d1, d2, 8), "params"),
        ((PV, d1.double(), d2, 8), "float32"),
        ((PV, d1[0], d2[0], 8), "float32"),
        ((PV, d1, d2[:, :32].contiguous(), 8), "differ"),
        ((PV, d1.t(), d2.t(), 2), "contiguous"),
        ((PV, d1, d2, 7), "multiple of n_shifts"),
        ((PV, d1, d2, 0), "multiple of n_shifts"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            qmc_payoff_sums_cuda(*args)


def test_checkpoint_from_nmch_tpu_resumes_the_qmc_stream(tmp_path):
    """A checkpoint nmch_tpu's NMCH_FE(engine="qmc") writes after one
    compute() loads into the port, whose next price is nmch_tpu's next
    price at rel 1e-5: the point set is a function of (seed, epoch, N,
    n_paths, scramble) alone."""
    jm = nmch_tpu.NMCH_FE(nmch_tpu.SimConfig(NTPB=256, NB=64, N=16, seed=77),
                          nmch_tpu.HestonParams(theta=0.12), engine="qmc")
    jm.init(77)
    jm.compute()
    path = tmp_path / "ckpt.json"
    jm.save_state(str(path))
    want = jm.compute()
    m = NMCH_FE(SimConfig(), HestonParams(), engine="qmc", device="cpu")
    m.load_state(str(path))
    assert m.streams.epoch == 1 and m.params.theta == 0.12
    assert m.scramble == jm.scramble == "lms-shift"
    got = m.compute()
    assert _rel(got.price, want.price) <= 1e-5
    assert got.synthesized_moments and np.isnan(got.err)
    assert abs(got.ci_error - want.ci_error) <= 1e-2 * want.ci_error
