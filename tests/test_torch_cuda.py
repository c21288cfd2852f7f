"""The CUDA kernels of the PyTorch port on a card (marker ``cuda``).

These tests skip without a CUDA card.  They import neither jax nor
nmch_tpu, so they run on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import json

import pytest
import torch

from nmch_tpu_torch import HestonParams, NMCH_EM, NMCH_FE, SimConfig
from nmch_tpu_torch.ops.em import em_payoffs, moments_f64
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda
from nmch_tpu_torch.ops.fe import fe_moments_kernel_plain, \
    fe_moments_scan, path_index_grid
from nmch_tpu_torch.ops.fe_cuda import fe_moments_cuda, variant_name
from nmch_tpu_torch.ops.sweep import em_sweep_plain, fe_sweep_plain
from nmch_tpu_torch.ops.sweep_cuda import em_sweep_cuda, fe_sweep_cuda
from nmch_tpu_torch.oracle import heston_call_undiscounted
from nmch_tpu_torch.explore import grid_params, grid_points
from nmch_tpu_torch.ops import fe_stateful as plain_stateful
from nmch_tpu_torch.ops.fe_stateful_cuda import advance_state_cuda, \
    fe_stateful_moments_cuda, fe_stateful_state_cuda
from nmch_tpu_torch.ops.fe_qmc import qmc_increments_mxu, \
    qmc_payoff_sums_plain
from nmch_tpu_torch.ops.fe_qmc_cuda import qmc_payoff_sums_cuda
from nmch_tpu_torch.rng import sobol
from nmch_tpu_torch import cli

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("N,epoch,base", [(11, 0, 0), (12, 3, 1 << 14)])
def test_kernel_matches_plain_and_is_deterministic(dev, N, epoch, base):
    pv = HestonParams().as_tensor("cpu")
    key = (1234, 0)
    before = fe_moments_cuda.launches
    k1 = torch.stack(fe_moments_cuda(pv, key, epoch, base, N=N,
                                     n_paths=1 << 14, device=dev))
    k2 = torch.stack(fe_moments_cuda(pv, key, epoch, base, N=N,
                                     n_paths=1 << 14, device=dev))
    assert fe_moments_cuda.launches == before + 2
    assert torch.equal(k1, k2)
    p = torch.stack(fe_moments_scan(pv.to(dev), N,
                                    path_index_grid(1 << 14, base, dev),
                                    epoch, *key))
    torch.testing.assert_close(k1, p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rng,rot,box,fast_sqrt,N", [
    ("philox", 4, "hc", False, 11), ("threefry", 4, "turns", False, 12),
    ("threefry4", 4, "hc", False, 11), ("device", 4, "hc16", False, 12),
    ("device", 8, "hc16f", True, 11)])
def test_fe_variant_matches_plain_and_is_deterministic(dev, rng, rot, box,
                                                       fast_sqrt, N):
    """K1's variants against fe_moments_kernel_plain on the card: moments
    at rel 1e-6 (float64 sums in another order), bitwise repeats, the
    variant's launch counter rising."""
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=N, n_paths=1 << 14, rng=rng, rot=rot, box=box,
              fast_sqrt=fast_sqrt)
    name = variant_name(rng, rot, box, fast_sqrt)
    before = fe_moments_cuda.variant_launches.get(name, 0)
    k1 = torch.stack(fe_moments_cuda(pv, (1234, 0), 3, 1 << 14, device=dev,
                                     **kw))
    k2 = torch.stack(fe_moments_cuda(pv, (1234, 0), 3, 1 << 14, device=dev,
                                     **kw))
    assert fe_moments_cuda.variant_launches[name] == before + 2
    assert torch.equal(k1, k2)
    p = torch.stack(fe_moments_kernel_plain(pv.to(dev), (1234, 0), 3,
                                            1 << 14, **kw))
    torch.testing.assert_close(k1, p, rtol=1e-6, atol=0)


def test_rot4_cli_prices_within_oracle_bar(dev, capsys):
    """python -m nmch_tpu_torch.cli --rot 4 --json --oracle (at 2^15
    groups x N=200): K1 philox rot 4 launched, price within 3 ci +
    2e-3."""
    before = fe_moments_cuda.variant_launches.get("fe_philox_rot4", 0)
    assert cli.run(["--rot", "4", "--json", "--oracle", "--NB", "64",
                    "--N", "200"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fe_moments_cuda.variant_launches["fe_philox_rot4"] > before
    assert abs(rec["price"] - rec["heston_oracle"]) <= \
        3 * rec["ci_error"] + 2e-3


def test_main_path_prices_within_oracle_bar(dev):
    m = NMCH_FE(SimConfig(NB=128, N=200), HestonParams(), device=dev)
    m.init(1234)
    res = m.compute()
    bar = 3 * res.ci_error + 2e-3
    assert abs(res.price - heston_call_undiscounted(m.params)) <= bar


@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", False),
                                             ("philox", True)])
def test_em_kernel_matches_plain_and_is_deterministic(dev, rng, conditional):
    """Every path's final counter and payoff equal the plain version's;
    moments at rel 1e-6 (float64 sums in another order); bitwise-equal
    moments from two launches."""
    pv = HestonParams().as_tensor("cpu")
    key = (1234, 0)
    for N, cut, base in ((8, 4000.0, 0), (32, 128.0, 1 << 14)):
        before = em_moments_cuda.launches
        m, m2, pay, ctr = em_moments_cuda(
            pv, key, 2, base, N=N, n_paths=1 << 13, device=dev, rng=rng,
            conditional=conditional, poisson_cut=cut, per_path=True)
        again = em_moments_cuda(pv, key, 2, base, N=N, n_paths=1 << 13,
                                device=dev, rng=rng, conditional=conditional,
                                poisson_cut=cut)
        assert em_moments_cuda.launches == before + 2
        k = torch.stack([m, m2])
        assert torch.equal(k, torch.stack(again))
        p_pay, p_ctr = em_payoffs(pv.to(dev), N,
                                  path_index_grid(1 << 13, base, dev), 2,
                                  *key, rng=rng, conditional=conditional,
                                  poisson_cut=cut)
        assert torch.equal(ctr, p_ctr)
        assert torch.equal(pay, p_pay)
        torch.testing.assert_close(k, torch.stack(moments_f64(p_pay)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", True)])
def test_em_kernel_matches_plain_in_mixed_regimes(dev, rng, conditional):
    """explore's grid point k=0.1, theta=0.5, sigma=1 at N=1000, cut 128:
    the variance visits zero, so a warp's lanes mix all three Poisson
    regimes and the alpha < 1 Gamma boost (the kernel's round schedule);
    every path's final counter and payoff equal the plain version's."""
    pv = HestonParams(k=0.1, theta=0.5, sigma=1.0).as_tensor("cpu")
    key = (1234, 0)
    m, m2, pay, ctr = em_moments_cuda(
        pv, key, 3, 1 << 16, N=1000, n_paths=1 << 14, device=dev, rng=rng,
        conditional=conditional, poisson_cut=128.0, per_path=True)
    p_pay, p_ctr = em_payoffs(pv.to(dev), 1000,
                              path_index_grid(1 << 14, 1 << 16, dev), 3,
                              *key, rng=rng, conditional=conditional,
                              poisson_cut=128.0)
    assert torch.equal(ctr, p_ctr)
    assert torch.equal(pay, p_pay)
    torch.testing.assert_close(torch.stack([m, m2]),
                               torch.stack(moments_f64(p_pay)), rtol=1e-6,
                               atol=0)


def test_em_prices_within_oracle_bar(dev):
    m = NMCH_EM(SimConfig(NB=128, N=50), HestonParams(), device=dev)
    m.init(1234)
    res = m.compute()
    bar = 3 * res.ci_error + 2e-3
    assert abs(res.price - heston_call_undiscounted(m.params)) <= bar


def _sweep_points():
    pts = grid_points()
    return grid_params(pts[:3] + pts[-3:])     # sigma = 0.1 and 1.0


@pytest.mark.parametrize("rng,epoch0", [("philox", 0),
                                        ("threefry4", 2**32 - 4),
                                        ("device", 2**32 - 4)])
def test_fe_sweep_matches_plain_and_single_point_kernel(dev, rng, epoch0):
    """K3 vs the plain sweep at rel 1e-6; point p bitwise K1 at epoch
    epoch0 + p."""
    pm = _sweep_points()
    key = (1234, 0)
    kw = dict(N=11, n_paths=1 << 12, rng=rng)
    before = fe_sweep_cuda.launches
    m, m2 = fe_sweep_cuda(pm, key, epoch0, device=dev, **kw)
    assert fe_sweep_cuda.launches == before + 1
    k = torch.stack([m, m2])
    p = torch.stack(fe_sweep_plain(pm, key, epoch0, device=dev, **kw))
    torch.testing.assert_close(k, p, rtol=1e-6, atol=0)
    for i, pv in enumerate(pm):
        one = torch.stack(fe_moments_cuda(pv, key, (epoch0 + i) % 2**32, 0,
                                          N=11, n_paths=1 << 12, device=dev,
                                          rng=rng))
        assert torch.equal(k[:, i], one)


@pytest.mark.parametrize("rng,conditional,epoch0", [
    ("philox", False, 2**32 - 4), ("threefry4", True, 0)])
def test_em_sweep_matches_plain_and_single_point_kernel(dev, rng,
                                                        conditional, epoch0):
    """K4: every path's counter and payoff equal the plain sweep's,
    moments at rel 1e-6; point p bitwise K2 at epoch epoch0 + p."""
    pm = _sweep_points()
    key = (1234, 0)
    kw = dict(N=16, n_paths=1 << 12, rng=rng, conditional=conditional,
              poisson_cut=128.0)
    m, m2, pay, ctr = em_sweep_cuda(pm, key, epoch0, device=dev,
                                    per_path=True, **kw)
    pm_, pm2_, p_pay, p_ctr = em_sweep_plain(pm, key, epoch0, device=dev,
                                             per_path=True, **kw)
    assert torch.equal(ctr, p_ctr) and torch.equal(pay, p_pay)
    k = torch.stack([m, m2])
    torch.testing.assert_close(k, torch.stack([pm_, pm2_]), rtol=1e-6,
                               atol=0)
    for i, pv in enumerate(pm):
        one = torch.stack(em_moments_cuda(
            pv, key, (epoch0 + i) % 2**32, 0, N=16, n_paths=1 << 12,
            device=dev, rng=rng, conditional=conditional, poisson_cut=128.0))
        assert torch.equal(k[:, i], one)


@pytest.mark.parametrize("rng,N,epoch", [("xorwow", 11, 0),
                                         ("mrg32k3a", 12, 3)])
def test_stateful_kernel_matches_plain_and_is_deterministic(dev, rng, N,
                                                            epoch):
    """K5 and the jump kernels: states bitwise the plain versions', the
    advanced state jumped by epoch_stride - D bitwise the next epoch's
    start, moments at rel 1e-6 (float64 sums in another order), repeats
    bitwise."""
    pv = HestonParams().as_tensor("cpu")
    n = 1 << 13
    st = fe_stateful_state_cuda(rng, 1234, n, epoch, dev)
    sp = plain_stateful.fe_stateful_state(rng, 1234, n, epoch, dev)
    assert torch.equal(st, sp)
    before = fe_stateful_moments_cuda.launches
    m, m2, s1 = fe_stateful_moments_cuda(pv, st, N=N, rng=rng)
    a, a2, s1b = fe_stateful_moments_cuda(pv, st, N=N, rng=rng)
    assert fe_stateful_moments_cuda.launches == before + 2
    k = torch.stack([m, m2])
    assert torch.equal(k, torch.stack([a, a2])) and torch.equal(s1, s1b)
    pm, pm2, ps1 = plain_stateful.fe_moments_stateful_plain(pv.to(dev), sp,
                                                            N, rng)
    assert torch.equal(s1, ps1)
    torch.testing.assert_close(k, torch.stack([pm, pm2]), rtol=1e-6, atol=0)
    steps = plain_stateful.epoch_stride(rng) - \
        plain_stateful.draws_per_compute(N)
    nxt = advance_state_cuda(rng, s1, steps)
    assert torch.equal(nxt, plain_stateful.advance_state(rng, ps1, steps))
    assert torch.equal(nxt, fe_stateful_state_cuda(rng, 1234, n, epoch + 1,
                                                   dev))


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_stateful_engines_agree_and_price_within_oracle_bar(dev, rng):
    """The carried-state cuda engine equals the scan engine (plain golden on
    the card) bitwise in the moments' inputs: equal prices at rel 1e-12
    (the float64 sums run in another order) at epochs 0-2."""
    cfg = SimConfig(NB=16, N=50)
    mc = NMCH_FE(cfg, HestonParams(), rng=rng, device=dev)
    ms = NMCH_FE(cfg, HestonParams(), engine="scan", rng=rng, device=dev)
    mc.init(1234)
    ms.init(1234)
    for _ in range(3):
        rc, rs = mc.compute(), ms.compute()
        assert abs(rc.price - rs.price) <= 1e-12 * rs.price
    bar = 3 * rc.ci_error + 2e-3
    assert abs(rc.price - heston_call_undiscounted(mc.params)) <= bar


@pytest.mark.parametrize("N,n", [(16, 2048), (13, 2000)])
def test_qmc_kernel_matches_plain_and_is_deterministic(dev, N, n):
    """K6 on the card's own increments: per-replicate sums at rel 1e-6 of
    the plain version's (float64 sums in another order), bitwise repeats,
    the launch counter rising; n = 2000 leaves a ragged block in each
    replicate."""
    pv = HestonParams().as_tensor("cpu")
    d1, d2 = qmc_increments_mxu(N, n, 1, 1234, 0, pv[0], n_shifts=8,
                                device=dev)
    before = qmc_payoff_sums_cuda.launches
    k = torch.stack(qmc_payoff_sums_cuda(pv, d1, d2, 8))
    again = torch.stack(qmc_payoff_sums_cuda(pv, d1, d2, 8))
    assert qmc_payoff_sums_cuda.launches == before + 2
    assert torch.equal(k, again)
    p = torch.stack(qmc_payoff_sums_plain(pv, d1, d2, 8))
    torch.testing.assert_close(k, p, rtol=1e-6, atol=0)


def test_qmc_words_on_the_card_equal_the_cpus(dev):
    """The int64-carried Sobol', LMS and Owen words give the same bits on
    the card as on the CPU."""
    v = sobol.direction_numbers(32)
    for d in (dev, torch.device("cpu")):
        x = sobol.sobol_dims_u32_hilo(8 * 2048, sobol.as_words(v, d))
        lms = sobol.lms_scramble_directions(sobol.as_words(v, d), 3, 1234, 0)
        keys = sobol.owen_seeds(torch.arange(32, device=d)[:, None], 5,
                                1234, 0)
        got = [t.cpu() for t in (x, lms, sobol.owen_scramble(x, keys))]
        if d.type == "cuda":
            card = got
    for a, b in zip(card, got):
        assert torch.equal(a, b)


def test_qmc_engine_prices_within_oracle_bar(dev):
    m = NMCH_FE(SimConfig(NB=64, N=100), HestonParams(), engine="qmc",
                device=dev)
    m.init(1234)
    before = qmc_payoff_sums_cuda.launches
    res = m.compute()
    assert qmc_payoff_sums_cuda.launches == before + 1
    assert res.synthesized_moments
    bar = 3 * res.ci_error + 2e-3
    assert abs(res.price - heston_call_undiscounted(m.params)) <= bar


@pytest.mark.parametrize("data", ["random", "cancelling"])
@pytest.mark.parametrize("tiles", [1, 4, 7, 1562, 15625])
def test_reduction_kernel_is_bitwise_plain(dev, tiles, data):
    """K7 (csrc/reduction.cu): the tile order and the chain's order are the
    plain version's, so the f32 sum is bitwise equal on random data and
    on data with +-1e6 on alternate elements, in three back-to-back calls
    (each zeroes its own ready slots); the counter rises."""
    from nmch_tpu_torch.ops.reduction import red_sum_plain
    from nmch_tpu_torch.ops.reduction_cuda import red_sum_cuda
    g = torch.Generator(device=dev)
    g.manual_seed(tiles)
    x = torch.rand((tiles * 512, 128), generator=g, device=dev)
    if data == "cancelling":
        x[:, 0::2] += 1e6
        x[:, 1::2] -= 1e6
    before = red_sum_cuda.launches
    ks = [red_sum_cuda(x) for _ in range(3)]
    assert red_sum_cuda.launches == before + 3
    p = red_sum_plain(x)
    assert all(torch.equal(k, p) for k in ks)
    half = torch.full((tiles * 512, 128), 0.5, device=dev)
    assert red_sum_cuda(half).item() == tiles * 512 * 64


def test_reduction_kernel_is_one_launch(dev):
    """K7 runs the tile pass and the Kahan chain in one kernel: the
    profiler sees one kernel a call, after the memset of its slots."""
    from nmch_tpu_torch.ops.reduction_cuda import red_sum_cuda
    from nmch_tpu_torch.utils.timing import device_ops
    x = torch.rand((64 * 512, 128), device=dev)
    ops = device_ops(lambda: red_sum_cuda(x))
    kernels = [op for op in ops if "memset" not in op.lower()]
    assert len(ops) == 2 and len(kernels) == 1, ops
    assert "memset" in ops[0].lower(), ops
    assert "red_sum_kernel" in kernels[0], ops


def test_reduction_kernel_on_two_streams(dev):
    """Each call zeroes its own slots on its stream: bitwise the plain sum
    on the current stream and on a second one, after a larger array."""
    from nmch_tpu_torch.ops.reduction import red_sum_plain
    from nmch_tpu_torch.ops.reduction_cuda import red_sum_cuda
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    small = torch.rand((3 * 512, 128), generator=g, device=dev)
    big = torch.rand((9 * 512, 128), generator=g, device=dev)
    want = {id(x): red_sum_plain(x) for x in (small, big)}
    side = torch.cuda.Stream(dev)
    for x in (small, big, small):
        assert torch.equal(red_sum_cuda(x), want[id(x)])
        with torch.cuda.stream(side):
            got = red_sum_cuda(x)
        side.synchronize()
        assert torch.equal(got, want[id(x)])


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 128),
                                        (torch.bfloat16, 256)])
@pytest.mark.parametrize("with_sqrt,rsqrt", [(False, False), (True, False),
                                             (True, True)])
def test_chain_kernel_matches_plain(dev, dtype, rows, with_sqrt, rsqrt):
    """K8 (csrc/chain_probe.cu) at K=64: float32 abs/sqrt and bf16 abs
    bitwise, rsqrt and the bf16x2 roots within one ulp of the dtype."""
    import numpy as np
    from nmch_tpu_torch.ops.chain import chain_plain
    from nmch_tpu_torch.ops.chain_cuda import chain_cuda
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, (rows, 128))).to(device=dev, dtype=dtype)
    before = chain_cuda.launches
    k = chain_cuda(x, K=64, with_sqrt=with_sqrt, rsqrt=rsqrt)
    assert chain_cuda.launches == before + 1 and k.dtype == dtype
    p = chain_plain(x, K=64, with_sqrt=with_sqrt, rsqrt=rsqrt)
    if not with_sqrt or (dtype == torch.float32 and not rsqrt):
        assert torch.equal(k, p)
    else:
        ulp = torch.ldexp(torch.ones_like(p, dtype=torch.float32),
                          torch.frexp(p.float())[1] - 1
                          - (23 if dtype == torch.float32 else 7))
        assert ((k.float() - p.float()).abs() <= ulp).all()


@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH", "DEFAULT"])
@pytest.mark.parametrize("N,matrix", [(16, "bridge"), (101, "bridge"),
                                      (101, "dense")])
def test_fused_qmc_kernel_matches_plain(dev, precision, N, matrix):
    """K9/K10 (csrc/qmc_fused.cu, the sparse bridge walk) on the card's
    normals, on the bridge matrix and on a dense random A (whose rows the
    plan cuts into pieces): per-replicate sums at rel 1e-6 of the plain
    version's (float64 sums in another order), bitwise repeats, the
    precision's counter rising."""
    import numpy as np
    from nmch_tpu_torch.ops import fe_qmc
    from nmch_tpu_torch.ops.qmc_fused_cuda import KERNEL_NAMES, \
        qmc_payoff_sums_fused_cuda
    pv = HestonParams().as_tensor("cpu")
    z1, z2 = fe_qmc.qmc_normals_mxu(N, 2048, 1, 1234, 0, n_shifts=8,
                                    device=dev)
    if matrix == "bridge":
        A = fe_qmc.bb_increment_matrix(N)
    else:
        A = np.random.default_rng(N).standard_normal((N, N)) / np.sqrt(N)
    A = torch.from_numpy(np.sqrt(1.0 / N).astype(np.float32)
                         * A.astype(np.float32)).to(dev)
    name = KERNEL_NAMES[precision]
    before = qmc_payoff_sums_fused_cuda.variant_launches.get(name, 0)
    k = torch.stack(qmc_payoff_sums_fused_cuda(pv, z1, z2, A, 8,
                                               precision=precision))
    again = torch.stack(qmc_payoff_sums_fused_cuda(pv, z1, z2, A, 8,
                                                   precision=precision))
    assert qmc_payoff_sums_fused_cuda.variant_launches[name] == before + 2
    assert torch.equal(k, again)
    p = torch.stack(fe_qmc.qmc_payoff_sums_fused_plain(
        pv, z1, z2, A, 8, precision=precision))
    torch.testing.assert_close(k, p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
@pytest.mark.parametrize("fix_strike", [False, True])
def test_fe_greeks_kernel_matches_plain(dev, rng, fix_strike):
    """G1 (csrc/fe_greeks.cu) against fe_greeks_plain on the card at an odd
    N: every path's payoff and 8 tangents bitwise, the float64 means at
    rel 1e-6, bitwise repeats, the rng's counter rising."""
    from nmch_tpu_torch.ops.fe_greeks import fe_greeks_plain
    from nmch_tpu_torch.ops.fe_greeks_cuda import fe_greeks_cuda, \
        variant_name as g1_name
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=13, n_paths=1 << 14, rng=rng, fix_strike=fix_strike)
    name = g1_name(rng)
    before = fe_greeks_cuda.variant_launches.get(name, 0)
    kp, kg, kt = fe_greeks_cuda(pv, (1234, 0), 3, 1 << 14, device=dev,
                                per_path=True, **kw)
    again = fe_greeks_cuda(pv, (1234, 0), 3, 1 << 14, device=dev, **kw)
    assert fe_greeks_cuda.variant_launches[name] == before + 2
    assert torch.equal(kp, again[0]) and torch.equal(kg, again[1])
    pp, pg, pt = fe_greeks_plain(pv, (1234, 0), 3, 1 << 14, device=dev,
                                 per_path=True, **kw)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    torch.testing.assert_close(torch.cat([kp.reshape(1), kg]),
                               torch.cat([pp.reshape(1), pg]), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("cut", [128.0, 4000.0])
def test_em_law_build_matches_path_law(dev, rng, cut):
    """K2's law build: every path's (v_T, vI) bitwise path_law_from_consts
    on the card (N=100: the step loops at cut 128, the round schedule at
    4000), its moments bitwise the conditional build's."""
    from nmch_tpu_torch.ops.em import em_consts, path_law_from_consts
    from nmch_tpu_torch.ops.em_cuda import em_law_cuda, law_variant_name
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=100, n_paths=1 << 12, device=dev, rng=rng, poisson_cut=cut)
    before = em_law_cuda.variant_launches.get(law_variant_name(rng), 0)
    m, m2, v_T, vI = em_law_cuda(pv, (1234, 0), 2, 0, **kw)
    assert em_law_cuda.variant_launches[law_variant_name(rng)] == before + 1
    c = em_moments_cuda(pv, (1234, 0), 2, 0, conditional=True, **kw)
    assert torch.equal(m, c[0]) and torch.equal(m2, c[1])
    path = path_index_grid(1 << 12, 0, dev)
    _, _, pT, pI, _ = path_law_from_consts(em_consts(pv, 100, cut), 100,
                                           path, torch.zeros_like(path), 2,
                                           1234, 0, rng)
    assert torch.equal(v_T, pT) and torch.equal(vI, pI)


@pytest.mark.parametrize("schedule", [None, "steps", "rounds"])
@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("params", [HestonParams(),
                                    HestonParams(k=0.5, theta=0.01,
                                                 sigma=1.0)])
def test_em_lrm_kernel_matches_plain(dev, rng, params, schedule):
    """K2-LRM (csrc/em_lrm.cu) against lrm_plain on the card, on the
    schedule K2 would take and on each one forced: v_T, vI_rest and the
    five scores of every path bitwise and finite (also where Gamma draws
    underflow), the rng's counter rising."""
    from nmch_tpu_torch.ops.em_lrm import lrm_plain
    from nmch_tpu_torch.ops.em_lrm_cuda import em_lrm_scores_cuda, \
        variant_name as lrm_name
    pv = params.as_tensor("cpu")
    before = em_lrm_scores_cuda.variant_launches.get(lrm_name(rng), 0)
    k = em_lrm_scores_cuda(pv, (1234, 0), 2, 0, N=16, n_paths=1 << 12,
                           device=dev, rng=rng, schedule=schedule)
    assert em_lrm_scores_cuda.variant_launches[lrm_name(rng)] == before + 1
    p = lrm_plain(pv, (1234, 0), 2, 0, N=16, n_paths=1 << 12, rng=rng,
                  device=dev)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    assert bool(torch.isfinite(k).all())


def test_greeks_methods_launch_their_kernels(dev):
    """On the card NMCH_FE.greeks launches G1, NMCH_EM.greeks the law
    build, ten K2 conditional launches with fd=True and K2-LRM with
    lrm=True; no plain version runs."""
    from nmch_tpu_torch.ops.em_cuda import em_law_cuda
    from nmch_tpu_torch.ops.em_lrm_cuda import em_lrm_scores_cuda
    from nmch_tpu_torch.ops.fe_greeks_cuda import fe_greeks_cuda
    cfg = SimConfig(NTPB=128, NB=8, N=16)
    g1 = fe_greeks_cuda.launches
    m = NMCH_FE(cfg, HestonParams())
    m.init(3)
    assert len(m.greeks()) == 9 and fe_greeks_cuda.launches == g1 + 1
    e = NMCH_EM(cfg, HestonParams())
    e.init(3)
    law = em_law_cuda.variant_launches.get("em_philox_cond_law", 0)
    cond = em_moments_cuda.variant_launches.get("em_philox_cond", 0)
    lrm = em_lrm_scores_cuda.launches
    assert len(e.greeks(fd=True)) == 9
    assert len(e.greeks(lrm=True)) == 9
    assert em_law_cuda.variant_launches["em_philox_cond_law"] == law + 2
    assert em_moments_cuda.variant_launches["em_philox_cond"] == cond + 10
    assert em_lrm_scores_cuda.launches == lrm + 1


def test_sharded_world_of_one_is_the_single_kernel(dev):
    """With no process group, sharded_moments is one rank: K1 / K2 at
    base_path 0, moments bitwise the single launch's, one launch each."""
    from nmch_tpu_torch.parallel.mesh import make_mesh, sharded_moments
    mesh = make_mesh(device=dev)
    assert (mesh.world, mesh.device) == (1, dev)
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=64, n_paths=1 << 14)
    for method, fn, cut in (("fe", fe_moments_cuda, {}),
                            ("em", em_moments_cuda, {"poisson_cut": 128.0})):
        before = fn.launches
        got = torch.stack(sharded_moments(mesh, pv, 1234, 2, method=method,
                                          **kw))
        assert fn.launches == before + 1
        want = torch.stack(fn(pv, (1234, 0), 2, 0, device=dev, **kw, **cut))
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(method="fe"), dict(method="fe", rot=4), dict(method="em"),
    dict(method="em", rng="threefry4", conditional=True),
    dict(engine="qmc")])
def test_sharded_ranks_on_the_card_match_the_single_kernel(dev, kw):
    """Four ranks' parts (rank_moments on the card, one kernel launch
    each) combined in rank order: rel 1e-12 of the single launch (QMC:
    nmch_tpu's bars, 2e-6 / 2e-4)."""
    from nmch_tpu_torch.ops.fe_qmc import fe_moments_qmc
    from nmch_tpu_torch.ops.fe_qmc_cuda import qmc_payoff_sums_cuda
    from nmch_tpu_torch.parallel.mesh import combine_moments, rank_moments
    pv = HestonParams().as_tensor("cpu")
    n_paths, N = 1 << 15, 32
    engine = kw.get("engine", "cuda")
    fn = {"qmc": qmc_payoff_sums_cuda, "cuda": (
        fe_moments_cuda if kw.get("method") == "fe" else em_moments_cuda)}[
            engine]
    before = fn.launches
    parts = [rank_moments(r, 4, pv, 1234, 1, N=N, n_paths=n_paths,
                          device=dev, **kw) for r in range(4)]
    assert fn.launches == before + 4
    got = torch.stack(combine_moments(parts, engine=engine,
                                      n_paths=n_paths)).tolist()
    key = (1234, 0)
    if engine == "qmc":
        want = torch.stack(fe_moments_qmc(pv, 1, *key, N=N, n_paths=n_paths,
                                          device=dev)).tolist()
        assert got[0] == pytest.approx(want[0], rel=2e-6)
        assert got[1] == pytest.approx(want[1], rel=2e-4)
        return
    single = dict(rng=kw.get("rng", "philox"))
    if kw["method"] == "fe":
        single["rot"] = kw.get("rot", 1)
    else:
        single.update(conditional=kw.get("conditional", False),
                      poisson_cut=128.0)
    want = torch.stack(fn(pv, key, 1, 0, N=N, n_paths=n_paths, device=dev,
                          **single)).tolist()
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-12 * abs(w)


def test_prewarm_on_the_card(dev):
    """prewarm() builds the library and launches K1 (engine="cuda") or
    the QMC path (engine="qmc") once."""
    from nmch_tpu_torch import prewarm
    from nmch_tpu_torch.ops.fe_qmc_cuda import qmc_payoff_sums_cuda
    before = (fe_moments_cuda.launches, qmc_payoff_sums_cuda.launches)
    assert prewarm() is None
    prewarm(engine="qmc", block=False).join(timeout=300)
    assert (fe_moments_cuda.launches, qmc_payoff_sums_cuda.launches) == (
        before[0] + 1, before[1] + 1)
