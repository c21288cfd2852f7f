"""The EM kernels' two schedules of the same draws (csrc/em_path.cuh, K2
and K4), emulated on the CPU by ``ops/em_schedule.py::emulate``.

The tests hold every path's final counter and payoff bitwise to
``ops/em.py::em_payoffs`` (the plain version, the one the kernels equal
on the card) on both schedules, in the three regimes of
``chip_smoke.py``'s phase 6, for both counter rngs, with ``conditional``
off and on, and count each warp's iterations: the largest, over its
lanes, of the lane's final counter plus the iterations it waited for its
phase or its branch.  K4's emulation (one point per warp) is held to the
plain sweep the same way.  They also pin K4's point order
(``ops/sweep_cuda.py::em_point_order``), and hold K2-LRM's per-step report
on either schedule (``ops/em_lrm.py::LrmSteps`` as the emulation's
report) bitwise to the plain score loop ``lrm_scores_plain``."""

import pytest
import torch

from nmch_tpu_torch import HestonParams
from nmch_tpu_torch.explore import grid_params, grid_points
from nmch_tpu_torch.ops.em import em_consts, em_consts_table, em_payoffs
from nmch_tpu_torch.ops.em_lrm import LrmSteps, lrm_jacobian, \
    lrm_scores_plain
from nmch_tpu_torch.ops.em_lrm_cuda import em_lrm_scores_cuda
from nmch_tpu_torch.ops.em_schedule import WARP, active_lane_share, \
    emulate, sweep_consts
from nmch_tpu_torch.ops.fe import path_index_grid
from nmch_tpu_torch.ops.sweep import em_sweep_plain
from nmch_tpu_torch.ops.sweep_cuda import em_point_order

torch.set_num_threads(2)

# chip_smoke.py's phase 6 regimes: (params, N, poisson_cut)
REGIMES = {
    "ptrs": (HestonParams(), 8, 4000.0),
    "normal": (HestonParams(), 100, 128.0),
    "knuth_boost": (HestonParams(sigma=1.0, theta=0.01, k=1.0), 32, 128.0),
}
N_PATHS = 1 << 10
EPOCH, BASE = 3, 1 << 16


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_schedule_is_bitwise_the_plain_version(regime, rng, conditional):
    """Every path's final counter and payoff bitwise em_payoffs's on both
    schedules; a warp runs as many iterations as its lanes' largest
    counter plus that lane's waits, and the round schedule waits less."""
    params, N, cut = REGIMES[regime]
    c = em_consts(params.as_tensor("cpu"), N, cut)
    idx = path_index_grid(N_PATHS, BASE)
    want_pay, want_ctr = em_payoffs(params.as_tensor("cpu"), N, idx, EPOCH,
                                    1234, 0, rng=rng,
                                    conditional=conditional,
                                    poisson_cut=cut)
    # both schedules in one run: the paths twice, the first copy's warps
    # on the round schedule, the second's on the step loops
    path = idx.flatten().repeat(2)
    out = emulate(c, N, path, EPOCH, 1234, 0, rng, conditional,
                  torch.arange(2 * N_PATHS) < N_PATHS)
    iters = {}
    for j, schedule in enumerate(("rounds", "steps")):
        pay, ctr, warp_iters, waits = (x.view(2, -1)[j] for x in out)
        assert torch.equal(ctr, want_ctr.flatten()), schedule
        assert torch.equal(pay.view(torch.int32),
                           want_pay.flatten().view(torch.int32)), schedule
        assert torch.equal(warp_iters,
                           (ctr + waits).view(-1, WARP).max(1).values)
        iters[schedule] = int(warp_iters.sum())
    assert iters["rounds"] < iters["steps"]


def test_point_order_is_a_deterministic_permutation_heaviest_first():
    """K4's dispatch order: a permutation of the points, the same on every
    call; the grid points whose variance visits zero (d < 1) at sigma = 1
    come before every sigma = 0.1 point, whose draws stay on the one-round
    normal branch."""
    pts = grid_points()
    pm = grid_params(pts)
    table = em_consts_table(pm, 1000, 128.0)
    order = em_point_order(pm, table)
    assert order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(len(pts)))
    assert torch.equal(order, em_point_order(pm.clone(), table.clone()))
    pos = {pts[p]: j for j, p in enumerate(order.tolist())}
    light = [pos[p] for p in pts if p[2] == 0.1]
    for heavy in ((0.1, 0.5, 1.0), (10.000000000000002, 0.01, 1.0),
                  (2.08, 0.108, 1.0)):
        assert pos[heavy] < min(light), heavy


def test_point_order_of_equal_points_is_grid_order():
    """Ties keep grid order (a stable sort)."""
    pm = grid_params([(2.08, 0.304, 0.46)] * 5)
    order = em_point_order(pm, em_consts_table(pm, 100, 128.0))
    assert order.tolist() == [0, 1, 2, 3, 4]


def test_sweep_emulation_is_bitwise_the_plain_sweep():
    """K4's emulation, one point's constants and epoch per warp and each
    point on its own schedule, gives every path's counter and payoff of
    em_sweep_plain; its share of active lanes is a fraction."""
    pts = [(0.1, 0.5, 1.0), (2.08, 0.304, 0.46), (10.000000000000002, 0.01,
                                                 1.0)]
    pm = grid_params(pts)
    N, n_paths, epoch0 = 32, 128, 5
    c, path, point = sweep_consts(pm, N, 128.0, n_paths)
    _, _, want_pay, want_ctr = em_sweep_plain(
        pm, (1234, 0), epoch0, N=N, n_paths=n_paths, rng="threefry4",
        poisson_cut=128.0, per_path=True)
    pay, ctr, warp_iters, waits = emulate(c, N, path, epoch0 + point, 1234,
                                          0, "threefry4", False,
                                          point % 2 == 0)
    assert torch.equal(ctr, want_ctr.flatten())
    assert torch.equal(pay.view(torch.int32),
                       want_pay.flatten().view(torch.int32))
    assert torch.equal(warp_iters,
                       (ctr + waits).view(-1, WARP).max(1).values)
    assert 0.0 < active_lane_share(ctr, warp_iters) <= 1.0


def test_round_schedule_refuses_a_table_of_another_shape():
    """em_round_schedule takes (P, 13) loop constants; any other shape is
    refused before the library is loaded."""
    from nmch_tpu_torch.ops.em_cuda import em_round_schedule
    with pytest.raises(ValueError, match=r"\(P, 13\)"):
        em_round_schedule(torch.zeros(4, 12), 1000)
    with pytest.raises(ValueError, match=r"\(P, 13\)"):
        em_round_schedule(torch.zeros(13), 1000)


# K2-LRM's regimes: (params, N); cut None (4000), as em_greeks_lrm runs it
LRM_REGIMES = {
    "ptrs": (HestonParams(), 8),
    "gamma_underflow": (HestonParams(k=0.5, theta=0.01, sigma=1.0), 16),
}


def _lrm_both_schedules(pv, N, n_paths, rng):
    """(the plain scores, float32 (7, n_paths), and the emulation's on the
    round schedule and on the step loops, (2, 7, n_paths))."""
    c = em_consts(pv, N)
    J = lrm_jacobian(pv, N)
    idx = path_index_grid(n_paths, BASE)
    want = lrm_scores_plain(c, J, N, idx, EPOCH, 1234, 0, rng)
    rep = LrmSteps(c, J, 2 * n_paths)
    emulate(c, N, idx.flatten().repeat(2), EPOCH, 1234, 0, rng, True,
            torch.arange(2 * n_paths) < n_paths, report=rep)
    return want.reshape(7, -1), rep.out().view(7, 2, -1).transpose(0, 1)


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("regime", list(LRM_REGIMES))
def test_lrm_report_is_bitwise_the_plain_scores(regime, rng):
    """v_T, vI_rest and the five scores of every path, reported step by
    step where each lane's Gamma draw settles, bitwise lrm_scores_plain's
    on both schedules (UNDERFLOW: v' underflows to 0 on many lanes)."""
    params, N = LRM_REGIMES[regime]
    want, got = _lrm_both_schedules(params.as_tensor("cpu"), N, N_PATHS, rng)
    for schedule, g in zip(("rounds", "steps"), got):
        assert torch.equal(g.view(torch.int32), want.view(torch.int32)), \
            schedule
        assert bool(torch.isfinite(g).all()), schedule


def test_lrm_report_after_both_samplers_fallbacks():
    """With v_0 = NaN every Poisson draw ends on its 64-round fallback and
    every Gamma draw on its 32-round one (MT accepts >= 95% a round, so
    no finite input of the tests reaches it): each lane still reports its
    steps in order, bitwise (NaN bits included) the plain loop's."""
    pv = HestonParams().as_tensor("cpu")
    pv[2] = float("nan")
    want, got = _lrm_both_schedules(pv, 3, 256, "philox")
    assert bool(torch.isnan(want).all())
    for schedule, g in zip(("rounds", "steps"), got):
        assert torch.equal(g.view(torch.int32), want.view(torch.int32)), \
            schedule


def test_lrm_wrapper_takes_a_schedule():
    """On the CPU the schedule picks nothing (the plain loop runs); an
    unknown one is refused."""
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=4, n_paths=128, device="cpu")
    want = em_lrm_scores_cuda(pv, (1234, 0), 1, 0, **kw)
    for schedule in ("steps", "rounds"):
        assert torch.equal(em_lrm_scores_cuda(pv, (1234, 0), 1, 0, **kw,
                                              schedule=schedule), want)
    with pytest.raises(ValueError, match="schedule"):
        em_lrm_scores_cuda(pv, (1234, 0), 1, 0, **kw, schedule="loops")
