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
(``ops/sweep_cuda.py::em_point_order``)."""

import pytest
import torch

from nmch_tpu_torch import HestonParams
from nmch_tpu_torch.explore import grid_params, grid_points
from nmch_tpu_torch.ops.em import em_consts, em_consts_table, em_payoffs
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
