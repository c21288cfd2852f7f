"""Sweep moments through the hand-written CUDA kernels ``csrc/sweep.cu``.

The counterparts of ``nmch_tpu/ops/sweep_pallas.py::fe_sweep_pallas``
(K3, with its rng="tpu" as the card's "device" stream) and
``em_sweep_pallas`` (K4): the moments of P parameter points in one
launch, point p at epoch ``(epoch0 + p) mod 2^32`` with path ids
0..n_paths-1, so point p is bitwise the single-point kernel's moments at
that epoch and base_path 0.  On a CUDA device the wrappers launch the
kernel (grid (n_paths/128, P), then one block per point that sums its
partials) or raise; on the CPU they run the plain sweep, ``ops/sweep.py``.
"""

from __future__ import annotations

import torch

from ..utils.timing import span
from .em import em_consts_table
from .em_cuda import em_round_schedule, variant_name
from .fe import LANES
from .launch import COUNTER_RNGS, RNGS, call_kernel, check_rng, \
    check_sizes, check_u32, count_launch, scratch
from .sweep import em_sweep_plain, fe_sweep_plain

MAX_POINTS = 65535      # the kernels' gridDim.y
FE_SWEEP_RNGS = (*COUNTER_RNGS, "device")


def _check(params_matrix, seed_words, epoch0, N, n_paths, device, rng,
           kernel: str, rngs=COUNTER_RNGS):
    device, N, n_paths = check_sizes(N, n_paths, device)
    pm = params_matrix
    if not isinstance(pm, torch.Tensor) or pm.dtype != torch.float32 \
            or pm.dim() != 2 or pm.shape[1] != 8 or pm.device.type != "cpu":
        raise ValueError("params_matrix must be a float32 tensor of shape "
                         "(P, 8) on the CPU")
    if not 1 <= pm.shape[0] <= MAX_POINTS:
        raise ValueError(f"P={pm.shape[0]} points: the sweep takes 1 to "
                         f"{MAX_POINTS}")
    check_rng(rng, kernel, rngs)
    k0, k1 = (check_u32("seed word", w) for w in seed_words)
    return device, N, n_paths, k0, k1, check_u32("epoch0", epoch0)


def fe_sweep_cuda(params_matrix, seed_words, epoch0, *, N: int,
                  n_paths: int, device, rng: str = "philox"):
    """(E[X], E[X^2]) of n_paths FE paths per point, as two float64 (P,)
    tensors on ``device``.

    params_matrix: float32 (P, 8) on the CPU, rows (T, S_0, v_0, r, k,
    rho, theta, sigma); seed_words: the (k0, k1) u32 key; epoch0: u32;
    rng: "philox", "threefry4" or "device" (the card's stream in place of
    the TPU kernel's hardware generator, box hc, rot 1, IEEE sqrt, as
    ``sweep_pallas.py:96-120``).  Each launch adds one to
    ``fe_sweep_cuda.launches`` and to
    ``fe_sweep_cuda.variant_launches[f"fe_sweep_{rng}"]``."""
    device, N, n_paths, k0, k1, epoch0 = _check(
        params_matrix, seed_words, epoch0, N, n_paths, device, rng,
        "FE sweep", FE_SWEEP_RNGS)
    if device.type == "cpu":
        return fe_sweep_plain(params_matrix, (k0, k1), epoch0, N=N,
                              n_paths=n_paths, rng=rng, device=device)
    P = params_matrix.shape[0]
    name = f"fe_sweep_{rng}"
    with span("prepare.copy_in"):
        params = params_matrix.contiguous().to(device)
    partials, out = scratch(device, 2 * P * (n_paths // LANES), (P, 2))
    call_kernel("nmch_fe_sweep_moments", name, device, params.data_ptr(), P,
                k0, k1, epoch0, N, n_paths, RNGS.index(rng),
                partials.data_ptr(), out.data_ptr())
    count_launch(fe_sweep_cuda, name)
    return out[:, 0], out[:, 1]


fe_sweep_cuda.launches = 0
fe_sweep_cuda.variant_launches = {}


def em_rounds_share(params_matrix, consts: torch.Tensor) -> torch.Tensor:
    """float64 (P,): for each point, the share of steps whose Poisson draw
    leaves the normal branch, estimated as P(v < cut / lam_const) for
    v_{T/2} given v_0 under a Gamma law with the CIR process's mean and
    variance: the cost key of K4's dispatch order.  It decides no
    schedule: ``em_cuda.em_round_schedule`` does, from the same estimate in
    float32 on the host.  consts: the float32 (P, 13) ``em_consts_table``
    of params_matrix (rows (T, S_0, v_0, r, k, rho, theta, sigma))."""
    T, _, v_0, _, k, _, theta, sigma = params_matrix.double().unbind(1)
    c = consts.double()
    e = torch.exp(-0.5 * k * T)
    mean = theta + (v_0 - theta) * e
    var = sigma * sigma * (1.0 - e) * (v_0 * e + 0.5 * theta * (1.0 - e)) / k
    return torch.special.gammainc(mean * mean / var,
                                  c[:, 12] / c[:, 2] * mean / var)


def em_point_order(params_matrix, consts: torch.Tensor) -> torch.Tensor:
    """The order in which K4 dispatches the points' blocks: int64 (P,), a
    permutation of 0..P-1, heaviest point first (``em_rounds_share``, the
    share of steps off the normal branch: such points run more rounds and
    mix samplers within a warp), ties in grid order.  Dispatched first,
    they leave the one-round normal-branch points to fill the launch's
    tail.  consts: the float32 (P, 13) ``em_consts_table`` of
    params_matrix."""
    return torch.argsort(-em_rounds_share(params_matrix, consts),
                         stable=True)


def em_sweep_cuda(params_matrix, seed_words, epoch0, *, N: int,
                  n_paths: int, device, rng: str = "philox",
                  conditional: bool = False,
                  poisson_cut: float | None = None, per_path: bool = False):
    """(E[X], E[X^2]) of n_paths EM paths per point, as two float64 (P,)
    tensors on ``device``.

    Arguments as ``fe_sweep_cuda``, plus ``conditional`` and
    ``poisson_cut`` (None means 4000, as at the ops layer); the points'
    loop constants (``em_consts_table``) go to the card as a (P, 13)
    table, and the order of their blocks (``em_point_order``) with each
    point's schedule (``em_round_schedule``) as a (P,) one.
    per_path=True also returns each path's payoff (float32) and
    final counter (int64), (P, n_paths/128, 128).  Each launch adds one to
    ``em_sweep_cuda.launches`` and to ``em_sweep_cuda.variant_launches[
    "em_sweep_" + variant]``."""
    device, N, n_paths, k0, k1, epoch0 = _check(
        params_matrix, seed_words, epoch0, N, n_paths, device, rng,
        "EM sweep")
    if device.type == "cpu":
        return em_sweep_plain(params_matrix, (k0, k1), epoch0, N=N,
                              n_paths=n_paths, rng=rng,
                              conditional=conditional,
                              poisson_cut=poisson_cut, device=device,
                              per_path=per_path)
    P = params_matrix.shape[0]
    name = "em_sweep_" + variant_name(rng, conditional)[len("em_"):]
    with span("prepare.consts"):
        table = em_consts_table(params_matrix, N, poisson_cut)
    with span("prepare.dispatch"):
        order = em_point_order(params_matrix, table)
        dispatch = 2 * order + em_round_schedule(table, N)[order].long()
    with span("prepare.copy_in"):
        dispatch = dispatch.to(device, torch.int32)
        consts = table.to(device)
    partials, out = scratch(device, 2 * P * (n_paths // LANES), (P, 2))
    payoff = ctr = None
    if per_path:
        shape = (P, n_paths // LANES, LANES)
        payoff = torch.empty(shape, dtype=torch.float32, device=device)
        ctr = torch.empty(shape, dtype=torch.int32, device=device)
    call_kernel("nmch_em_sweep_moments", name, device, consts.data_ptr(),
                dispatch.data_ptr(), P,
                k0, k1, epoch0, N, n_paths, RNGS.index(rng),
                int(bool(conditional)), partials.data_ptr(), out.data_ptr(),
                None if payoff is None else payoff.data_ptr(),
                None if ctr is None else ctr.data_ptr())
    count_launch(em_sweep_cuda, name)
    if per_path:
        ctr = ctr.to(torch.int64) & 0xFFFFFFFF
        return out[:, 0], out[:, 1], payoff, ctr
    return out[:, 0], out[:, 1]


em_sweep_cuda.launches = 0
em_sweep_cuda.variant_launches = {}
