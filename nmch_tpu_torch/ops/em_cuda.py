"""EM moments through the hand-written CUDA kernel ``csrc/em.cu``.

The counterpart of ``nmch_tpu/ops/em_pallas.py::em_moments_pallas``
(rng philox or threefry4, ``conditional``, ``poisson_cut``).  On a CUDA
device the wrapper launches the kernel (one thread per path, then one
block that sums the per-block partials) or raises; on the CPU it runs the
plain version, ``ops/em.py::em_payoffs``, which computes the same payoffs
operation for operation.  Each launch also counts its work beside the
moments, in the same sums: the counter blocks its paths drew and, on the
round schedule, the block draws its warps executed, whose ratio over 32 is
the share of active lanes (``ops/em_schedule.py::active_lane_share``).
Parameters, ``poisson_cut`` and streams are runtime arguments, so a
parameter sweep never rebuilds the kernel.
``em_law_cuda`` launches K2's law build, the conditional kernel that also
writes each path's (v_T, vI) for the pathwise Greeks.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..utils.timing import span
from .em import em_conditional_payoff, em_consts, em_payoffs, \
    path_law_from_consts
from .fe import LANES, moments_f64, path_index_grid
from .launch import COUNTER_RNGS, BoundLaunch, check_args, check_params, \
    check_rng, check_u32, count_launch, device_key


def variant_name(rng: str, conditional: bool) -> str:
    """The name under which a kernel variant is counted and reported."""
    return f"em_{rng}" + ("_cond" if conditional else "")


def law_variant_name(rng: str) -> str:
    """The name under which the law build (``em_law_cuda``) is counted and
    reported."""
    return f"em_{rng}_cond_law"


def em_round_schedule(consts: torch.Tensor, N: int) -> torch.Tensor:
    """Whether the EM kernels run a point's paths on their round schedule
    (else on the step loops): bool (P,) for a float32 (P, 13) table of
    loop constants (``em_consts_table``) at N steps.  The one decision,
    ``csrc/em_path.cuh::em_rounds_pay`` on the host through the library's
    ``nmch_em_schedule``: K2 takes it at each launch, K4 reads it from its
    dispatch table.  Needs the kernel library (a card's toolchain)."""
    table = consts.to(torch.float32).contiguous().cpu()
    if table.dim() != 2 or table.shape[1] != 13:
        raise ValueError(f"consts must have shape (P, 13), not "
                         f"{tuple(table.shape)}")
    out = torch.empty(table.shape[0], dtype=torch.int32)
    lib, _ = load_library()
    rc = lib.nmch_em_schedule(table.data_ptr(), table.shape[0], int(N),
                              out.data_ptr())
    if rc != 0:
        raise ValueError(f"nmch_em_schedule refused N={N}: error {rc}")
    return out.bool()


def em_moments_cuda(params, seed_words, epoch, base_path, *, N: int,
                    n_paths: int, device, rng: str = "philox",
                    conditional: bool = False,
                    poisson_cut: float | None = None,
                    per_path: bool = False, counts: bool = False,
                    launch: BoundLaunch | None = None):
    """(E[X], E[X^2]) over n_paths EM paths, as float64 0-dim tensors on
    ``device``.

    params: float32 tensor (8,) on the CPU, (T, S_0, v_0, r, k, rho,
    theta, sigma); its loop constants (``em_consts``) go to the kernel by
    argument.  seed_words: the (k0, k1) u32 key pair; epoch and base_path:
    u32 stream coordinates (path p draws from counters (j, epoch,
    base_path + p, 0), j = 0, 1, ...).  poisson_cut None means 4000, the
    ops layer's default and the reference's law (curand's own switch to
    the normal); lambda at and above it takes the rounded normal, PTRS
    below.  per_path=True also returns each path's payoff (float32) and
    final counter (int64), in (n_paths/128, 128) layout.  counts=True
    returns, in place of the two moments, one float64 vector (4,) on
    ``device``: E[X], E[X^2], then the launch's counts, the counter
    blocks its paths drew (the sum of their final counters) and the block
    draws its warps executed (each counted once a warp; NaN where the
    launch ran the step loops, which do not count them,
    ``csrc/em_path.cuh``); on the CPU, whose plain version runs no warps,
    the vector holds the moments alone.
    Each launch adds one to ``em_moments_cuda.launches`` and to
    ``em_moments_cuda.variant_launches[variant_name(rng, conditional)]``.

    launch: a pricer's ``BoundLaunch`` (``ops/launch.py``), used as
    ``fe_moments_cuda`` uses it (static arguments: all but params and the
    epoch; per_path among them).  Each call still computes its loop
    constants from params.  The return is then the launch's ``out``, the
    vector (4,) that counts=True returns, which the next launch
    overwrites; with per_path, the launch's ``after`` holds the payoffs
    and the final counters as the kernel writes them (int32).
    """
    if launch is not None:
        key = (tuple(seed_words), base_path, N, n_paths, device_key(device),
               rng, conditional, poisson_cut, per_path)
        if key == launch.key:
            return _em_bound(em_moments_cuda, launch, params, epoch, N,
                             poisson_cut)
    device, N, n_paths, k0, k1, epoch, base_path = _check(
        params, seed_words, epoch, base_path, N, n_paths, device, rng)
    if device.type == "cpu":
        payoff, ctr = em_payoffs(params, N, path_index_grid(n_paths,
                                                            base_path),
                                 epoch, k0, k1, rng=rng,
                                 conditional=conditional,
                                 poisson_cut=poisson_cut)
        out = torch.stack(moments_f64(payoff))
    else:
        one_shot = launch is None
        if one_shot:
            launch, key = BoundLaunch(), None
        after = (None, None)
        if per_path:
            after = tuple(torch.empty(n_paths // LANES, LANES, dtype=dtype,
                                      device=device)
                          for dtype in (torch.float32, torch.int32))
        launch.bind(key, "nmch_em_moments", variant_name(rng, conditional),
                    device, (k0, k1), (base_path, N, n_paths,
                                       COUNTER_RNGS.index(rng),
                                       int(bool(conditional))),
                    4 * (n_paths // LANES), 4, after)
        out = _em_bound(em_moments_cuda, launch, params, epoch, N,
                        poisson_cut)
        if not one_shot:
            return out
        payoff, ctr = after
        if per_path:
            ctr = ctr.to(torch.int64) & 0xFFFFFFFF
    moments = out if counts else (out[0], out[1])
    if not per_path:
        return moments
    return (moments, payoff, ctr) if counts else (*moments, payoff, ctr)


em_moments_cuda.launches = 0
em_moments_cuda.variant_launches = {}


def _check(params, seed_words, epoch, base_path, N, n_paths, device, rng):
    """The checks of ``em_moments_cuda`` and ``em_law_cuda``; returns
    ``check_args``'s (device, N, n_paths, k0, k1, epoch, base_path)."""
    args = check_args(params, seed_words, epoch, base_path, N, n_paths,
                      device)
    check_rng(rng, "EM")
    return args


def _consts(params, N, poisson_cut):
    """K2's loop constants of ``params`` as its float argument array (span
    ``prepare.consts``)."""
    with span("prepare.consts"):
        return (ctypes.c_float * 13)(*em_consts(params, N, poisson_cut))


def _em_bound(fn, launch: BoundLaunch, params, epoch, N, poisson_cut):
    """K2 through a bound launch, the tail of every call of ``fn`` on a
    card: the call's loop constants and epoch."""
    check_params(params)
    launch.enqueue((_consts(params, N, poisson_cut),),
                   check_u32("epoch", epoch))
    count_launch(fn, launch.name)
    return launch.out


def em_law_cuda(params, seed_words, epoch, base_path, *, N: int,
                n_paths: int, device, rng: str = "philox",
                poisson_cut: float | None = None):
    """(E[X], E[X^2], v_T, vI) of the conditional estimator over n_paths
    EM paths, from K2's law build: the moments as
    ``em_moments_cuda(..., conditional=True)`` gives them (the same paths
    and sums), and each path's (v_T, vI), float32 (n_paths/128, 128) on
    ``device``: the values ``ops/em.py::path_law_from_consts`` returns, for
    the pathwise Greeks.  Arguments as ``em_moments_cuda``.  Each launch
    adds one to ``em_law_cuda.launches`` and to
    ``em_law_cuda.variant_launches[law_variant_name(rng)]``."""
    device, N, n_paths, k0, k1, epoch, base_path = _check(
        params, seed_words, epoch, base_path, N, n_paths, device, rng)
    if device.type == "cpu":
        c = em_consts(params, N, poisson_cut)
        path = path_index_grid(n_paths, base_path)
        m, sig_eff, v_T, vI, _ = path_law_from_consts(
            c, N, path, torch.zeros_like(path), epoch, k0, k1, rng)
        m1, m2 = moments_f64(em_conditional_payoff(m, sig_eff, c.S_0,
                                                   c.log_S0))
        return m1, m2, v_T, vI
    law = torch.empty(2, n_paths // LANES, LANES, dtype=torch.float32,
                      device=device)
    launch = BoundLaunch()
    launch.bind(None, "nmch_em_law", law_variant_name(rng), device, (k0, k1),
                (base_path, N, n_paths, COUNTER_RNGS.index(rng)),
                2 * (n_paths // LANES), 2, (law,))
    out = _em_bound(em_law_cuda, launch, params, epoch, N, poisson_cut)
    return out[0], out[1], law[0], law[1]


em_law_cuda.launches = 0
em_law_cuda.variant_launches = {}
