"""EM likelihood-ratio scores through the hand-written CUDA kernel K2-LRM,
``csrc/em_lrm.cu``.

K2-LRM runs K2's path code (rng philox or threefry4) on the schedule K2
takes for the constants (the step loops or the round schedule) and adds
each step's scores of the (Poisson index, next variance) density; it
writes per path v_T, vI_rest and the five scores.  A first kernel
tabulates digamma(d + n) for n < PSI_TABLE, which the scores read.  On a
CUDA device the wrapper launches them or raises; on the CPU it runs the
plain version, ``ops/em_lrm.py::lrm_plain``, the same loop operation for
operation.
``ops/em_lrm.py::em_greeks_lrm`` turns the outputs into the Greeks.
"""

from __future__ import annotations

import ctypes

import torch

from .em import em_consts
from .em_lrm import lrm_jacobian, lrm_plain
from .fe import LANES
from .launch import COUNTER_RNGS, call_kernel, check_args, check_rng, \
    count_launch

N_OUT = 7   # v_T, vI_rest, five scores
PSI_TABLE = 1 << 14     # digamma(d + n) tabulated for n below this
SCHEDULES = (None, "steps", "rounds")   # the C entry's schedule: -1, 0, 1


def variant_name(rng: str) -> str:
    """The name under which a K2-LRM build is counted and reported."""
    return f"em_lrm_{rng}"


def em_lrm_scores_cuda(params, seed_words, epoch, base_path, *, N: int,
                       n_paths: int, device, rng: str = "philox",
                       poisson_cut: float | None = None,
                       schedule: str | None = None):
    """float32 (7, n_paths/128, 128) on ``device``: per path v_T, vI_rest =
    sum_t (v_t + v_{t+1}) - v_0 and the scores sum_t d log p_t / d(T,
    v_0, k, theta, sigma).

    params: float32 tensor (8,) on the CPU; its loop constants
    (``em_consts``) and their Jacobian (``lrm_jacobian``) go to the kernel
    by argument.  seed_words, epoch, base_path: as ``em_moments_cuda``.
    poisson_cut None means 4000.  schedule: None for the one K2 takes for
    these constants (``ops/em_cuda.py::em_round_schedule``), "steps" or
    "rounds" to pick one (every output is the same on either).  Each
    launch adds one to
    ``em_lrm_scores_cuda.launches`` and to
    ``em_lrm_scores_cuda.variant_launches[variant_name(rng)]``."""
    device, N, n_paths, k0, k1, epoch, base_path = check_args(
        params, seed_words, epoch, base_path, N, n_paths, device)
    check_rng(rng, "EM")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: expected one of "
                         f"{SCHEDULES}")
    if device.type == "cpu":
        return lrm_plain(params, (k0, k1), epoch, base_path, N=N,
                         n_paths=n_paths, rng=rng, poisson_cut=poisson_cut,
                         device=device)
    consts = (ctypes.c_float * 13)(*em_consts(params, N, poisson_cut))
    jac = lrm_jacobian(params, N).flatten().tolist()
    jac = (ctypes.c_float * len(jac))(*jac)
    out = torch.empty(N_OUT, n_paths // LANES, LANES, dtype=torch.float32,
                      device=device)
    psi = torch.empty(PSI_TABLE, dtype=torch.float32, device=device)
    name = variant_name(rng)
    call_kernel("nmch_em_lrm", name, device, consts, jac, k0, k1, epoch,
                base_path, N, n_paths, COUNTER_RNGS.index(rng),
                SCHEDULES.index(schedule) - 1, psi.data_ptr(), PSI_TABLE,
                out.data_ptr())
    count_launch(em_lrm_scores_cuda, name)
    return out


em_lrm_scores_cuda.launches = 0
em_lrm_scores_cuda.variant_launches = {}
