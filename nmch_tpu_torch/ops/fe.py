"""Forward-Euler Heston scheme: the step math and the plain PyTorch golden.

The counterpart of ``nmch_tpu/ops/fe.py`` for rng="philox" or
"threefry4", rot=1.
Per time step, with correlated standard normals (G1, G2)
(reference README.md:30-40, ``src/NMCH/methods/NMCH_FE.cu:41-48``):

    S <- S + r S dt + sqrt(v) S sqrt(dt) (rho G1 + sqrt(1-rho^2) G2)
    v <- | v + k (theta - v) dt + sigma sqrt(v) sqrt(dt) G1 |

RNG consumption contract (shared with the CUDA kernels ``csrc/fe.cu``
and ``csrc/sweep.cu``): counter block ``j`` of each path's stream
yields 4 u32 words -> 4 normals; words (0, 1) drive step ``2j`` and
words (2, 3) drive step ``2j+1``.  For odd N the final half-block is
skipped.

Layout: paths live in (n_paths/128, 128) tensors, path index =
row * 128 + lane, as in the JAX package.  Every float operation is a
separate float32 PyTorch op in the JAX code's order, so this is the
plain version the kernel is held against; the moments are summed in
float64, as the kernel's reduction is.
"""

from __future__ import annotations

import torch

from ..rng.normal import normal4_from_bits, sqrt_f32
from ..rng.philox import MASK32, philox4x32
from ..rng.threefry4 import draw4_threefry4

LANES = 128


def path_index_grid(n_paths: int, base: int = 0, device="cpu"):
    """(n_paths/128, 128) u32 path indices (int64), offset by ``base``."""
    if n_paths % LANES:
        raise ValueError(f"n_paths={n_paths} must be a multiple of {LANES}")
    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    return ((idx + int(base)) & MASK32).reshape(n_paths // LANES, LANES)


def fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt):
    """Loop-invariant constants of ``fe_step``:

        S <- S * (one_rdt + sqrt(v) * (rho_sd g1 + rhoc_sd g2))
        v <- | B v + A + sqrt(v) * (C g1) |

    Returns (A, B, C, rho_sd, rhoc_sd, one_rdt), each a float32 value
    rounded as ``nmch_tpu.ops.fe.fe_consts`` rounds it."""
    return (k * theta * dt,              # A
            1.0 - k * dt,                # B
            sigma * sqrt_dt,             # C
            rho * sqrt_dt,               # rho_sd
            sqrt_rho_c * sqrt_dt,        # rhoc_sd
            1.0 + r * dt)                # one_rdt


def fe_step(S, v, g1, g2, cst):
    """One Euler step: 8 float32 ops and one sqrt per path."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    sqv = sqrt_f32(v)
    zc = rho_sd * g1 + rhoc_sd * g2
    S = S * (one_rdt + sqv * zc)
    v = torch.abs(B * v + A + sqv * (C * g1))
    return S, v


def make_draw4(rng: str, path_lo, path_hi, epoch, k0, k1):
    """Block index -> 4 u32 words of each path's stream."""
    if rng == "philox":
        return lambda j: philox4x32(j, epoch, path_lo, path_hi, k0, k1)
    if rng == "threefry4":
        return lambda j: draw4_threefry4(j, epoch, path_lo, k0, k1,
                                         path_hi=path_hi)
    if rng == "threefry":
        raise ValueError("rng='threefry' is not ported yet (ROADMAP.md "
                         "Queue 1, slice 3: FE variants, item 10)")
    if rng == "tpu":
        raise ValueError("rng='tpu' is not ported yet (ROADMAP.md Queue 1, "
                         "slice 3: FE variants, item 12)")
    raise ValueError(f"unknown counter rng {rng!r} (expected 'philox' or "
                     f"'threefry4')")


def fe_two_steps(S, v, g0, g1, g2, g3, j: int, cst, N: int):
    """Steps 2j and 2j+1 of counter block ``j``; the second is skipped
    when 2j+1 >= N (the odd-N tail)."""
    S, v = fe_step(S, v, g0, g1, cst)
    if 2 * j + 1 < N:
        S, v = fe_step(S, v, g2, g3, cst)
    return S, v


def fe_terminal(params_vec, N: int, path_idx, epoch, k0, k1,
                rng: str = "philox"):
    """Simulate all paths to maturity; returns (S_T, v_T) in the layout of
    ``path_idx``.  params_vec: f32[8] = (T, S_0, v_0, r, k, rho, theta,
    sigma) on the device of ``path_idx``.

    The parameters and ``epoch`` may also carry leading point axes that
    broadcast against ``path_idx`` (``ops/sweep.py``: params (8, P, 1,
    1), epoch (P, 1, 1), path_idx (R, 128)); every float operation is
    then the single-point one, elementwise."""
    draw = make_draw4(rng, path_idx, torch.zeros_like(path_idx), epoch,
                      k0, k1)
    return euler_paths(params_vec, N, path_idx,
                       lambda j: normal4_from_bits(*draw(j)))


def euler_paths(params_vec, N: int, like: torch.Tensor, normals4):
    """(S_T, v_T) of paths laid out like ``like`` (its shape and device):
    ``normals4(j)`` gives the 4 normals of counter block j, for steps 2j
    and 2j+1, and is called for j = 0, 1, ... in order."""
    T, S_0, v_0, r, k, rho, theta, sigma = params_vec.unbind()
    dt = T / N
    sqrt_dt = sqrt_f32(dt)
    sqrt_rho_c = sqrt_f32(1.0 - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)

    ones = torch.full(like.shape, 1.0, device=like.device)
    S = ones * S_0
    v = ones * v_0
    for j in range((N + 1) // 2):
        g0, g1, g2, g3 = normals4(j)
        S, v = fe_two_steps(S, v, g0, g1, g2, g3, j, cst, N)
    return S, v


def moments_f64(payoff: torch.Tensor):
    """(E[X], E[X^2]) as float64 0-dim tensors: payoff and payoff^2 in
    float32, summed in float64, as the kernels' reduction is."""
    n = payoff.numel()
    return (payoff.double().sum() / n,
            (payoff * payoff).double().sum() / n)


def fe_moments_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                    rng: str = "philox"):
    """Golden engine: (E[X], E[X^2]) with X = (S_T - K)^+, K = S_0, as
    float64 0-dim tensors (``moments_f64``)."""
    S_T, _ = fe_terminal(params_vec, N, path_idx, epoch, k0, k1, rng=rng)
    return moments_f64(torch.clamp_min(S_T - params_vec[1], 0.0))
