"""FE pathwise Greeks in forward mode: the plain version of kernel G1.

``ops/greeks.py`` differentiates the FE price by reverse-mode autograd;
the kernel ``csrc/fe_greeks.cu`` (G1) carries the tangents instead, in
forward mode, along each path.  This module is G1's plain version: the
same forward-mode arithmetic, one float32 torch op per kernel operation
in the kernel's order, so that on the card every path's payoff and its 8
tangents are bitwise G1's.

Per path, with (S, v) the state and primes the tangents with respect to
the 8 parameters (``PARAM_NAMES`` order), one Euler step of ``fe_step``:

    sqv = sqrt(v),  zc = rho_sd g1 + rhoc_sd g2,  f = one_rdt + sqv zc
    u   = B v + A + sqv (C g1),  S <- S f,  v <- |u|
    sqv' = v' (0.5 / sqv)
    S'  <- S' f + S (one_rdt' + sqv' zc + sqv zc'),  zc' = rho_sd' g1 + rhoc_sd' g2
    v'  <- sign(u) (B' v + B v' + A' + sqv' C g1 + sqv C' g1)

and at maturity the payoff (S_T - K)^+ with tangent 1{S_T > K} (S_T' -
K'), K' = e_{S_0} unless fix_strike (at S_T == K the tangent is 0, where
``jax.grad``'s is 1/2: a tie has probability zero).  The constants'
tangents (A', B', C', rho_sd', rhoc_sd', one_rdt') are one float32
Jacobian, computed on the host by autograd through
``ops/fe.py::fe_params_consts`` (``consts_jacobian``).  Only the
structurally non-zero terms are computed: v does not depend on S_0, r or
rho, so v carries 5 tangents and S 8, and each constant depends on a few
parameters only (``_DEPS``).

The draws are ``fe_moments_scan``'s (counter block j drives steps 2j and
2j + 1; the odd-N tail is skipped).  Price and Greeks are the float64
means of the float32 per-path values, as G1's reduction sums them.
"""

from __future__ import annotations

import functools

import torch

from ..rng.normal import normal4_from_bits, sqrt_f32
from .fe import fe_params_consts, make_draw4, path_index_grid

N_PARAMS = 8
S_0_DIR, V_0_DIR = 1, 2
# the directions (PARAM_NAMES indices) in which v has a tangent
V_DIRS = (0, 2, 4, 6, 7)
# fe_consts' order, and the parameters each constant depends on
CONSTS = ("A", "B", "C", "rho_sd", "rhoc_sd", "one_rdt")
_DEPS = {"A": (0, 4, 6), "B": (0, 4), "C": (0, 7), "rho_sd": (0, 5),
         "rhoc_sd": (0, 5), "one_rdt": (0, 3)}
A_, B_, C_, RHO_SD, RHOC_SD, ONE_RDT = range(6)


def consts_jacobian(params, N: int) -> torch.Tensor:
    """float32 (6, 8) on the CPU: d(A, B, C, rho_sd, rhoc_sd, one_rdt) /
    d(T, S_0, v_0, r, k, rho, theta, sigma) by autograd through
    ``fe_params_consts``; zero outside ``_DEPS``.  Cached per (params, N):
    the kernel's wrapper asks for it at every launch."""
    values = tuple(params.detach().to("cpu", torch.float32).tolist())
    return _consts_jacobian(values, int(N)).clone()


@functools.lru_cache(maxsize=256)
def _consts_jacobian(values: tuple, N: int) -> torch.Tensor:
    J = torch.autograd.functional.jacobian(
        lambda q: torch.stack(fe_params_consts(q, N)[2]),
        torch.tensor(values, dtype=torch.float32))
    for i, name in enumerate(CONSTS):
        off = [d for d in range(N_PARAMS) if d not in _DEPS[name]]
        assert not J[i, off].any(), f"d{name} has an unexpected direction"
    return J


def tangent_step(S, dS, v, dv, g1, g2, cst, J, half):
    """One Euler step of the state and its tangents (module docstring):
    dS a list of 8 tangents, dv a dict over V_DIRS; cst and J hold 0-dim
    float32 tensors (J[c][d] for d in _DEPS[c]), half is the 0-dim
    constant 0.5 (a tensor, so that 0.5 / sqv is a division).  Returns
    (S, dS, v, dv)."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    sqv = sqrt_f32(v)
    zc = rho_sd * g1 + rhoc_sd * g2
    f = one_rdt + sqv * zc
    cg = C * g1
    u = B * v + A + sqv * cg
    h = torch.div(half, sqv)
    sg = torch.sign(u)
    dsqv = {d: dv[d] * h for d in V_DIRS}
    dS_new = []
    for d in range(N_PARAMS):
        inner = J[ONE_RDT][d] if d in _DEPS["one_rdt"] else None
        if d in V_DIRS:
            t = dsqv[d] * zc
            inner = t if inner is None else inner + t
        if d in _DEPS["rho_sd"]:
            t = sqv * (J[RHO_SD][d] * g1 + J[RHOC_SD][d] * g2)
            inner = t if inner is None else inner + t
        dS_new.append(dS[d] * f if inner is None
                      else dS[d] * f + S * inner)
    dv_new = {}
    for d in V_DIRS:
        du = B * dv[d]
        if d in _DEPS["B"]:
            du = J[B_][d] * v + du
        if d in _DEPS["A"]:
            du = du + J[A_][d]
        du = du + dsqv[d] * cg
        if d in _DEPS["C"]:
            du = du + sqv * (J[C_][d] * g1)
        dv_new[d] = sg * du
    return S * f, dS_new, torch.abs(u), dv_new


def fe_greeks_plain(params, seed_words, epoch, base_path, *, N: int,
                    n_paths: int, rng: str = "philox",
                    fix_strike: bool = False, device=None,
                    per_path: bool = False):
    """(price, grads): float64 0-dim and (8,) tensors on ``device`` (default
    that of ``params``), the means of the paths' payoff and its tangents
    in PARAM_NAMES order.  per_path=True also returns the float32 (9,
    n_paths) table of payoff (row 0) and tangents (rows 1-8) per path, in
    G1's layout.

    params: float32 (8,); seed_words: the (k0, k1) key; path p draws from
    stream path base_path + p at ``epoch``.  The loop constants and their
    Jacobian are computed on the CPU and moved to ``device``."""
    device = params.device if device is None else torch.device(device)
    k0, k1 = (int(w) for w in seed_words)
    p_cpu = params.detach().to("cpu", torch.float32)
    S_0, v_0, cst = fe_params_consts(p_cpu, N)
    J = consts_jacobian(p_cpu, N)

    def dev(x):
        return x.detach().to(device)

    cst = tuple(dev(c) for c in cst)
    Jd = [[dev(J[i, d]) for d in range(N_PARAMS)] for i in range(6)]
    half = torch.tensor(0.5, device=device)
    path = path_index_grid(n_paths, base_path, device)
    draw = make_draw4(rng, path, torch.zeros_like(path), epoch, k0, k1)
    ones = torch.ones(path.shape, device=device)
    zeros = torch.zeros_like(ones)
    S, v = ones * dev(S_0), ones * dev(v_0)
    dS = [ones if d == S_0_DIR else zeros for d in range(N_PARAMS)]
    dv = {d: ones if d == V_0_DIR else zeros for d in V_DIRS}
    for j in range((N + 1) // 2):
        g0, g1, g2, g3 = normal4_from_bits(*draw(j))
        S, dS, v, dv = tangent_step(S, dS, v, dv, g0, g1, cst, Jd, half)
        if 2 * j + 1 < N:
            S, dS, v, dv = tangent_step(S, dS, v, dv, g2, g3, cst, Jd, half)
    K = dev(S_0)
    itm = S > K
    payoff = torch.clamp_min(S - K, 0.0)
    tangents = [torch.where(itm, dS[d] - ones if d == S_0_DIR
                            and not fix_strike else dS[d], zeros)
                for d in range(N_PARAMS)]
    table = torch.stack([payoff, *tangents]).reshape(1 + N_PARAMS, n_paths)
    means = table.double().sum(dim=1) / n_paths
    if per_path:
        return means[0], means[1:], table
    return means[0], means[1:]
