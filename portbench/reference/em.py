"""Broadie-Kaya exact-method payoffs, the plain reference of the EM pricers.

Per step (edo01/NMCH ``NMCH_EM.cu:96-124``) the variance moves through its
noncentral chi-square law as a Poisson mixture of gammas:

    lambda = lam_const v_t,  N_p ~ Poisson(lambda),
    v_{t+dt} = vfac Gamma(d + N_p),  d = 2 k theta / sigma^2,

vI is the trapezoidal integral of v, and S_T = exp(m + sqrt((1 - rho^2)
vI) G) with m = ln S_0 + r T - vI/2 + (rho/sigma)(v_T - v_0 - k theta T +
k vI).  Poisson: Knuth's product below lambda = 10, Hoermann's PTRS up to
the cut, a rounded normal at and above it.  Gamma: Marsaglia-Tsang, with
the alpha < 1 boost U^(1/alpha) from word 3 of a lane's first round.

Consumption (the kernels' contract): in each round every lane still
drawing takes one block at its own counter, which advances only while the
lane draws; a sampler stops after 64 (Poisson) or 32 (Gamma) rounds and
falls back to floor(lambda + 1/2) or alpha C.  The terminal normal takes
one more block.  Here a sampler tries ``rounds`` rounds of every lane at
once on the blocks at ctr, ctr + 1, ... (``BlockWindow``) and takes, lane
by lane, the first round it accepts: the same draws, result and counter
as one round at a time.

Alongside the payoffs it counts, over all lanes, the sampler rounds of
each kind and the steps in each Poisson regime: the data-dependent work
that ``portbench/roofline.py`` prices.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import BlockWindow, boxmuller, sqrt_f32, uniform_halfopen01, \
    uniform_open01

_F32 = np.float32
_HALF_LN_2PI = float(_F32(0.9189385332046727))
_C12 = float(_F32(1.0 / 12.0))
_C360 = float(_F32(1.0 / 360.0))
_C1260 = float(_F32(1.0 / 1260.0))
_THIRD = float(_F32(1.0 / 3.0))
POISSON_SMALL = 10.0
POISSON_ROUNDS, GAMMA_ROUNDS = 64, 32
COUNTS = ("steps_small", "steps_mid", "steps_large", "rounds_knuth",
          "rounds_ptrs", "rounds_large", "rounds_gamma", "boosts", "paths")

CONST_NAMES = ("v_0", "S_0", "lam_const", "d", "vfac", "half_dt", "log_S0",
               "m0", "rho_s", "ktT", "k", "one_m_rho2", "poisson_cut")


def em_constants(rows: np.ndarray, N: int, poisson_cut: float) -> dict:
    """Each point's loop constants as float32 (P,) CPU tensors, in the
    float32 operations of the kernel's host code; the two transcendentals
    are taken in float64 and rounded once."""
    p = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
    T, S_0, v_0, r, k, rho, theta, sigma = p.unbind(1)
    dt = T / N
    exp_kdt = torch.exp((-k * dt).double()).float()
    sig2 = sigma * sigma
    d = 2.0 * k * theta / sig2
    one_m = 1.0 - exp_kdt
    log_S0 = torch.log(S_0.double()).float()
    cols = (v_0, S_0, 2.0 * k * exp_kdt / (sig2 * one_m), d,
            sig2 * one_m / (2.0 * k), dt * 0.5, log_S0, log_S0 + r * T,
            rho / sigma, k * theta * T, k, 1.0 - rho * rho,
            torch.full_like(T, float(_F32(poisson_cut))))
    return dict(zip(CONST_NAMES, cols))


def _stirling_corr(zz):
    i2 = (1.0 / zz) * (1.0 / zz)
    c = _C12 - i2 * (_C360 - i2 * _C1260)
    return c / zz


def _ptrs_log_accept_rhs(kf, lam, loglam):
    z = kf + 1.0
    shift = z < 3.0
    logm = torch.where(shift, torch.log(z * (z + 1.0)), 0.0)
    w = torch.where(shift, z + 2.0, z)
    t = (w - lam) / lam
    return (-(w - 0.5) * torch.log1p(t) + (kf - w + 0.5) * loglam
            + (w - lam) - _HALF_LN_2PI - _stirling_corr(w) + logm)


def _ptrs_constants(sqrt_lam):
    b = 0.931 + 2.53 * sqrt_lam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + torch.full_like(b, 1.1328) / (b - 3.4)
    vr = 0.9277 - torch.full_like(b, 3.6224) / (b - 2.0)
    return b, a, invalpha, vr


def _first(done, rounds: int):
    """(any, first round index, rounds taken) of a (R, ...) bool mask."""
    hit = done.any(0)
    first = torch.argmax(done.to(torch.uint8), dim=0)
    taken = torch.where(hit, first + 1, rounds)
    return hit, first, taken


def poisson(lam, ctr, window: BlockWindow, cut: float, counts: dict,
            rounds: int = 8):
    """N_p ~ Poisson(lam) per lane: (float32 N_p, counters after)."""
    small = lam < POISSON_SMALL
    large = (lam >= cut) & ~small
    mid = ~(small | large)
    any_small, any_mid, any_large = (bool(x) for x in torch.stack(
        [small.any(), mid.any(), large.any()]).tolist())
    for name, m in (("steps_small", small), ("steps_mid", mid),
                    ("steps_large", large)):
        counts[name] += m.sum()
    sqrt_lam = sqrt_f32(lam)
    target = torch.exp(-lam)
    if any_mid:
        b, a, invalpha, vr = _ptrs_constants(sqrt_lam)
        loglam = torch.log(lam)
    active = torch.ones_like(small)
    result = torch.zeros_like(lam)
    t = torch.ones_like(lam)
    cnt = torch.zeros_like(lam)
    rnd = 0
    while rnd < POISSON_ROUNDS and bool(active.any()):
        R = min(rounds, POISSON_ROUNDS - rnd)
        w0, w1, w2, w3 = window.words(ctr, R)
        done = torch.zeros(w0.shape, dtype=torch.bool, device=lam.device)
        kd = torch.zeros(w0.shape, device=lam.device)
        if any_large and rnd == 0:
            g, _ = boxmuller(uniform_open01(w0[0]), uniform_open01(w1[0]))
            k_large = torch.clamp_min(
                torch.floor(lam + sqrt_lam * g + 0.5), 0.0)
            done[0] |= large
            kd[0] = torch.where(large, k_large, kd[0])
        if any_mid:
            U = uniform_halfopen01(w0) - 0.5
            V = uniform_halfopen01(w1)
            us = 0.5 - torch.abs(U)
            kf = torch.floor((2.0 * a / us + b) * U + lam + 0.43)
            squeeze = (us >= 0.07) & (V <= vr)
            rej = (kf < 0.0) | ((us < 0.013) & (V > us))
            logacc = torch.log(V * invalpha / (a / (us * us) + b))
            full = logacc <= _ptrs_log_accept_rhs(kf, lam, loglam)
            done |= mid & (squeeze | (~rej & full))
            kd = torch.where(mid, torch.clamp_min(kf, 0.0), kd)
        if any_small:
            us4 = uniform_open01(torch.stack([w0, w1, w2, w3], 1))
            for r in range(R):
                for u in us4[r]:
                    still = t >= target
                    t = torch.where(still, t * u, t)
                    cnt = cnt + torch.where(still, 1.0, 0.0)
                done[r] |= small & (t < target)
                kd[r] = torch.where(small, torch.clamp_min(cnt - 1.0, 0.0),
                                    kd[r])
        hit, first, taken = _first(done, R)
        pick = torch.gather(kd, 0, first.unsqueeze(0))[0]
        result = torch.where(active & hit, pick, result)
        used = torch.where(active, taken, 0)
        for name, m in (("rounds_knuth", small), ("rounds_ptrs", mid),
                        ("rounds_large", large)):
            counts[name] += torch.where(m, used, 0).sum()
        ctr = ctr + used
        active = active & ~hit
        rnd += R
    result = torch.where(active, torch.floor(lam + 0.5), result)
    return result, ctr


def gamma(alpha0, ctr, window: BlockWindow, counts: dict, rounds: int = 6):
    """Gamma(alpha0, 1) per lane: (float32 draw, counters after)."""
    need_boost = alpha0 < 1.0
    counts["boosts"] += need_boost.sum()
    alpha = alpha0 + torch.where(need_boost, 1.0, 0.0)
    d = alpha - _THIRD
    cmul = torch.rsqrt(9.0 * d)
    active = torch.ones_like(need_boost)
    result = torch.zeros_like(alpha0)
    C = torch.ones_like(alpha0)
    rnd = 0
    while rnd < GAMMA_ROUNDS and bool(active.any()):
        R = min(rounds, GAMMA_ROUNDS - rnd)
        w0, w1, w2, w3 = window.words(ctr, R)
        x, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
        v1 = 1.0 + cmul * x
        v = v1 * v1 * v1
        u = uniform_open01(w2)
        x2 = x * x
        squeeze = u < 1.0 - 0.0331 * x2 * x2
        logv = torch.log(torch.clamp_min(v, float(_F32(1e-37))))
        full = torch.log(u) < (0.5 * x2 + d * (1.0 - v + logv))
        ok = (v > 0.0) & (squeeze | full)
        if rnd == 0:
            C = torch.where(
                need_boost,
                torch.exp(torch.log(uniform_open01(w3[0])) / alpha0), 1.0)
        hit, first, taken = _first(ok, R)
        pick = torch.gather(d * v * C, 0, first.unsqueeze(0))[0]
        result = torch.where(active & hit, pick, result)
        used = torch.where(active, taken, 0)
        counts["rounds_gamma"] += used.sum()
        ctr = ctr + used
        active = active & ~hit
        rnd += R
    result = torch.where(active, alpha * C, result)
    return result, ctr


def em_payoffs(rows: np.ndarray, key: tuple[int, int], epochs, N: int,
               n_paths: int, poisson_cut: float, device,
               dtype=torch.float32):
    """(float32 (P, n_paths) payoffs of P points, point p at epochs[p],
    the counts of ``COUNTS`` summed over all P * n_paths lanes, and each
    lane's final block counter, int64 (P, n_paths))."""
    P = rows.shape[0]
    tab = em_constants(rows, N, poisson_cut)
    c = {n: v.to(device).reshape(P, 1) for n, v in tab.items()}
    cut = float(tab["poisson_cut"][0])
    ep = torch.tensor([int(e) for e in epochs], dtype=torch.int64,
                      device=device).reshape(P, 1)
    path = torch.arange(n_paths, dtype=torch.int64,
                        device=device).reshape(1, n_paths)
    window = BlockWindow(ep, path, key)
    counts = {n: torch.zeros((), dtype=torch.int64, device=device)
              for n in COUNTS}
    counts["paths"] += P * n_paths
    low = {n: c[n].to(dtype) for n in ("v_0", "vfac", "half_dt", "m0",
                                       "rho_s", "ktT", "k", "one_m_rho2",
                                       "S_0")}
    Vt = torch.zeros(P, n_paths, device=device, dtype=dtype) + low["v_0"]
    vI = torch.zeros_like(Vt)
    ctr = torch.zeros(P, n_paths, dtype=torch.int64, device=device)
    for _ in range(N):
        lam = c["lam_const"] * Vt.float()
        N_p, ctr = poisson(lam, ctr, window, cut, counts)
        gam, ctr = gamma(c["d"] + N_p, ctr, window, counts)
        Vt_next = low["vfac"] * gam.to(dtype)
        vI = vI + (Vt + Vt_next)
        Vt = Vt_next
    vI = vI * low["half_dt"]
    m = (low["m0"] - 0.5 * vI
         + low["rho_s"] * (Vt - low["v_0"] - low["ktT"] + low["k"] * vI))
    sig_eff = sqrt_f32((low["one_m_rho2"] * vI).float()).to(dtype)
    w0, w1, _, _ = window.words(ctr, 1)
    g, _ = boxmuller(uniform_open01(w0[0]), uniform_open01(w1[0]))
    S_T = torch.exp(m + sig_eff * g.to(dtype))
    payoff = torch.clamp_min(S_T - low["S_0"], 0.0).float()
    return payoff, {n: int(v) for n, v in counts.items()}, ctr + 1


def payoffs(config: dict, rows: np.ndarray, key: tuple[int, int], epochs,
            n_paths: int, device, dtype=torch.float32):
    """(payoffs, counts) of the configuration, as every method's reference
    gives them."""
    pay, counts, _ = em_payoffs(rows, key, epochs, config["N"], n_paths,
                                config["poisson_cut"], device, dtype)
    return pay, counts
