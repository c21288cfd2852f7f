"""Poisson and Gamma samplers on per-path streams (plain PyTorch).

The counterpart of ``nmch_tpu/ops/sampling.py``, which rebuilds the
reference EM kernel's per-thread samplers (``NMCH_EM.cu:11-55,102,325``):

* Poisson(lam): Knuth's multiplication below lam = 10, Hörmann's PTRS
  transformed rejection up to the cut, and a continuity-corrected normal
  approximation at and above it (default cut 4000, curand's switch);
* Gamma(alpha, 1): Marsaglia–Tsang, with the alpha < 1 boost
  U^(1/alpha) drawn once, in each lane's first round.

Consumption contract (shared with ``csrc/em.cu``): in every round each
lane still active draws one 4-word block at its own counter, and the
counter advances only while the lane is active.  The JAX package runs
this as masked rounds over all lanes; here it is a Python loop over
rounds while any lane is active and fewer than ``max_rounds`` have run,
with the same freeze rules, so a lane's draws, result and final counter
are a pure function of its own stream.  Stragglers after the cap (per
lane probability < 1e-12) fall back to ``floor(lam + 0.5)`` and
``alpha * C``.  A regime that no lane takes is not computed.

Every float operation is a separate float32 PyTorch op in the JAX code's
order (``-fmad=false`` keeps the kernel to the same operations).  The
transcendentals are ``torch.log``, ``torch.exp``, ``torch.log1p`` and
``torch.rsqrt``: on the CPU they are not bitwise XLA's (a rare lane then
takes another accept/reject decision than JAX's), on a CUDA tensor they
are the libdevice functions that the kernel calls.

u32 words and counters are carried in int64, as in ``rng/philox.py``.

The stateful families (xorwow, mrg32k3a) draw the same way from a lane's
recurrence state instead of its counter: ``stream_state_init`` gives the
6-word state of stream (seed, path, epoch), a round's block is four
successive recurrence outputs, and the state advances only while the
lane is active (``_sel``).  The samplers take the raw output words
through ``uniform_open01``/``uniform_halfopen01``, MRG32k3a's z in
[0, m1) directly, as ``nmch_tpu`` does; the FE goldens use
``u01_from_out``/``u01_from_z`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rng.normal import boxmuller, sqrt_f32, uniform_halfopen01, \
    uniform_open01
from ..rng.philox import MASK32, philox4x32
from ..rng.threefry4 import draw4_threefry4

_F32 = np.float32
_HALF_LN_2PI = float(_F32(0.9189385332046727))   # 0.5*ln(2*pi)
_C12 = float(_F32(1.0 / 12.0))
_C360 = float(_F32(1.0 / 360.0))
_C1260 = float(_F32(1.0 / 1260.0))
_THIRD = float(_F32(1.0 / 3.0))

# regime thresholds (mirrors curand's published algorithm switching)
POISSON_SMALL = 10.0
POISSON_LARGE = 4000.0

STATEFUL_RNGS = ("mrg32k3a", "xorwow")


def _stirling_corr(zz):
    """Three-term Stirling correction 1/12z - 1/360z^3 + 1/1260z^5."""
    i2 = (1.0 / zz) * (1.0 / zz)
    c = _C12 - i2 * (_C360 - i2 * _C1260)
    return c / zz


def lgamma_kp1(kf: torch.Tensor) -> torch.Tensor:
    """log(k!) = lgamma(k+1) for float32 k >= 0: three-term Stirling on
    z >= 3, shifted up by 2 below (``nmch_tpu.ops.sampling.lgamma_kp1``)."""
    z = kf + 1.0
    shift = z < 3.0
    logm = torch.where(shift, torch.log(z * (z + 1.0)), 0.0)
    zz = torch.where(shift, z + 2.0, z)
    lz = torch.log(zz)
    stirling = ((zz - 0.5) * lz - zz + _HALF_LN_2PI + _stirling_corr(zz))
    return stirling - logm


def ptrs_log_accept_rhs(kf, lam, loglam):
    """kf*log(lam) - lam - lgamma(kf+1) in the cancellation-free form of
    ``nmch_tpu.ops.sampling.ptrs_log_accept_rhs`` (log1p of the relative
    offset from lam, then the O(1) terms)."""
    z = kf + 1.0
    shift = z < 3.0
    logm = torch.where(shift, torch.log(z * (z + 1.0)), 0.0)
    w = torch.where(shift, z + 2.0, z)
    t = (w - lam) / lam
    return (-(w - 0.5) * torch.log1p(t) + (kf - w + 0.5) * loglam
            + (w - lam) - _HALF_LN_2PI - _stirling_corr(w) + logm)


def ptrs_constants(sqrt_lam: torch.Tensor):
    """PTRS's constants (Hörmann 1993, transformed rejection with squeeze)
    for lam = sqrt_lam^2: (b, a, 1/alpha, v_r), float32.  The two quotients
    are true divisions, as in ``nmch_tpu`` and ``csrc/em_path.cuh``: a
    Python number over a tensor is torch's reciprocal times the number,
    which rounds twice and moves a quarter of the values by an ulp (enough
    to turn a rare acceptance, seen on the card at explore's point
    (0.1, 0.5, 1.0) with N=1000)."""
    b = 0.931 + 2.53 * sqrt_lam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + torch.full_like(b, 1.1328) / (b - 3.4)
    vr = 0.9277 - torch.full_like(b, 3.6224) / (b - 2.0)
    return b, a, invalpha, vr


def make_lane_draw4(rng: str):
    """One 4-word block per lane at that lane's counter:
    ``draw4(ctr, epoch, path_lo, path_hi, k0, k1) -> 4 u32 words``."""
    if rng == "philox":
        return philox4x32
    if rng == "threefry4":
        return lambda ctr, ep, lo, hi, k0, k1: \
            draw4_threefry4(ctr, ep, lo, k0, k1, path_hi=hi)
    if rng in STATEFUL_RNGS:
        raise ValueError(f"rng={rng!r} is a stateful family: it draws "
                         f"from a lane's state (make_stream_draw4), not "
                         f"at a counter")
    raise ValueError(f"unknown lane rng {rng!r} (expected 'philox' or "
                     f"'threefry4')")


def _sel(pred, new, old):
    """Per-lane select over a stream state (a tensor or a tuple of)."""
    if isinstance(new, tuple):
        return tuple(torch.where(pred, n, o) for n, o in zip(new, old))
    return torch.where(pred, new, old)


def make_stream_draw4(rng: str, epoch, path_lo, path_hi, k0, k1):
    """``draw4s(st) -> (w0, w1, w2, w3, st_next)`` over all four families.

    Counter families (philox/threefry4): st is the lane's u32 block
    counter and st_next = st + 1.  Stateful families: st is the flat
    6-tuple of recurrence state words and the four words are four
    successive recurrence outputs (curand's per-thread order,
    ``NMCH_EM.cu:96-124``)."""
    if rng == "mrg32k3a":
        from ..rng.mrg32k3a import mrg_step

        def draw4s(st):
            s1, s2 = st[:3], st[3:]
            ws = []
            for _ in range(4):
                z, s1, s2 = mrg_step(s1, s2)
                ws.append(z)
            return (*ws, s1 + s2)
        return draw4s
    if rng == "xorwow":
        from ..rng.xorwow import xorwow_step

        def draw4s(st):
            s, d = st[:5], st[5]
            ws = []
            for _ in range(4):
                o, s, d = xorwow_step(s, d)
                ws.append(o)
            return (*ws, s + (d,))
        return draw4s
    draw4 = make_lane_draw4(rng)

    def draw4s(ctr):
        w0, w1, w2, w3 = draw4(ctr, epoch, path_lo, path_hi, k0, k1)
        return w0, w1, w2, w3, (ctr + 1) & MASK32
    return draw4s


def stream_state_init(rng: str, seed: int, path_lo, epoch: int):
    """Initial state of a stateful family's stream (seed, path, epoch):
    the flat 6-tuple ``make_stream_draw4`` advances, each word shaped like
    path_lo (one skip-ahead per path)."""
    if rng == "mrg32k3a":
        from ..rng.mrg32k3a import mrg_state_at
        s1, s2 = mrg_state_at(seed, path_lo, epoch)
        return s1 + s2
    if rng == "xorwow":
        from ..rng.xorwow import xorwow_state_at
        s, d = xorwow_state_at(seed, path_lo, epoch)
        return s + (d,)
    raise ValueError(f"{rng!r} is not a stateful family")


def poisson_from_stream(lam, ctr, epoch, path_lo, path_hi, k0, k1,
                        max_rounds: int = 64, rng: str = "philox",
                        large_cut: float | None = None):
    """N_p ~ Poisson(lam) per lane; returns (N_p float32, new ctr).

    lam: float32 tensor; ctr: int64 tensor of u32 block counters, of the
    same shape, or for a stateful rng the 6-tuple of state words.
    large_cut: lam at and above which the normal approximation replaces
    PTRS (None = 4000, curand's switch)."""
    draw4s = make_stream_draw4(rng, epoch, path_lo, path_hi, k0, k1)
    cut = float(_F32(POISSON_LARGE if large_cut is None else large_cut))
    small = lam < POISSON_SMALL
    large = (lam >= cut) & ~small       # Knuth wins below 10 at any cut
    mid = ~(small | large)
    any_small, any_mid, any_large = (bool(m.any()) for m in
                                     (small, mid, large))
    sqrt_lam = sqrt_f32(lam)
    target = torch.exp(-lam)                    # Knuth product threshold
    if any_mid:
        b, a, invalpha, vr = ptrs_constants(sqrt_lam)
        loglam = torch.log(lam)

    active = torch.ones_like(small)
    result = torch.zeros_like(lam)
    t = torch.ones_like(lam)
    cnt = torch.zeros_like(lam)
    rnd = 0
    while rnd < max_rounds and bool(active.any()):
        w0, w1, w2, w3, c_next = draw4s(ctr)
        done = torch.zeros_like(active)
        kd = torch.zeros_like(lam)
        if any_large:
            # one normal-approximation draw
            g, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
            k_large = torch.clamp_min(
                torch.floor(lam + sqrt_lam * g + 0.5), 0.0)
            done = done | large
            kd = torch.where(large, k_large, kd)
        if any_mid:
            # one PTRS round
            U = uniform_halfopen01(w0) - 0.5
            V = uniform_halfopen01(w1)
            us = 0.5 - torch.abs(U)
            kf = torch.floor((2.0 * a / us + b) * U + lam + 0.43)
            squeeze = (us >= 0.07) & (V <= vr)
            rej = (kf < 0.0) | ((us < 0.013) & (V > us))
            logacc = torch.log(V * invalpha / (a / (us * us) + b))
            full = logacc <= ptrs_log_accept_rhs(kf, lam, loglam)
            mid_ok = squeeze | (~rej & full)
            done = done | (mid & mid_ok)
            kd = torch.where(mid, torch.clamp_min(kf, 0.0), kd)
        if any_small:
            # Knuth, 4 uniforms per round
            for w in (w0, w1, w2, w3):
                u = uniform_open01(w)
                still = t >= target
                t = torch.where(still, t * u, t)
                cnt = cnt + torch.where(still, 1.0, 0.0)
            done = done | (small & (t < target))
            kd = torch.where(small, torch.clamp_min(cnt - 1.0, 0.0), kd)

        result = torch.where(active & done, kd, result)
        ctr = _sel(active, c_next, ctr)
        active = active & ~done
        rnd += 1
    # straggler fallback (P < 1e-12/lane): distribution mode
    result = torch.where(active, torch.floor(lam + 0.5), result)
    return result, ctr


def gamma_ms_from_stream(alpha0, ctr, epoch, path_lo, path_hi, k0, k1,
                         max_rounds: int = 32, rng: str = "philox"):
    """Gamma(alpha0, 1) per lane by Marsaglia–Tsang; returns (gamma
    float32, new ctr).  For alpha0 < 1 the shape is boosted by 1 and the
    result multiplied by U^(1/alpha0), U from word 3 of the lane's first
    round (the reference's pre-loop hoist, NMCH_EM.cu:29-38)."""
    draw4s = make_stream_draw4(rng, epoch, path_lo, path_hi, k0, k1)
    need_boost = alpha0 < 1.0
    alpha = alpha0 + torch.where(need_boost, 1.0, 0.0)
    d = alpha - _THIRD
    cmul = torch.rsqrt(9.0 * d)

    active = torch.ones_like(need_boost)
    result = torch.zeros_like(alpha0)
    C = torch.ones_like(alpha0)
    rnd = 0
    while rnd < max_rounds and bool(active.any()):
        w0, w1, w2, w3, c_next = draw4s(ctr)
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
            # boost factor drawn once, in each lane's first round
            C = torch.where(
                need_boost,
                torch.exp(torch.log(uniform_open01(w3)) / alpha0), 1.0)
        result = torch.where(active & ok, d * v * C, result)
        ctr = _sel(active, c_next, ctr)
        active = active & ~ok
        rnd += 1
    # straggler fallback: distribution mean
    result = torch.where(active, alpha * C, result)
    return result, ctr
