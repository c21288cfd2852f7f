"""Normal variates from raw uint32 bits.

The constructions of ``nmch_tpu/rng/normal.py`` on int64 tensors that
hold u32 words, with the same float32 constants and the same order of
float32 operations, so that the normals are bitwise those of the JAX
package: the half-circle Box–Muller of ``box="hc"`` (``normal_pair_hc``),
its op-trimmed ``fast`` polynomials and the packed-phase 3-word blocks of
the device generator (``normal4_from_bits3``, boxes hc16/hc16f, with the
radius-antithetic scale of each pair when ``with_scale``); the
turns-based ``boxmuller`` (with its ``sincos_2pi`` polynomials) of
``box="turns"`` and of the EM samplers; and the QMC engine's inverse
normal CDF ``ndtri_fast_pm``/``ndtri_fast`` (two polynomials in
sqrt(-2 ln pm), on ``neg2log``).  Two traps of PyTorch's CPU float32 are
avoided here:

* ``torch.sqrt`` on float32 is not always correctly rounded; the square
  root is taken in float64 and rounded once to float32, which is the
  correctly rounded result (``sqrt_f32``).
* An int64 -> float32 bitcast goes through int32, so words at or above
  2^31 are first moved into the signed range (``f32_from_u32``).

``boxmuller`` takes ``torch.log`` of its radius uniform, which is not
bitwise XLA's ``log`` on the CPU (about 95% of float32 inputs agree);
on a CUDA tensor it is libdevice's ``logf``, as in the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

# The coefficient tables of nmch_tpu/rng/normal.py, as float32 values.
# sin(z) = z * P(z^2) on |z| <= pi/2, max abs err 5.9e-7
_SIN_HC = tuple(float(np.float32(c)) for c in
                (0.99999662, -0.16664828, 8.3063252e-3, -1.8363653e-4))
# cos(z) = Q(z^2) on |z| <= pi/2, max abs err 4.7e-8
_COS_HC = tuple(float(np.float32(c)) for c in
                (0.99999995, -0.49999905, 4.1663585e-2, -1.38537043e-3,
                 2.31539307e-5))
# -2*ln(1+t) = t * M(t) on t in [0,1), relative err 1.9e-7
_NEG2LOG = tuple(float(np.float32(-2.0 * c)) for c in
                 (0.99999981, -0.49997405, 0.33275475, -0.24495434,
                  0.17745159, -0.1076805, 0.04408875, -0.00853896))
_NEG2LN2 = float(np.float32(-2.0 * np.log(2.0)))       # -1.3862944
_C254LN2 = float(np.float32(-127.0 * _NEG2LN2))        # cancels at u=1
# the shorter polynomials of the device generator's box="hc16f" (fast=True):
# sin(z) = z * P(z^2), |z| <= pi/2, max abs err 6.8e-5
_SIN_F = tuple(float(np.float32(c)) for c in
               (0.9996968, -0.16567308, 7.514376e-3))
# cos(z) = Q(z^2), max abs err 6.7e-6
_COS_F = tuple(float(np.float32(c)) for c in
               (0.9999933, -0.49991244, 4.1487746e-2, -1.2712093e-3))
# -2*ln(1+t) = t * M(t), t in [0,1), rel err 9.4e-5; exactly -2 ln 2 at t=1
_NEG2LOG_F = tuple(float(np.float32(-2.0 * c)) for c in
                   (0.99994326, -0.49697754, 0.30629954, -0.15742502,
                    0.0413069))
_SCALE_FLOOR = 1e-35        # the with_scale divisor's floor (q can be 0)
_PI = float(np.float32(np.pi))
_PI_1P5 = float(np.float32(1.5 * np.pi))
_MAGIC = 12582912.0                                    # 1.5 * 2^23

_SIGN = 0x80000000
_MANT = 0x007FFFFF
_ONE = 0x3F800000


def f32_from_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret u32 words (held in int64) as float32."""
    signed = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return signed.to(torch.int32).view(torch.float32)


def u32_from_f32(f: torch.Tensor) -> torch.Tensor:
    """Reinterpret float32 as u32 words held in int64."""
    return f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (IEEE ``sqrtf``)."""
    return torch.sqrt(x.double()).float()


def uniform_open01(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 uniform in (0, 1]: the top 23 bits become the
    mantissa of a float in [1, 2), subtracted from 2."""
    return 2.0 - f32_from_u32((bits >> 9) | _ONE)


def uniform_halfopen01(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 uniform in [0, 1)."""
    return f32_from_u32((bits >> 9) | _ONE) - 1.0


# sincos_2pi's Taylor coefficients in r, as nmch_tpu/rng/normal.py writes
# them (cos((pi/2) r) through r^8, sin((pi/2) r)/r through r^7); each
# polynomial step is `c * r2 + coef` in that order
_SC_COS = tuple(float(np.float32(c)) for c in
                (9.1926027483e-4, -2.0863480763e-2, 2.5366950790e-1,
                 -1.2337005501, 1.0))
_SC_SIN = tuple(float(np.float32(c)) for c in
                (-4.6817541353e-3, 7.9692626247e-2, -6.4596409750e-1,
                 1.5707963268))


def sincos_2pi(u: torch.Tensor):
    """(cos(2 pi u), sin(2 pi u)) for float32 u in [0, 1): exact quadrant
    reduction u = (q + r)/4, r in [-1/2, 1/2], polynomials in r and a
    quadrant swap/sign fixup (``nmch_tpu.rng.normal.sincos_2pi``)."""
    x = u * 4.0
    q = torch.floor(x + 0.5)
    r = x - q
    qi = q.to(torch.int32)
    r2 = r * r
    c = _SC_COS[0]
    for coef in _SC_COS[1:]:
        c = c * r2 + coef
    s = _SC_SIN[0]
    for coef in _SC_SIN[1:]:
        s = s * r2 + coef
    s = s * r
    odd = (qi & 1) != 0
    cos_base = torch.where(odd, s, c)
    sin_base = torch.where(odd, c, s)
    cos_neg = ((qi + 1) & 2) != 0
    sin_neg = (qi & 2) != 0
    return (torch.where(cos_neg, -cos_base, cos_base),
            torch.where(sin_neg, -sin_base, sin_base))


def boxmuller(u1: torch.Tensor, u2: torch.Tensor):
    """Two (0, 1] uniforms -> two N(0,1) float32 values:
    r = sqrt(-2 ln u1), (r cos, r sin)(2 pi u2)."""
    r = sqrt_f32(-2.0 * torch.log(u1))
    c, s = sincos_2pi(u2)
    return r * c, r * s


def neg2log(u: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """-2*ln(u) for float32 u in (0, 1], from u's own bit pattern:
    u = m * 2^(e-127), the biased exponent converted to float by the
    1.5*2^23 magic number and ln m by a degree-8 polynomial (degree 4
    with ``fast``)."""
    b = u32_from_f32(u)
    ebf = f32_from_u32((b >> 23) | 0x4B400000) - _MAGIC
    m = f32_from_u32((b & _MANT) | _ONE)
    t = m - 1.0
    coefs = _NEG2LOG_F if fast else _NEG2LOG
    p = coefs[-1]
    for c in coefs[-2::-1]:
        p = p * t + c
    q = ebf * _NEG2LN2 + _C254LN2 + t * p
    # polynomial + rounding residue can dip ~1 ulp below zero at u ~ 1
    return torch.clamp_min(q, 0.0)


def _halfcircle_pair(w_r: torch.Tensor, f: torch.Tensor,
                     sign_bits: torch.Tensor, fast: bool = False,
                     with_scale: bool = False):
    """Shared half-circle Box–Muller core: radius word w_r, phase carrier
    f in [1, 2), and the pair's random sign in bit 31 of sign_bits.
    ``fast`` takes the shorter polynomials (_SIN_F, _COS_F, _NEG2LOG_F).

    with_scale=True also returns the pair's radius-antithetic scale
    s = sqrt(-2 ln(1-u) / -2 ln u) from its radius uniform u
    (``ops/fe.py::radius_antithetic_scale``'s meaning, without its
    exp and log); the divisor is floored at 1e-35 where -2 ln u rounds
    to 0, so the scale stays finite on a pair of zeros."""
    u = uniform_open01(w_r)
    q = neg2log(u, fast=fast)
    R = f32_from_u32(u32_from_f32(sqrt_f32(q)) ^ sign_bits)
    z = f * _PI - _PI_1P5
    z2 = z * z
    sin_c = _SIN_F if fast else _SIN_HC
    cos_c = _COS_F if fast else _COS_HC
    s = sin_c[-1]
    for c in sin_c[-2::-1]:
        s = s * z2 + c
    s = s * z
    c_ = cos_c[-1]
    for c in cos_c[-2::-1]:
        c_ = c_ * z2 + c
    if with_scale:
        l2 = neg2log(1.0 - u, fast=fast)
        scale = sqrt_f32(l2 / torch.clamp_min(q, _SCALE_FLOOR))
        return R * c_, R * s, scale
    return R * c_, R * s


def normal_pair_hc(w_r: torch.Tensor, w_p: torch.Tensor):
    """Two u32 words -> two iid N(0,1) float32 values: radius from w_r's
    top 23 bits, phase on a half-circle from w_p's low 23 bits, sign
    from w_p's bit 31 (``nmch_tpu.rng.normal.normal_pair_hc``)."""
    f = f32_from_u32((w_p & _MANT) | _ONE)
    return _halfcircle_pair(w_r, f, w_p & _SIGN)


def normal4_from_bits3(w_r0, w_r1, w_ph, fast: bool = False,
                       with_scale: bool = False):
    """Three u32 words -> four N(0,1) float32 values (boxes hc16/hc16f):
    two half-circle pairs whose 15-bit phases and signs share one word,
    pair 0 in w_ph bits 0-14 (phase) and 15 (sign), pair 1 in bits 16-30
    and 31.  with_scale=True also returns each pair's radius-antithetic
    scale: (g0, g1, g2, g3, scale0, scale1)."""
    f0 = f32_from_u32(((w_ph & 0x7FFF) << 8) | _ONE)
    s0 = (w_ph << 16) & _SIGN
    f1 = f32_from_u32(((w_ph >> 8) & 0x007FFF00) | _ONE)
    s1 = w_ph & _SIGN
    p0 = _halfcircle_pair(w_r0, f0, s0, fast=fast, with_scale=with_scale)
    p1 = _halfcircle_pair(w_r1, f1, s1, fast=fast, with_scale=with_scale)
    if with_scale:
        return p0[0], p0[1], p1[0], p1[1], p0[2], p1[2]
    return (*p0, *p1)


# Fast inverse normal CDF of the QMC engine: with s = sqrt(-2 ln pm),
# pm = min(u, 1 - u), |z| = g(s) by two degree-7 polynomials split at
# s = 2.6 (nmch_tpu/rng/normal.py's tables; max |z| error 2.3e-6)
_NDTRI_LO = tuple(float(np.float32(x)) for x in   # s in [sqrt(2 ln 2), 2.6]
                  (-2.5742833614349365, 3.7063958644866943,
                   -2.4668259620666504, 1.5879123210906982,
                   -0.6822224855422974, 0.18576109409332275,
                   -0.028967037796974182, 0.0019696212839335203))
_NDTRI_HI = tuple(float(np.float32(x)) for x in   # s in [2.6, 6.5]
                  (-1.9839493036270142, 2.074390172958374,
                   -0.4344251751899719, 0.11815280467271805,
                   -0.02104499191045761, 0.002353857271373272,
                   -0.00014995710807852447, 4.1502166823192965e-06))
_NDTRI_SPLIT = float(np.float32(2.6))
_NDTRI_PM_MIN = 2.0 ** -30      # the HI polynomial is fit for s <= 6.5


def ndtri_fast_pm(pm: torch.Tensor) -> torch.Tensor:
    """|z| = g(pm) for float32 pm = min(u, 1 - u) in (0, 1/2]: the
    magnitude half of ``ndtri_fast``.  pm below 2^-30 is clamped (the
    single most extreme Sobol' point, pm = 2^-31, saturates at |z| ~
    6.45 instead of ~6.55, as in ``nmch_tpu``)."""
    s = sqrt_f32(neg2log(torch.clamp_min(pm, _NDTRI_PM_MIN)))
    lo = _NDTRI_LO[-1]
    for c in _NDTRI_LO[-2::-1]:
        lo = lo * s + c
    hi = _NDTRI_HI[-1]
    for c in _NDTRI_HI[-2::-1]:
        hi = hi * s + c
    return torch.where(s < _NDTRI_SPLIT, lo, hi)


def ndtri_fast(u: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF of float32 u in [2^-26, 1 - 2^-26], max abs
    error 2.3e-6 on z."""
    u = u.to(torch.float32)
    g = ndtri_fast_pm(torch.minimum(u, 1.0 - u))
    return torch.where(u > 0.5, g, -g)


def normal4_from_bits(x0, x1, x2, x3, box: str = "hc"):
    """Four u32 words -> four N(0,1) float32 values via two Box–Muller
    pairs: one counter block feeds two time steps.  box="hc": the
    half-circle construction; box="turns": ``boxmuller`` on two (0, 1]
    uniforms per pair."""
    if box == "hc":
        g0, g1 = normal_pair_hc(x0, x1)
        g2, g3 = normal_pair_hc(x2, x3)
    elif box == "turns":
        g0, g1 = boxmuller(uniform_open01(x0), uniform_open01(x1))
        g2, g3 = boxmuller(uniform_open01(x2), uniform_open01(x3))
    else:
        raise ValueError(f"unknown box {box!r} (expected 'hc' or 'turns')")
    return g0, g1, g2, g3
