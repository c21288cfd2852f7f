"""Philox4x32-10 streams and normals from their words, in plain PyTorch.

A path's stream is the Philox4x32-10 block at counter (block, epoch,
path, 0) under the key (seed & 0xFFFFFFFF, seed >> 32) (Salmon et al.,
SC'11: multipliers 0xD2511F53 / 0xCD9E8D57, Weyl key increments
0x9E3779B9 / 0xBB67AE85).  u32 words are carried in int64 tensors and
masked after every operation that can carry.  The normals are the
float32 constructions of the port's plain version, operation for
operation: the half-circle Box-Muller (``normal_pair_hc``, the FE
kernels' box) and the turns Box-Muller (``boxmuller``, the EM samplers').
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def key_words(seed: int) -> tuple[int, int]:
    """A 64-bit seed's (lo, hi) u32 key."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def _mulhilo32(a: int, b):
    """(hi, lo) of the 64-bit product of the u32 constant ``a`` and the
    u32 words ``b``, exact in int64 through b's 16-bit halves."""
    p_lo = a * (b & _MASK16)
    p_hi = a * (b >> 16)
    lo = (p_lo + ((p_hi & _MASK16) << 16)) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """One Philox4x32-10 block: four u32 counter words (tensors or ints
    that broadcast) and the key -> four u32 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo32(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


class BlockWindow:
    """Each lane's stream read through a window of ``width`` blocks.

    Lanes are laid out (P, L): ``epoch`` (P, 1) and ``path`` (1, L) int64.
    ``words(ctr, rounds)`` gives the four words of blocks ctr + r, r <
    rounds, as (rounds, P, L) tensors, for the lanes' own counters ``ctr``
    (P, L).  The window holds blocks [base, base + width) of every lane
    and is made again, from each lane's current counter, when a lane
    would read past it: one bulk Philox pass in place of one pass a
    round."""

    def __init__(self, epoch, path, key: tuple[int, int], width: int = 48):
        self.epoch, self.path = epoch, path
        self.k0, self.k1 = key
        self.width = width
        self.base = None
        self.table = None

    def words(self, ctr, rounds: int):
        if rounds > self.width:
            raise ValueError(f"{rounds} rounds exceed the window's "
                             f"{self.width} blocks")
        if self.base is None or int((ctr - self.base).max()) + rounds \
                > self.width:
            self.base = ctr.clone()
            j = torch.arange(self.width, dtype=torch.int64,
                             device=ctr.device).reshape(-1, 1, 1)
            self.table = philox4x32((self.base + j) & MASK32, self.epoch,
                                    self.path, 0, self.k0, self.k1)
        r = torch.arange(rounds, dtype=torch.int64,
                         device=ctr.device).reshape(-1, 1, 1)
        idx = (ctr - self.base) + r
        return tuple(torch.gather(t, 0, idx) for t in self.table)


# --- normals (the port's rng/normal.py constants and operation order) ---

def _f32s(*xs):
    return tuple(float(np.float32(x)) for x in xs)


_SIN_HC = _f32s(0.99999662, -0.16664828, 8.3063252e-3, -1.8363653e-4)
_COS_HC = _f32s(0.99999995, -0.49999905, 4.1663585e-2, -1.38537043e-3,
                2.31539307e-5)
_NEG2LOG = tuple(float(np.float32(-2.0 * c)) for c in
                 (0.99999981, -0.49997405, 0.33275475, -0.24495434,
                  0.17745159, -0.1076805, 0.04408875, -0.00853896))
_NEG2LN2 = float(np.float32(-2.0 * np.log(2.0)))
_C254LN2 = float(np.float32(-127.0 * _NEG2LN2))
_PI = float(np.float32(np.pi))
_PI_1P5 = float(np.float32(1.5 * np.pi))
_MAGIC = 12582912.0                      # 1.5 * 2^23
_SC_COS = _f32s(9.1926027483e-4, -2.0863480763e-2, 2.5366950790e-1,
                -1.2337005501, 1.0)
_SC_SIN = _f32s(-4.6817541353e-3, 7.9692626247e-2, -6.4596409750e-1,
                1.5707963268)
_SIGN, _MANT, _ONE = 0x80000000, 0x007FFFFF, 0x3F800000


def f32_from_u32(x):
    """u32 words held in int64 reinterpreted as float32."""
    signed = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return signed.to(torch.int32).view(torch.float32)


def u32_from_f32(f):
    return f.view(torch.int32).to(torch.int64) & MASK32


def sqrt_f32(x):
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def uniform_open01(bits):
    """u32 -> float32 in (0, 1]: 2 minus a float in [1, 2) of 23 bits."""
    return 2.0 - f32_from_u32((bits >> 9) | _ONE)


def uniform_halfopen01(bits):
    """u32 -> float32 in [0, 1)."""
    return f32_from_u32((bits >> 9) | _ONE) - 1.0


def sincos_2pi(u):
    """(cos 2 pi u, sin 2 pi u) by quadrant reduction and polynomials."""
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


def boxmuller(u1, u2):
    """Two (0, 1] uniforms -> two N(0, 1): sqrt(-2 ln u1) (cos, sin)(2 pi u2)."""
    r = sqrt_f32(-2.0 * torch.log(u1))
    c, s = sincos_2pi(u2)
    return r * c, r * s


def neg2log(u):
    """-2 ln u for float32 u in (0, 1] from u's exponent and a degree-8
    polynomial in its mantissa."""
    b = u32_from_f32(u)
    ebf = f32_from_u32((b >> 23) | 0x4B400000) - _MAGIC
    t = f32_from_u32((b & _MANT) | _ONE) - 1.0
    p = _NEG2LOG[-1]
    for c in _NEG2LOG[-2::-1]:
        p = p * t + c
    q = ebf * _NEG2LN2 + _C254LN2 + t * p
    return torch.clamp_min(q, 0.0)


def normal_pair_hc(w_r, w_p):
    """Two u32 words -> two N(0, 1): the radius from w_r's top 23 bits,
    the phase on a half circle from w_p's low 23 bits, the sign from w_p's
    bit 31."""
    f = f32_from_u32((w_p & _MANT) | _ONE)
    q = neg2log(uniform_open01(w_r))
    R = f32_from_u32(u32_from_f32(sqrt_f32(q)) ^ (w_p & _SIGN))
    z = f * _PI - _PI_1P5
    z2 = z * z
    s = _SIN_HC[-1]
    for c in _SIN_HC[-2::-1]:
        s = s * z2 + c
    s = s * z
    c_ = _COS_HC[-1]
    for c in _COS_HC[-2::-1]:
        c_ = c_ * z2 + c
    return R * c_, R * s
