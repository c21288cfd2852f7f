"""Philox4x32-10 on int64 tensors that hold uint32 words.

Bitwise the generator of ``nmch_tpu/rng/philox.py`` (Salmon et al.,
SC'11: multipliers 0xD2511F53 / 0xCD9E8D57, Weyl key increments
0x9E3779B9 / 0xBB67AE85, 10 rounds), with the same stream layout:

    key     = (seed_lo, seed_hi)                  -- one seed per run
    counter = (block, epoch, path_lo, path_hi)    -- one stream per path

PyTorch's CPU uint32 has no add or shift, so every word is carried in
int64 and masked back to 32 bits after each operation that can carry.
Arguments may be tensors or Python ints; they broadcast elementwise.
"""

from __future__ import annotations

import numpy as np
import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def mulhilo32(a, b):
    """(hi, lo) 32-bit halves of the 64-bit product a*b.

    A u32 x u32 product overflows signed int64, so b is split into
    16-bit halves: a*b_lo and a*b_hi are below 2^48 and recombine
    exactly."""
    p_lo = a * (b & _MASK16)
    p_hi = a * (b >> 16)
    lo = (p_lo + ((p_hi & _MASK16) << 16)) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def _round(c0, c1, c2, c3, k0, k1):
    hi0, lo0 = mulhilo32(PHILOX_M0, c0)
    hi1, lo1 = mulhilo32(PHILOX_M1, c2)
    return (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """One Philox4x32 block: 4 u32 counters + 2 u32 keys -> 4 u32 words.

    Scalars (numpy included) become Python ints first: a numpy uint32
    would wrap inside ``mulhilo32``'s products."""
    c0, c1, c2, c3 = (c if isinstance(c, torch.Tensor) else int(c)
                      for c in (c0, c1, c2, c3))
    k0 = int(k0) & MASK32
    k1 = int(k1) & MASK32
    for _ in range(rounds):
        c0, c1, c2, c3 = _round(c0, c1, c2, c3, k0, k1)
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def split_seed(seed: int):
    """64-bit seed -> (lo, hi) uint32 pair (curand keys the seed the same way)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(seed & MASK32), np.uint32(seed >> 32)


def draw4(block_idx, epoch, path_lo, path_hi, k0, k1):
    """The ``block_idx``-th block of 4 u32 words of each path's stream."""
    return philox4x32(block_idx, epoch, path_lo, path_hi, k0, k1)
