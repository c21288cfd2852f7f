"""Threefry-2x32 on int64 tensors that hold uint32 words.

Bitwise the generator of ``nmch_tpu/rng/threefry.py`` (Salmon et al.,
SC'11: rotations (13, 15, 26, 6) and (17, 29, 16, 24) alternating per
group of 4 rounds, a key injection after each group, 20 rounds, the
key-schedule parity word 0x1BD11BDA), with the same stream layout:
4 words per (block, epoch, path) from two 2-word calls with distinct
derived keys,

    words 0,1 = threefry2x32(key=(k0 ^ epoch*GOLD, k1), ctr=(block, path))
    words 2,3 = threefry2x32(key=(k0 ^ epoch*GOLD, k1 ^ GOLD2),
                             ctr=(block, path))

As in ``rng/philox.py``, every word is carried in int64 and masked back
to 32 bits after each addition and rotation; the u32 product epoch*GOLD
is the low word of ``mulhilo32`` (a u32 x u32 product overflows
int64).  Arguments may be tensors or Python ints; they broadcast
elementwise.
"""

from __future__ import annotations

import torch

from .philox import MASK32, mulhilo32

ROT_A = (13, 15, 26, 6)
ROT_B = (17, 29, 16, 24)
PARITY = 0x1BD11BDA
GOLD = 0x9E3779B9
GOLD2 = 0xBB67AE85


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def _word(x):
    return x if isinstance(x, torch.Tensor) else int(x) & MASK32


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """One Threefry-2x32 block: 2 u32 keys + 2 u32 counters -> 2 u32
    words, as ``nmch_tpu.rng.threefry.threefry2x32``."""
    k0, k1, x0, x1 = (_word(v) for v in (k0, k1, x0, x1))
    ks = (k1, k0 ^ k1 ^ PARITY, k0)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(rounds // 4):
        for d in (ROT_A, ROT_B)[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + ks[i % 3]) & MASK32
        x1 = (x1 + ks[(i + 1) % 3] + i + 1) & MASK32
    return x0, x1


def draw4_threefry(block_idx, epoch, path_lo, k0, k1):
    """Four u32 words for (path, epoch, block): two 2-word calls with
    the derived keys (k0 ^ epoch*GOLD, k1) and (k0 ^ epoch*GOLD,
    k1 ^ GOLD2)."""
    ka = _word(k0) ^ mulhilo32(_word(epoch), GOLD)[1]
    w0, w1 = threefry2x32(ka, k1, block_idx, path_lo)
    w2, w3 = threefry2x32(ka, _word(k1) ^ GOLD2, block_idx, path_lo)
    return w0, w1, w2, w3
