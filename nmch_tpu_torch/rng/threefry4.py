"""Threefry-4x32 on int64 tensors that hold uint32 words.

Bitwise the generator of ``nmch_tpu/rng/threefry4.py`` (Salmon, Moraes,
Dror & Shaw, SC'11: the Threefish-256 mix/permute structure with the
4x32 rotation table and the 0x1BD11BDA key-schedule parity word), with
the same stream layout:

    counter = (block, epoch, path_lo, path_hi), key = (k0, k1, 0, 0)

``rounds=12`` is the default (the paper's Crush-resistance threshold);
20 is Random123's full-margin setting.  As in ``rng/philox.py``, every
word is carried in int64 and masked back to 32 bits after each addition
and rotation.  Arguments may be tensors or Python ints; they broadcast
elementwise.
"""

from __future__ import annotations

import torch

from .philox import MASK32

PARITY = 0x1BD11BDA
# rotation distances, Random123 threefry.h (R_32x4): one (r0, r1) pair
# per round, cycling with period 8
ROTS = ((10, 26), (11, 21), (13, 27), (23, 5),
        (6, 20), (17, 11), (25, 10), (18, 20))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def _word(x):
    return x if isinstance(x, torch.Tensor) else int(x) & MASK32


def threefry4x32(k0, k1, k2, k3, x0, x1, x2, x3, rounds: int = 12):
    """One Threefry-4x32 block: 4 u32 keys + 4 u32 counters -> 4 u32
    words, as ``nmch_tpu.rng.threefry4.threefry4x32``."""
    if rounds % 4 or not 4 <= rounds <= 72:
        raise ValueError(f"rounds must be a multiple of 4 in [4,72], "
                         f"got {rounds}")
    ks = [_word(k) for k in (k0, k1, k2, k3)]
    ks.append(ks[0] ^ ks[1] ^ ks[2] ^ ks[3] ^ PARITY)
    x = [(_word(v) + ks[i]) & MASK32 for i, v in enumerate((x0, x1, x2, x3))]
    for r in range(rounds):
        r0, r1 = ROTS[r % 8]
        x[0] = (x[0] + x[1]) & MASK32
        x[1] = _rotl(x[1], r0) ^ x[0]
        x[2] = (x[2] + x[3]) & MASK32
        x[3] = _rotl(x[3], r1) ^ x[2]
        # Threefish-256 word permutation (0,3,2,1): swap x1 <-> x3
        x[1], x[3] = x[3], x[1]
        if r % 4 == 3:
            s = r // 4 + 1
            for i in range(4):
                x[i] = (x[i] + ks[(s + i) % 5]) & MASK32
            x[3] = (x[3] + s) & MASK32
    return x[0], x[1], x[2], x[3]


def draw4_threefry4(block_idx, epoch, path_lo, k0, k1, path_hi=0,
                    rounds: int = 12):
    """Four u32 words for (path, epoch, block): key (k0, k1, 0, 0),
    counter (block, epoch, path_lo, path_hi)."""
    return threefry4x32(k0, k1, 0, 0, block_idx, epoch, path_lo, path_hi,
                        rounds=rounds)
