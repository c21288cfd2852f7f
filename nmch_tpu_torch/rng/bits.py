"""Bit-level helpers shared by the stateful RNG families.

The counterpart of ``nmch_tpu/rng/bits.py``: ``splitmix64`` derives the
seed states of ``rng/xorwow.py`` and ``rng/mrg32k3a.py`` on the host, and
``u23_to_f32`` turns a word below 2^23 into float32 through the exponent
bias (``x | 0x4B000000`` is the bit pattern of ``2^23 + x``), exactly as
the JAX package does.
"""

from __future__ import annotations

import torch

from .normal import f32_from_u32

_F23 = 8388608.0      # 2^23


def splitmix64(x: int):
    """One splitmix64 step on host Python ints: (new_x, output word)."""
    x = (x + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return x, z ^ (z >> 31)


def u23_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact float32 of u32 words below 2^23 (held in int64)."""
    return f32_from_u32(x | 0x4B000000) - _F23
