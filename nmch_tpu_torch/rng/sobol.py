"""Sobol' low-discrepancy points with digital-shift, LMS and Owen scrambles.

The point generator of the QMC engine (``ops/fe_qmc.py``), bitwise the
words of ``nmch_tpu/rng/sobol.py``:

    x_{i,j} = XOR_b gray(i)_b * V[j, b],   gray(i) = i ^ (i >> 1)

with the Joe–Kuo direction numbers V of scipy's table (30 bits).  The
randomizations draw their words from the Philox streams keyed by (seed,
epoch) on planes of their own (the high counter word is "SOBL" for the
digital shifts, "LMS\\0" + k for the linear matrix scramble, "OWEN" for
the Owen seeds; path streams keep it 0).

PyTorch's CPU uint32 has no add or shift, so words are u32 carried in
int64 and masked to 32 bits after each operation that can carry, as in
``rng/philox.py``.  Two operations need more than a mask:

* the Owen hash multiplies two u32 words, whose product overflows int64:
  its low word is built from 16-bit halves of the constant
  (``_mul_lo32``);
* torch has no population count: the parity of the LMS masks is a fold
  of shifts and XORs (``_parity``).

Tensors of words may live on any device; the functions return words on
the device of their tensor inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .philox import MASK32, philox4x32

BITS = 30
MASK = (1 << BITS) - 1
_INV = float(np.float32(2.0 ** -BITS))
_INV23 = float(np.float32(2.0 ** -23))

_SOBL = 0x534F424C        # "SOBL": the digital-shift plane
_LMS = 0x4C4D5300         # "LMS\0" + k: row k of the linear scramble
_OWEN = 0x4F57454E        # "OWEN": the Owen seeds


def direction_numbers(d: int) -> np.ndarray:
    """(d, 30) uint32 Joe–Kuo direction numbers from scipy's table."""
    from scipy.stats import qmc
    s = qmc.Sobol(d=d, scramble=False)
    sv = getattr(s, "_sv", None)
    if sv is None:  # scipy internals moved: fail loudly, not wrongly
        raise RuntimeError("scipy.stats.qmc.Sobol no longer exposes _sv; "
                           "update nmch_tpu_torch.rng.sobol.direction_numbers")
    return np.ascontiguousarray(sv[:, :BITS], dtype=np.uint32)


def as_words(v, device=None) -> torch.Tensor:
    """u32 words (a numpy array or a tensor) as an int64 tensor."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v.astype(np.int64))
    return v.to(device=device, dtype=torch.int64)


def gray_codes(n: int, base: int = 0, device="cpu") -> torch.Tensor:
    """Gray codes of the point indices base..base+n-1 (u32 in int64)."""
    i = (torch.arange(n, dtype=torch.int64, device=device) + int(base)) \
        & MASK32
    return i ^ (i >> 1)


def _xor_columns(codes: torch.Tensor, v: torch.Tensor, bits) -> torch.Tensor:
    """(L, n): XOR over b in ``bits`` of bit b of ``codes`` (n,) times
    column b of ``v`` (L, 30)."""
    x = torch.zeros(v.shape[0], codes.shape[0], dtype=torch.int64,
                    device=codes.device)
    for b in bits:
        bit = (codes >> b) & 1
        x = x ^ (bit[None, :] * v[:, b][:, None])
    return x


def sobol_dims_u32(gray: torch.Tensor, v_block) -> torch.Tensor:
    """Raw Sobol' words (L, n) of L dimensions (direction numbers
    ``v_block``, (L, 30)) at the points of the Gray codes ``gray`` (n,)."""
    return _xor_columns(gray, as_words(v_block, gray.device), range(BITS))


def sobol_dims_u32_hilo(n: int, v_block, lo_bits: int | None = None,
                        base: int = 0) -> torch.Tensor:
    """Raw Sobol' words (L, n) of points base..base+n-1 by hi/lo index
    factoring, bitwise ``sobol_dims_u32(gray_codes(n, base), v_block)``.

    Sobol' generation is linear over GF(2) in the Gray code: with i = h *
    2^b + l, gray(i) splits into glo(l) = l ^ (l >> 1) (bit b of l taken
    as 0) and code_hi(h) = gray(h) << b | (h & 1) << (b - 1), so the words
    of the 2^b low codes and of the n / 2^b high codes combine with one
    broadcast XOR.  ``v_block`` is a (L, 30) tensor (its device is the
    result's) or numpy array; n must be a multiple of 2^lo_bits (default
    min(13, the trailing zero bits of n)) and so must ``base``."""
    v = as_words(v_block)
    if lo_bits is None:
        lo_bits = min(13, max((n & -n).bit_length() - 1, 0))
    b = lo_bits
    nlo = 1 << b
    if b == 0 or n % nlo:
        # degenerate or unaligned: the direct ladder
        return sobol_dims_u32(gray_codes(n, base, v.device), v)
    nhi = n >> b
    lo = torch.arange(nlo, dtype=torch.int64, device=v.device)
    xlo = _xor_columns(lo ^ (lo >> 1), v, range(b))
    hi = (int(base) // nlo
          + torch.arange(nhi, dtype=torch.int64, device=v.device)) & MASK32
    code_hi = (((hi ^ (hi >> 1)) << b) | ((hi & 1) << (b - 1))) & MASK32
    xhi = _xor_columns(code_hi, v, range(b - 1, BITS))
    return (xhi[:, :, None] ^ xlo[:, None, :]).reshape(v.shape[0], n)


def digital_shifts(dim_idx, epoch, k0, k1) -> torch.Tensor:
    """30-bit digital shifts of the dimensions ``dim_idx`` from the (seed,
    epoch) Philox streams (dimension index as the counter word); the
    arguments broadcast."""
    w0, _, _, _ = philox4x32(dim_idx, epoch, 0, _SOBL, k0, k1)
    return w0 & MASK


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of each 32-bit word: the population count's low bit."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def lms_scramble_directions(v, epoch, k0, k1) -> torch.Tensor:
    """Linear matrix scramble (Matousek's LMS) of the direction numbers,
    keyed by (seed, epoch): bit k of v'[j] is parity(mask_{j,k} & v[j]),
    mask_{j,k} = (random bits above k) | bit k, so output digit k mixes
    only coarser-or-equal digits (bit 29 is the most significant) and
    the scrambled net keeps its equidistribution.

    v: (d, 30) words (tensor or numpy); returns the same shape, on v's
    device.  All 30 bit rows are drawn and applied at once."""
    v = as_words(v)
    dims = torch.arange(v.shape[0], dtype=torch.int64,
                        device=v.device)[:, None]
    k = torch.arange(BITS, dtype=torch.int64, device=v.device)[None, :]
    bit = torch.ones_like(k) << k
    # one random word per (dim, bit row k), on plane "LMS\0" + k
    w0, _, _, _ = philox4x32(dims, epoch, 0, _LMS + k, k0, k1)  # (d, 30)
    mask = (w0 & (MASK & ~((bit << 1) - 1))) | bit
    rows = _parity(mask[:, :, None] & v[:, None, :])   # (d, row k, column)
    return (rows << k[:, :, None]).sum(dim=1)        # distinct bits: an OR


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of u32 words (the 5-pass masked-swap ladder)."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def owen_seeds(dim_idx, rep, k0, k1) -> torch.Tensor:
    """Per-(dimension, replicate) Owen scramble seeds from the (seed,
    epoch = replicate) Philox streams on plane "OWEN"; broadcasts."""
    w0, _, _, _ = philox4x32(dim_idx, rep, 0, _OWEN, k0, k1)
    return w0


def _mul_lo32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 of u32 words v and a u32 constant c: c in 16-bit
    halves keeps both partial products below 2^48."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def owen_scramble(x: torch.Tensor, seed) -> torch.Tensor:
    """Hash-based nested-uniform (Owen) scramble of 30-bit Sobol' words;
    ``seed`` broadcasts against ``x``.

    The Laine–Karras hash with Burley's constants (JCGT 9(4), 2020) in
    the reversed-bit domain: adds and even-constant multiply-xors carry
    only toward higher bits, which after the reversals are the finer
    digits, so output digit i depends only on the coarser-or-equal input
    digits and the seed.  The words are lifted to 32 bits (<< 2) for the
    hash and the final >> 2 returns an exact 30-bit word."""
    v = _reverse_bits32((x << 2) & MASK32)
    v = (v + seed) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ _mul_lo32(v, c)
    return _reverse_bits32(v) >> 2


def u01_from_words(x: torch.Tensor) -> torch.Tensor:
    """Sobol' words (< 2^30) -> float32 uniforms in [2^-24, 1 - 2^-24]:
    the top 23 bits, centred ((t + 0.5) 2^-23)."""
    t = (x >> (BITS - 23)).to(torch.float32)
    return (t + 0.5) * _INV23


def pm_sign_from_words(x: torch.Tensor):
    """(pm, neg) of Sobol' words (< 2^30): pm = min(u, 1 - u) from all 30
    bits on the integer side, as float32 ((xm + 0.5) 2^-30), and neg =
    (u < 1/2), the half where the normal is negative."""
    xm = torch.minimum(x, MASK - x)
    pm = (xm.to(torch.float32) + 0.5) * _INV
    return pm, x < (1 << (BITS - 1))
