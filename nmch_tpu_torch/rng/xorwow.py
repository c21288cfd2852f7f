"""XORWOW (Marsaglia 2003) with skip-ahead over GF(2)^160, on int64 tensors
that hold uint32 words.

The counterpart of ``nmch_tpu/rng/xorwow.py`` (the reference's default
curand family, ``src/NMCH/random/random.cu:6-16``), bitwise the same
streams:

    recurrence (one step, u32 words):
        t = x ^ (x >> 2)
        x, y, z, w = y, z, w, v
        v = (v ^ (v << 4)) ^ (t ^ (t << 1))
        d = d + 362437                      (Weyl counter, mod 2^32)
        output = v + d

    state(seed, path, epoch) = F^(path * 2^67 + epoch * 2^40) s(seed)

F is the 160x160 bit matrix of one step of the linear (x, y, z, w, v)
half; every jump exponent is a multiple of 2^32, so the Weyl word stays
d(seed).  The host algebra (python ints as 160-bit vectors) and the jump
tables F^(2^b), b in [40, 98), are the JAX package's, verbatim; the seed
state comes from splitmix64 with the all-zero xorshift state excluded.

On tensors, a jump is a product over GF(2): the state's 160 bits times
the jump's bit matrix, as a float32 matrix product (exact: the sums are
at most 160) taken mod 2.  ``xorwow_state_at`` applies the jumps selected
by the bits of the exponent, epoch bits first, then path bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import splitmix64, u23_to_f32
from .philox import MASK32

WEYL = 362437              # Weyl increment (Marsaglia 2003, xorwow)
PATH_LOG2 = 67             # curand's XORWOW subsequence spacing
EPOCH_LOG2 = 40            # the epoch spacing within a path block
MAX_EPOCH = 1 << (PATH_LOG2 - EPOCH_LOG2)
N_WORDS = 5                # xorshift state words (x, y, z, w, v)
N_BITS = 32 * N_WORDS      # GF(2) dimension


# ---------------------------------------------------------------------------
# host-side exact GF(2) algebra (python ints as 160-bit vectors)

def _step_words(x, y, z, w, v):
    """One exact xorshift step on python-int words (no Weyl)."""
    M = 0xFFFFFFFF
    t = (x ^ (x >> 2)) & M
    v_new = ((v ^ ((v << 4) & M)) ^ (t ^ ((t << 1) & M))) & M
    return y, z, w, v, v_new


def _pack(words):
    """5 u32 words -> one 160-bit int; bit b of word w at 32*w + b."""
    acc = 0
    for i, wd in enumerate(words):
        acc |= int(wd) << (32 * i)
    return acc


def _unpack(bits):
    return tuple((bits >> (32 * i)) & 0xFFFFFFFF for i in range(N_WORDS))


@functools.lru_cache(maxsize=1)
def _step_matrix():
    """F as a tuple of 160 columns (each a 160-bit int): column j is
    the image of unit vector e_j under one recurrence step."""
    cols = []
    for j in range(N_BITS):
        cols.append(_pack(_step_words(*_unpack(1 << j))))
    return tuple(cols)


def _mat_vec(cols, s):
    """M s over GF(2): XOR the columns selected by the bits of s."""
    acc = 0
    while s:
        j = (s & -s).bit_length() - 1
        acc ^= cols[j]
        s &= s - 1
    return acc


def _mat_mul(A, B):
    """(A B) column j = A (B column j)."""
    return tuple(_mat_vec(A, bj) for bj in B)


def _mat_sq(A):
    return _mat_mul(A, A)


def _mat_pow(n: int):
    """F^n as a column tuple (exact, host-side)."""
    R = tuple(1 << j for j in range(N_BITS))     # identity
    A = _step_matrix()
    while n:
        if n & 1:
            R = _mat_mul(A, R)
        A = _mat_sq(A)
        n >>= 1
    return R


def _columns_to_table(P) -> np.ndarray:
    """A column tuple as u32 (N_WORDS, 32, N_WORDS): [input word, input
    bit, output words], the 5-word column XORed in when that input bit
    is set."""
    out = np.empty((N_WORDS, 32, N_WORDS), dtype=np.uint32)
    for wi in range(N_WORDS):
        for b in range(32):
            col = P[32 * wi + b]
            for wo in range(N_WORDS):
                out[wi, b, wo] = (col >> (32 * wo)) & 0xFFFFFFFF
    return out


@functools.lru_cache(maxsize=None)
def _jump_tables() -> np.ndarray:
    """F^(2^b) for b in [EPOCH_LOG2, PATH_LOG2 + 31), as a u32 array of
    shape (58, N_WORDS, 32, N_WORDS): [matrix, input word, input bit,
    output words].  Bits [40, 67) of the jump exponent select the epoch
    jump, bits [67, 98) the path jump (paths < 2^31).  Built once by
    repeated squaring of the exact step matrix (a couple of seconds)."""
    P = _step_matrix()
    for _ in range(EPOCH_LOG2):
        P = _mat_sq(P)
    n_mats = PATH_LOG2 + 31 - EPOCH_LOG2
    out = np.empty((n_mats, N_WORDS, 32, N_WORDS), dtype=np.uint32)
    for m in range(n_mats):
        out[m] = _columns_to_table(P)
        P = _mat_sq(P)
    return out


def seed_state(seed: int):
    """Host: integer seed -> ((x, y, z, w, v), d0) python-int words."""
    x, words = int(seed) & (2**64 - 1), []
    for _ in range(N_WORDS + 1):
        x, w = splitmix64(x)
        words.append(int(w & 0xFFFFFFFF))
    st = words[:N_WORDS]
    if not any(st):
        st[0] = 1
    return tuple(st), words[N_WORDS]


# ---------------------------------------------------------------------------
# jumps on tensors: GF(2) matrix products

def table_bit_matrix(tab: np.ndarray) -> np.ndarray:
    """float32 (..., 160, 160) [out bit, in bit] of u32 tables shaped
    (..., N_WORDS, 32, N_WORDS) as ``_jump_tables`` lays them out."""
    tab = np.asarray(tab, dtype=np.uint32)
    bits = (tab[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    m = bits.reshape(*tab.shape[:-3], N_BITS, N_BITS)     # [in, out]
    return np.swapaxes(m, -1, -2).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _jump_bit_matrices(device: str) -> torch.Tensor:
    """``_jump_tables()`` as float32 (58, 160, 160) bit matrices."""
    return torch.from_numpy(table_bit_matrix(_jump_tables())).to(device)


_SHIFTS = torch.arange(32, dtype=torch.int64).view(1, 32, 1)


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """(5, n) u32 words (int64) -> float32 (160, n) bits, bit b of word w
    at row 32 w + b."""
    sh = _SHIFTS.to(words.device)
    return ((words.unsqueeze(1) >> sh) & 1).reshape(N_BITS, -1).float()


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of ``words_to_bits``."""
    sh = _SHIFTS.to(bits.device)
    b = bits.to(torch.int64).reshape(N_WORDS, 32, -1)
    return (b << sh).sum(dim=1)


def gf2_apply(mat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """mat @ bits over GF(2), both float32 0/1."""
    return torch.remainder(mat @ bits, 2.0)


def xorwow_state_at(seed: int, path_idx: torch.Tensor, epoch: int):
    """State of stream (seed, path, epoch): ((x, y, z, w, v), d), int64
    tensors shaped like path_idx.

    path_idx: int64 tensor of u32 path ids (bits 0..30 select the path
    jumps); epoch: a python int whose bits 0..26 select the epoch jumps.
    The Weyl word is jump-invariant, so d = d0 everywhere."""
    base, d0 = seed_state(seed)
    epoch = int(epoch)
    dev = path_idx.device
    p = path_idx.reshape(-1)
    n = p.numel()
    mats = _jump_bit_matrices(str(dev))
    bits = words_to_bits(torch.tensor(base, dtype=torch.int64,
                                      device=dev).view(N_WORDS, 1))
    neb = PATH_LOG2 - EPOCH_LOG2
    for i in range(neb):                 # the same for every lane
        if (epoch >> i) & 1:
            bits = gf2_apply(mats[i], bits)
    bits = bits.expand(N_BITS, n)
    for i in range(neb, mats.shape[0]):
        on = ((p >> (i - neb)) & 1).bool()
        if bool(on.any()):
            bits = torch.where(on, gf2_apply(mats[i], bits), bits)
    words = bits_to_words(bits).reshape(N_WORDS, *path_idx.shape)
    return tuple(words.unbind(0)), torch.full_like(path_idx, d0)


def xorwow_step(s, d):
    """One recurrence step: (out, s', d'), out u32 = v + d."""
    x, y, z, w, v = s
    t = x ^ (x >> 2)
    v_new = (v ^ ((v << 4) & MASK32)) ^ (t ^ ((t << 1) & MASK32))
    d = (d + WEYL) & MASK32
    return (v_new + d) & MASK32, (y, z, w, v, v_new), d


_TWO_NEG23 = 2.0 ** -23


def u01_from_out(o: torch.Tensor) -> torch.Tensor:
    """u32 output -> float32 uniform strictly inside (0, 1):
    ((o >> 9) + 0.5) * 2^-23.  Not ``rng/normal.py::uniform_open01``
    (2 - f, in (0, 1]): the stateful FE draws use this one."""
    return (u23_to_f32(o >> 9) + 0.5) * _TWO_NEG23
