"""MRG32k3a (L'Ecuyer 1999) with skip-ahead, on int64 tensors that hold
uint32 words.

The counterpart of ``nmch_tpu/rng/mrg32k3a.py`` (the reference's third
curand family, ``src/NMCH/random/random.cu:12-13``), bitwise the same
streams:

    m1 = 2^32 - 209,  m2 = 2^32 - 22853
    x1_n = (1403580 x1_{n-2} -  810728 x1_{n-3}) mod m1
    x2_n = ( 527612 x2_{n-1} - 1370589 x2_{n-3}) mod m2
    z_n  = (x1_n - x2_n) mod m1          (z in [0, m1))

    state(seed, path, epoch) = A^(path * 2^67 + epoch * 2^40) s(seed)

with A the 3x3 companion matrix of each recurrence.  The host matrix
algebra, the jump tables A^(2^b), b in [40, 98), and the splitmix64 seed
states are the JAX package's.  Modular products are exact integers, so
any exact method gives the JAX package's words: here b is split into
16-bit halves, so that every partial product stays below 2^53 in int64
(``modmul``), where the JAX code builds the product from 16-bit partials
in u32 and the CUDA kernel takes a native 64-bit product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import splitmix64, u23_to_f32

M1 = 4294967087          # 2^32 - 209
M2 = 4294944443          # 2^32 - 22853
A12 = 1403580
A13N = 810728            # x1 coefficient is -A13N
A21 = 527612
A23N = 1370589           # x2 coefficient is -A23N

# companion matrices acting on (x_{n-3}, x_{n-2}, x_{n-1})
_A1 = ((0, 1, 0),
       (0, 0, 1),
       (M1 - A13N, A12, 0))
_A2 = ((0, 1, 0),
       (0, 0, 1),
       (M2 - A23N, 0, A21))

PATH_LOG2 = 67           # curand's MRG32k3a subsequence spacing
EPOCH_LOG2 = 40          # the epoch spacing within a path block
MAX_EPOCH = 1 << (PATH_LOG2 - EPOCH_LOG2)


# ---------------------------------------------------------------------------
# host-side exact matrix algebra (python ints)

def _mat_mul(A, B, m):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3)) % m
                       for j in range(3)) for i in range(3))


def _mat_pow(A, n, m):
    R = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    while n:
        if n & 1:
            R = _mat_mul(R, A, m)
        A = _mat_mul(A, A, m)
        n >>= 1
    return R


@functools.lru_cache(maxsize=None)
def _jump_tables():
    """A^(2^b) for b in [EPOCH_LOG2, PATH_LOG2 + 31), both recurrences,
    as np.uint32[(58, 3, 3)] each.  Bits [40, 67) select the epoch jump,
    bits [67, 98) the path jump (paths < 2^31)."""
    bits = range(EPOCH_LOG2, PATH_LOG2 + 31)
    out = []
    for A, m in ((_A1, M1), (_A2, M2)):
        mats, P = [], _mat_pow(A, 1 << EPOCH_LOG2, m)
        for _ in bits:
            mats.append(P)
            P = _mat_mul(P, P, m)
        out.append(np.array(mats, dtype=np.uint32))
    return out[0], out[1]


def seed_state(seed: int):
    """Host: integer seed -> ((s1 triple), (s2 triple)), each word in
    [1, m-1] (never the forbidden all-zero state)."""
    x, words = int(seed) & (2**64 - 1), []
    for m in (M1, M1, M1, M2, M2, M2):
        x, w = splitmix64(x)
        words.append(int(w % (m - 1)) + 1)
    return tuple(words[:3]), tuple(words[3:])


# ---------------------------------------------------------------------------
# exact modular arithmetic on int64 tensors (operands in [0, m))

def modmul(a, b, m: int):
    """a * b mod m for u32 a, b < m: a * b_hi and a * b_lo, b's 16-bit
    halves, are below 2^48, and (a b_hi mod m) * 2^16 below 2^48."""
    hi = (a * (b >> 16)) % m
    return (hi * 65536 + a * (b & 0xFFFF)) % m


def matvec(M: torch.Tensor, s: torch.Tensor, m: int) -> torch.Tensor:
    """(3, 3) int64 matrix times (3, n) words, mod m."""
    prod = modmul(M.unsqueeze(-1), s.unsqueeze(0), m)     # (3, 3, n)
    return prod.sum(dim=1) % m


@functools.lru_cache(maxsize=4)
def _jump_tensors(device: str):
    J1, J2 = _jump_tables()
    return (torch.from_numpy(J1.astype(np.int64)).to(device),
            torch.from_numpy(J2.astype(np.int64)).to(device))


def mrg_state_at(seed: int, path_idx: torch.Tensor, epoch: int):
    """State of stream (seed, path, epoch): ((s1 x3), (s2 x3)) int64
    tensors shaped like path_idx.  Bits 0..26 of the python int epoch and
    bits 0..30 of the u32 path ids select the jumps, epoch bits first."""
    b1, b2 = seed_state(seed)
    epoch = int(epoch)
    dev = path_idx.device
    p = path_idx.reshape(-1)
    J1, J2 = _jump_tensors(str(dev))
    s1 = torch.tensor(b1, dtype=torch.int64, device=dev).view(3, 1)
    s2 = torch.tensor(b2, dtype=torch.int64, device=dev).view(3, 1)
    neb = PATH_LOG2 - EPOCH_LOG2
    for i in range(neb):                 # the same for every lane
        if (epoch >> i) & 1:
            s1, s2 = matvec(J1[i], s1, M1), matvec(J2[i], s2, M2)
    s1, s2 = s1.expand(3, p.numel()), s2.expand(3, p.numel())
    for i in range(neb, J1.shape[0]):
        on = ((p >> (i - neb)) & 1).bool()
        if bool(on.any()):
            s1 = torch.where(on, matvec(J1[i], s1, M1), s1)
            s2 = torch.where(on, matvec(J2[i], s2, M2), s2)
    shape = path_idx.shape
    return (tuple(w.reshape(shape) for w in s1.unbind(0)),
            tuple(w.reshape(shape) for w in s2.unbind(0)))


def mrg_step(s1, s2):
    """One recurrence step: (z, s1', s2'), z u32 in [0, m1).  The
    multipliers are below 2^21, so each product is exact in int64."""
    x1 = ((A12 * s1[1]) % M1 - (A13N * s1[0]) % M1) % M1
    x2 = ((A21 * s2[2]) % M2 - (A23N * s2[0]) % M2) % M2
    return (x1 - x2) % M1, (s1[1], s1[2], x1), (s2[1], s2[2], x2)


_INV_M1 = float(np.float32(1.0 / M1))
_F16 = 65536.0


def u32_to_f32(z: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest u32 -> float32 as the JAX package builds it: two
    exact 16-bit halves, an exact * 2^16 and one rounding add."""
    return u23_to_f32(z >> 16) * _F16 + u23_to_f32(z & 0xFFFF)


def u01_from_z(z: torch.Tensor) -> torch.Tensor:
    """z in [0, m1) -> float32 uniform in (0, 1): (z + 0.5) / m1."""
    return (u32_to_f32(z) + 0.5) * _INV_M1
