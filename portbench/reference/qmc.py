"""Randomized quasi-Monte Carlo FE prices, the plain reference of the QMC
engine (``NMCH_FE(engine="qmc")``, scramble "lms-shift"): each call's price
and the half-width of its 95% confidence interval, worked out from the
seed, the call's epoch and the inputs alone.

Written from the construction's definitions, in this order:

1. **Directions.**  Joe and Kuo's (2008) primitive polynomials and initial
   numbers m_1..m_s (the new-joe-kuo-6.21201 table that scipy carries,
   ``scipy/stats/_sobol_direction_numbers.npz``), run through their
   recurrence
   m_k = 2 a_1 m_{k-1} ^ 4 a_2 m_{k-2} ^ ... ^ 2^s m_{k-s} ^ m_{k-s}
   to 30-bit direction numbers V[j, b] = m_{b+1} 2^(29-b); dimension 0
   has every m_k = 1.
2. **Linear matrix scramble** (Matousek 1998), one a call: bit k of the
   scrambled V'[j, b] is the parity of L[j, k] & V[j, b], where row
   L[j, k] is bit k and the random bits above it of the word w0 of Philox
   at counter (j, epoch, 0, "LMS\\0" + k): a GF(2) product by a random
   lower-triangular matrix, coarse digits to fine.
3. **Words**, in their direct form: point i of dimension j is the XOR of
   V'[j, b] over the bits b of i's Gray code, i ^ (i >> 1).  A replicate
   takes points 0..n-1, n = n_paths / R.
4. **Digital shift** of replicate r (R replicates a call): each word of
   dimension j XORed with the low 30 bits of w0 of Philox at counter (j,
   epoch R + r, 0, "SOBL").
5. **Normals** by the symmetric map: xm = min(x, 2^30 - 1 - x), pm =
   (xm + 1/2) 2^-30 in float32, taken no lower than 2^-30 (the one most
   extreme point saturates); z = -ndtri(pm) where x >= 2^29, ndtri(pm)
   below.  ndtri is ``torch.special.ndtri`` in float64, rounded to
   ``dtype``: a noted departure, since the program's float32 polynomial
   is within 2.3e-6 of it.
6. **Brownian bridge** (Glasserman 2004, sections 3.1 and 5.5), by its
   recursive construction in ``dtype``: node 0 sets W_N = sqrt(N dt) z_0;
   then segments (a, b) are split breadth first, coarse to fine, at m =
   (a + b) // 2: W_m = (b - m)/(b - a) W_a + (m - a)/(b - a) W_b +
   sqrt((m - a)(b - m)/(b - a) dt) z_k, node k in that order.  Factor f
   of node k reads dimension 2k + f.  The increments are W_{t+1} - W_t.
7. **Euler steps** in the kernel's form: the constants at sqrt_dt = 1,
   since each increment carries sqrt(dt); the step is ``fe.py``'s.
8. **Price and CI**: each replicate's mean payoff (float32 payoffs summed
   in float64); the price is their mean and the half-width
   t_{0.975, R-1} s / sqrt(R), s their sample standard deviation.

It works one replicate at a time, so that at the CLI's 2^18 paths x 1000
steps a block holds 2,000 dimensions x 32,768 points.  It imports nothing
of the program and no JAX.
"""

from __future__ import annotations

import collections
import pathlib

import numpy as np
import scipy.stats
import torch

from .fe import PARAM_KEYS, _step
from .rng import MASK32, philox4x32

BITS = 30
MASK30 = (1 << BITS) - 1
SOBL = int.from_bytes(b"SOBL", "big")     # the digital shifts' plane
LMS = int.from_bytes(b"LMS\0", "big")     # + k: row k of the scramble


def joe_kuo_table(d: int) -> tuple[np.ndarray, np.ndarray]:
    """(poly, vinit) of the first ``d`` dimensions from scipy's copy of
    the Joe-Kuo table: the polynomials with their leading and constant
    terms as bits, and the initial numbers m_1..m_s."""
    path = pathlib.Path(scipy.stats.__file__).parent / \
        "_sobol_direction_numbers.npz"
    with np.load(path) as table:
        if d > len(table["poly"]):
            raise ValueError(f"d={d} exceeds the table's "
                             f"{len(table['poly'])} dimensions")
        return table["poly"][:d].copy(), table["vinit"][:d].copy()


def directions(d: int) -> torch.Tensor:
    """(d, 30) int64 direction numbers V[j, b] = m_{b+1} 2^(29-b)."""
    poly, vinit = joe_kuo_table(d)
    V = np.zeros((d, BITS), dtype=np.int64)
    for j in range(d):
        p = int(poly[j])
        s = p.bit_length() - 1
        m = [1] * BITS if s == 0 else [int(x) for x in vinit[j, :s]]
        for k in range(s, BITS):            # m_{k+1} from m_{k+1-s}..m_k
            new = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):           # a_i: bit s - i of the poly
                if (p >> (s - i)) & 1:
                    new ^= m[k - i] << i
            m.append(new)
        V[j] = [m[b] << (BITS - 1 - b) for b in range(BITS)]
    return torch.from_numpy(V)


def lms_scramble(V: torch.Tensor, epoch: int, key) -> torch.Tensor:
    """The directions scrambled by the call's random lower-triangular
    GF(2) matrices, one a dimension (module doc, item 2)."""
    d = V.shape[0]
    j = torch.arange(d, dtype=torch.int64, device=V.device)[:, None]
    k = torch.arange(BITS, dtype=torch.int64, device=V.device)[None, :]
    w0 = philox4x32(j, epoch, 0, LMS + k, *key)[0]             # (d, 30)
    above = MASK30 & ~((2 << k) - 1)
    L = (w0 & above) | (1 << k)                         # row k of dim j
    parity = torch.zeros(d, BITS, BITS, dtype=torch.int64,
                         device=V.device)               # (j, k, b)
    for i in range(BITS):
        parity ^= ((L >> i) & 1)[:, :, None] & ((V >> i) & 1)[:, None, :]
    return (parity << k[:, :, None]).sum(1)


def sobol_words(V: torch.Tensor, n: int) -> torch.Tensor:
    """(d, n) words of points 0..n-1 in their direct form."""
    i = torch.arange(n, dtype=torch.int64, device=V.device)
    gray = i ^ (i >> 1)
    x = torch.zeros(V.shape[0], n, dtype=torch.int64, device=V.device)
    for b in range(max(n - 1, 1).bit_length()):
        x ^= ((gray >> b) & 1)[None, :] * V[:, b:b + 1]
    return x


def digital_shifts(d: int, reps, key, device) -> torch.Tensor:
    """(d, R) 30-bit shifts of the dimensions for the replicates' keys."""
    j = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    r = torch.as_tensor(reps, dtype=torch.int64, device=device)[None, :]
    return philox4x32(j, r, 0, SOBL, *key)[0] & MASK30


def normals(x: torch.Tensor, dtype) -> torch.Tensor:
    """Unit normals of shifted words by the symmetric map (item 5)."""
    xm = torch.minimum(x, MASK30 - x)
    pm = (xm.to(torch.float32) + 0.5) * float(np.float32(2.0 ** -BITS))
    pm = torch.clamp_min(pm, 2.0 ** -BITS)
    g = (-torch.special.ndtri(pm.double())).to(dtype)
    return torch.where(x < (1 << (BITS - 1)), -g, g)


def bridge_levels(N: int) -> list[list[tuple[int, int, int]]]:
    """The (m, a, b) of nodes 1..N-1 breadth first, grouped by depth;
    node k is the k-th in that order."""
    levels: list[list[tuple[int, int, int]]] = []
    queue = collections.deque([(0, N, 0)])
    while queue:
        a, b, depth = queue.popleft()
        if b - a <= 1:
            continue
        m = (a + b) // 2
        if depth == len(levels):
            levels.append([])
        levels[depth].append((m, a, b))
        queue.append((a, m, depth + 1))
        queue.append((m, b, depth + 1))
    return levels


def bridge_increments(z: torch.Tensor, N: int, sqrt_dt: float,
                      dtype) -> torch.Tensor:
    """(N, n) increments of one factor from its (N, n) node normals, the
    bridge's recursion in ``dtype`` (item 6)."""
    f32 = np.float32
    W = torch.zeros(N + 1, z.shape[1], dtype=dtype, device=z.device)
    W[N] = float(f32(np.sqrt(N)) * f32(sqrt_dt)) * z[0]
    k = 1
    for level in bridge_levels(N):
        m, a, b = (torch.tensor(c, device=z.device) for c in zip(*level))
        wl = torch.tensor([f32((bb - mm) / (bb - aa))
                           for mm, aa, bb in level], dtype=dtype,
                          device=z.device)[:, None]
        wr = torch.tensor([f32((mm - aa) / (bb - aa))
                           for mm, aa, bb in level], dtype=dtype,
                          device=z.device)[:, None]
        sig = torch.tensor(
            [f32(np.sqrt((mm - aa) * (bb - mm) / (bb - aa))) * f32(sqrt_dt)
             for mm, aa, bb in level], dtype=dtype, device=z.device)[:, None]
        W[m] = wl * W[a] + wr * W[b] + sig * z[k:k + len(level)]
        k += len(level)
    return W[1:] - W[:-1]


def kernel_constants(params: dict, N: int, dtype, device) -> dict:
    """The step's constants at sqrt_dt = 1, float32 as the kernel rounds
    them, then as ``dtype`` scalars; also S_0, v_0 and sqrt(dt)."""
    T, S_0, v_0, r, k, rho, theta, sigma = (np.float32(params[p])
                                            for p in PARAM_KEYS)
    dt = T / np.float32(N)
    one = np.float32(1.0)
    cst = {"S_0": S_0, "v_0": v_0, "A": k * theta * dt, "B": one - k * dt,
           "C": sigma, "rho_sd": rho,
           "rhoc_sd": np.sqrt(one - rho * rho), "one_rdt": one + r * dt}
    out = {name: torch.tensor(float(v), dtype=dtype, device=device)
           for name, v in cst.items()}
    out["sqrt_dt"] = float(np.sqrt(dt))
    return out


def replicate_mean(z: torch.Tensor, N: int, cst: dict, dtype) -> float:
    """One replicate's mean payoff from its (2N, n) normals."""
    dW1, dW2 = (bridge_increments(z[f::2], N, cst["sqrt_dt"], dtype)
                for f in (0, 1))
    S, v = (torch.full((z.shape[1],), float(cst[x]), dtype=dtype,
                       device=z.device) for x in ("S_0", "v_0"))
    for t in range(N):
        S, v = _step(S, v, dW1[t], dW2[t], cst)
    pay = torch.clamp_min(S - cst["S_0"], 0.0).float()
    return float(pay.double().sum()) / z.shape[1]


def price_and_ci(config: dict, key: tuple[int, int], epoch: int,
                 n_paths: int, device, dtype=torch.float32):
    """(price, CI half-width) of the call at ``epoch`` (module doc)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if config["scramble"] != "lms-shift":
        raise ValueError(f"scramble {config['scramble']!r}: the reference "
                         f"prices lms-shift only")
    N, R = config["N"], config["n_shifts"]
    if n_paths % R:
        raise ValueError(f"n_paths={n_paths} is no multiple of {R}")
    n = n_paths // R
    epoch = int(epoch) & MASK32
    cst = kernel_constants(config["params"], N, dtype, device)
    V = lms_scramble(directions(2 * N).to(device), epoch, key)
    x = sobol_words(V, n)
    shifts = digital_shifts(2 * N, [(epoch * R + r) & MASK32
                                    for r in range(R)], key, device)
    means = torch.tensor([replicate_mean(
        normals(x ^ shifts[:, r:r + 1], dtype), N, cst, dtype)
        for r in range(R)], dtype=torch.float64)
    t = float(scipy.stats.t.ppf(0.975, R - 1))
    return float(means.mean()), t * float(means.std()) / np.sqrt(R)
