"""Frozen work of the QMC engine's whole call, and K6's bytes.

The work of one point (one path of one replicate) over the 2N dimensions
of its two factors, counted by ``roofline.py``'s rules (one instruction a
primitive 32-bit operation, a multiply and an add two; invariants left
out) for the least work of the algorithm, so that no implementation, fused
or not, reads over 100%:

* the Sobol' words by Gray-code recursion (Antonov and Saleev 1979):
  point i's word is point i-1's XOR the direction of the bit that flips
  in the Gray code, so a point takes one bit scan, shared by its
  dimensions, and one XOR a dimension.  A replicate's digital shift rides
  in the recursion's first word, so it costs no XOR a point;
* the linear matrix scramble acts on the directions, once a call: left
  out as the call's invariant;
* the normals by the single-precision inverse CDF of Giles ("Approximating
  the erfinv function", GPU Computing Gems, 2010), its central branch,
  which takes the word as x = 2u - 1 and gives the sign with the odd
  erfinv;
* the Brownian bridge by its O(N) recursion (Glasserman 2004, section
  5.5), not the dense product;
* N Euler steps in the kernel's form and the payoff and its sums
  (``roofline.EULER_STEP``, ``roofline.PAYOFF_AND_SUMS``).

The replicate means and the CI are a few dozen operations a call and are
left out; the peak is ``roofline.PEAK_LANE_INSTR_PER_S``.  K6
(``csrc/qmc.cu``) is bound by bytes: a path-step reads one
float32 increment of each factor.
"""

from __future__ import annotations

from portbench.roofline import EULER_STEP, PAYOFF_AND_SUMS

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM5 HBM3, NVIDIA's data sheet

# a point: the index of the bit that flips in its Gray code (one bit scan)
GRAY_SCAN = 1

# a point and dimension: the word, the direction's XOR 1 (the shift rides
# in the first word)
SOBOL_WORD = 1

# the word as x = 2u - 1 in (-1, 1): conversion 1, multiply by 2^-29 1,
# add 2^-30 - 1 1
PM_MAP = 3

# Giles's central branch: (1 - x)(1 + x) 3; its log 1; w = -log - 2.5, the
# sign with the add 1; Horner of 9 coefficients, 8 multiplies and 8 adds
# 16; p x 1 (sqrt 2 folded into the coefficients) = 22
INV_CDF = 3 + 1 + 1 + 16 + 1


def bridge_work(N: int) -> int:
    """Instructions of one factor's bridge at one point: the terminal node
    W_N = sig z 1; a midpoint wl W_a + wr W_b + sig z, three multiplies and
    two adds 5, or 3 where a = 0 (W_0 = 0); the increments W_{t+1} - W_t,
    N - 1 subtractions (dW_0 = W_1).  sqrt(dt) rides in each node's sig."""
    ops, segs = 1, [(0, N)]
    while segs:
        a, b = segs.pop()
        if b - a > 1:
            m = (a + b) // 2
            ops += 5 if a else 3
            segs += [(a, m), (m, b)]
    return ops + N - 1


def point_work(N: int) -> int:
    """Instructions of one point of N steps, from its index to its sums."""
    return (GRAY_SCAN + 2 * N * (SOBOL_WORD + PM_MAP + INV_CDF)
            + 2 * bridge_work(N) + N * EULER_STEP + PAYOFF_AND_SUMS)


def k6_bytes(N: int, M: int) -> int:
    """Bytes K6 has to read for M paths of N steps: one float32 of each
    factor a path-step (the partial sums' writes are noise)."""
    return 8 * N * M


def bytes_share_pct(nbytes: float, seconds: float) -> float:
    """The least time of ``nbytes`` at the peak bandwidth over ``seconds``,
    in %."""
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
