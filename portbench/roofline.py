"""Frozen work of the pricing kernels, and the card's peak issue rate.

A kernel's roofline share is the least time the card could take for its
work, over its time in the trace.  The work is the number of thread
instructions the algorithm itself needs for these inputs, counted once by
hand from the algorithm's definition (the plain reference's operations,
``portbench/reference``), never from a built library:

* one instruction for each primitive 32-bit operation: an add, multiply,
  compare, select, shift, float/int conversion, a 32x32->64 multiply, a
  three-input logic operation (``a ^ b ^ c``, ``(a & m) | c``), and a
  transcendental (sqrt, rsqrt, log, log1p, exp, a division);
* loop invariants are left out: anything fixed for a path (its epoch,
  path word, key schedule, the step constants) or for a step of a path
  (Philox's first-round product of the path word, the PTRS constants'
  multiples) is counted where it changes, not where it is used.

Bytes never bound these kernels: a path touches memory only to write its
two float64 partial sums, 16 bytes against ~10^5 instructions.  So the
bound is the issue rate alone: 132 SMs x 128 lanes x 1.98 GHz =
33.45 T lane-instructions/s, NVIDIA's published 67 TFLOP/s float32 with an
FMA counted as two (H100 SXM5 at its 700 W limit; the result line gives the
card's power limit beside it).
"""

from __future__ import annotations

PEAK_LANE_INSTR_PER_S = 132 * 128 * 1.98e9

# Philox4x32-10, one block: 10 rounds of two 32x32->64 products and two
# three-input XORs (hi ^ c ^ key) = 40; in round 1 the product of the
# path word (c2) and the XOR that takes only invariants (hi1 ^ epoch ^ k0)
# are per path, so round 1 costs 2; the block index's increment 1.
PHILOX_BLOCK = 2 + 9 * 4 + 1                                    # 39

# Half-circle Box-Muller pair (FE): uniform (shift, or, sub) 3; -2 ln u
# from the bits: exponent (shift+or as one, sub) 2 + 1, mantissa (and+or)
# 1, t = m - 1 1, degree-7 Horner 14, q = e a + c + t p 4, clamp 1 = 24;
# sqrt 1; sign (and+xor) 1; phase bits (and+or) 1; z = f pi - 3pi/2 2;
# z^2 1; sin Horner 6 + z 1 = 7; cos Horner 8; R cos, R sin 2.
NORMAL_PAIR_HC = 3 + 24 + 1 + 1 + 1 + 2 + 1 + 7 + 8 + 2         # 50

# Euler step: sqrt(v) 1; zc = a g1 + b g2 3; S (one_rdt + sqv zc) 3;
# |B v + A + sqv (C g1)| 6.
EULER_STEP = 13

# Per path: payoff (sub, max) 2; X^2 1; two conversions to float64 and
# two float64 adds into the thread's partials 4.
PAYOFF_AND_SUMS = 7

# FE counter block: one Philox block, two normal pairs, two steps.
FE_BLOCK = PHILOX_BLOCK + 2 * NORMAL_PAIR_HC + 2 * EULER_STEP  # 165

# Turns Box-Muller, one normal of the pair (EM samplers): two uniforms 6;
# sqrt(-2 ln u1) (log, mul, sqrt) 3; cos 2 pi u2 by quadrant: 4 u 1,
# floor(x + 1/2) 2, r 1, to int 1, r^2 1, cos Horner 8, sin Horner 6 + r
# 1, quadrant select (and, select) 2, sign ((q+1) & 2 as add, and) 2 and
# negate 1 = 26; r c 1.
TURNS_NORMAL = 6 + 3 + 26 + 1                                   # 36

# Poisson, a lane's step set-up by regime: large: sqrt(lam) 1; PTRS:
# sqrt 1, b 2, a 2, 1/alpha (sub, div, add) 3, v_r 3, ln lam 1 = 12;
# Knuth: e^-lam 1.
POISSON_SETUP = {"large": 1, "mid": 12, "small": 1}

# Poisson round, normal approximation: Philox 39, one turns normal 36,
# floor(lam + sqrt(lam) g + 1/2) 4, clamp 1.
ROUND_LARGE = PHILOX_BLOCK + TURNS_NORMAL + 4 + 1               # 80

# PTRS round: Philox 39; U (uniform 3, - 1/2 1) 4; V 3; us = 1/2 - |U| 1;
# k = floor((2a/us + b) U + lam + 0.43) 6; squeeze (2 compares, and) 3;
# reject (3 compares, one three-input logic) 4; ln(V/alpha / (a/us^2 +
# b)) 6; the right side: z, z < 3 2, ln(z (z+1)) and select 4, w 2,
# (w - lam)/lam 2, -(w - 1/2) log1p 3, (k - w + 1/2) ln lam 3, the sum's
# five terms 5, Stirling 1/w, its square, the Horner pair, / w 7 = 28;
# compare 1; accept (three-input logic) 1; clamp 1; result select and
# active update 2.
ROUND_PTRS = PHILOX_BLOCK + 4 + 3 + 1 + 6 + 3 + 4 + 6 + 28 + 1 + 1 + 1 + 2

# Knuth round: Philox 39; four uniforms, each: uniform 3, t >= target 1,
# t u 1, count 1 = 24; done test 1; k = count - 1 and clamp 2.
ROUND_KNUTH = PHILOX_BLOCK + 4 * 6 + 1 + 2                     # 66

# Gamma set-up a step: alpha < 1 1, alpha + boost 1, d = alpha - 1/3 1,
# rsqrt(9 d) 2.  Boost (alpha < 1, once): uniform 3, log 1, div 1, exp 1.
GAMMA_SETUP = 5
GAMMA_BOOST = 6

# Marsaglia-Tsang round: Philox 39; one turns normal 36; v1 = 1 + c x 2;
# v = v1^3 2; u 3; x^2 1; squeeze (two products, sub, compare) 4;
# ln max(v, tiny) 2; ln u < x^2/2 + d (1 - v + ln v) 7; accept 2;
# d v C 2.
ROUND_GAMMA = PHILOX_BLOCK + TURNS_NORMAL + 2 + 2 + 3 + 1 + 4 + 2 + 7 + 2 + 2

# EM step besides the samplers: lam = c v 1, two regime compares 2,
# alpha = d + N_p 1, v' = vfac gamma 1, vI += v + v' 2.
EM_STEP = 7

# EM terminal: vI dt/2 1; m 8; sig = sqrt((1 - rho^2) vI) 2; Philox 39;
# one turns normal 36; exp(m + sig g) 3; payoff and sums 7.
EM_TERMINAL = 1 + 8 + 2 + PHILOX_BLOCK + TURNS_NORMAL + 3 + PAYOFF_AND_SUMS


def fe_path_work(N: int) -> int:
    """Thread instructions of one FE path of N steps (rot 1, box hc): the
    odd-N tail's block draws its four normals and takes one step."""
    full, tail = divmod(N, 2)
    return (full * FE_BLOCK
            + tail * (PHILOX_BLOCK + 2 * NORMAL_PAIR_HC + EULER_STEP)
            + PAYOFF_AND_SUMS)


def em_work(counts: dict, N: int) -> float:
    """Thread instructions of the EM paths whose sampler counts (summed
    over all their lanes: ``portbench/reference/em.py::COUNTS``) are
    given, over N steps each."""
    paths = counts["paths"]
    return (paths * N * (EM_STEP + GAMMA_SETUP)
            + counts["steps_large"] * POISSON_SETUP["large"]
            + counts["steps_mid"] * POISSON_SETUP["mid"]
            + counts["steps_small"] * POISSON_SETUP["small"]
            + counts["rounds_large"] * ROUND_LARGE
            + counts["rounds_ptrs"] * ROUND_PTRS
            + counts["rounds_knuth"] * ROUND_KNUTH
            + counts["rounds_gamma"] * ROUND_GAMMA
            + counts["boosts"] * GAMMA_BOOST
            + paths * EM_TERMINAL)


def share_pct(instructions: float, seconds: float) -> float:
    """The least time of ``instructions`` at the peak over ``seconds``, in %."""
    return 100.0 * instructions / PEAK_LANE_INSTR_PER_S / seconds
