"""Forward-Euler golden driven by MRG32k3a streams (plain PyTorch).

The counterpart of ``nmch_tpu/ops/fe_mrg.py``: the Euler steps of
``ops/fe.py``, with draws from the MRG32k3a recurrence of
``rng/mrg32k3a.py`` carried through the loop, the state of stream (seed,
path, epoch) found by skip-ahead.  Block contract as ``ops/fe.py``: 4
recurrence outputs per block become two Box–Muller pairs for steps 2j and
2j+1, and an odd-N tail is skipped but its draws are still taken.
"""

from __future__ import annotations

import torch

from ..rng.mrg32k3a import mrg_state_at, mrg_step, u01_from_z
from ..rng.normal import boxmuller
from .fe import euler_paths, moments_f64


def _draw_normal4(s1, s2):
    """Four recurrence steps -> 4 N(0,1) draws (two Box–Muller pairs)."""
    z0, s1, s2 = mrg_step(s1, s2)
    z1, s1, s2 = mrg_step(s1, s2)
    z2, s1, s2 = mrg_step(s1, s2)
    z3, s1, s2 = mrg_step(s1, s2)
    g0, g1 = boxmuller(u01_from_z(z0), u01_from_z(z1))
    g2, g3 = boxmuller(u01_from_z(z2), u01_from_z(z3))
    return (g0, g1, g2, g3), s1, s2


def fe_terminal_mrg(params_vec, N: int, path_idx, epoch: int, seed: int):
    """(S_T, v_T) for (R, 128) path indices, MRG32k3a streams of ``seed``
    at ``epoch``."""
    st = list(mrg_state_at(seed, path_idx, epoch))

    def normals4(_):
        g, st[0], st[1] = _draw_normal4(*st)
        return g
    return euler_paths(params_vec, N, path_idx, normals4)


def fe_moments_mrg(params_vec, N: int, path_idx, epoch: int, seed: int):
    """Golden engine: (E[X], E[X^2]), X = (S_T - K)^+, K = S_0, as float64
    0-dim tensors."""
    S_T, _ = fe_terminal_mrg(params_vec, N, path_idx, epoch, seed)
    return moments_f64(torch.clamp_min(S_T - params_vec[1], 0.0))
