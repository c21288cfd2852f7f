"""Forward-Euler golden driven by XORWOW streams (plain PyTorch).

The counterpart of ``nmch_tpu/ops/fe_xorwow.py``: the Euler steps of
``ops/fe.py``, with draws from the xorshift+Weyl recurrence of
``rng/xorwow.py`` carried through the loop, the state of stream (seed,
path, epoch) found by skip-ahead.  Block contract as ``ops/fe.py``: 4
recurrence outputs per block become two Box–Muller pairs for steps 2j and
2j+1, and an odd-N tail is skipped but its draws are still taken.
"""

from __future__ import annotations

import torch

from ..rng.normal import boxmuller
from ..rng.xorwow import u01_from_out, xorwow_state_at, xorwow_step
from .fe import euler_paths, moments_f64


def _draw_normal4(s, d):
    """Four recurrence steps -> 4 N(0,1) draws (two Box–Muller pairs)."""
    o0, s, d = xorwow_step(s, d)
    o1, s, d = xorwow_step(s, d)
    o2, s, d = xorwow_step(s, d)
    o3, s, d = xorwow_step(s, d)
    g0, g1 = boxmuller(u01_from_out(o0), u01_from_out(o1))
    g2, g3 = boxmuller(u01_from_out(o2), u01_from_out(o3))
    return (g0, g1, g2, g3), s, d


def fe_terminal_xorwow(params_vec, N: int, path_idx, epoch: int, seed: int):
    """(S_T, v_T) for (R, 128) path indices, XORWOW streams of ``seed``
    at ``epoch``."""
    s, d = xorwow_state_at(seed, path_idx, epoch)
    st = [s, d]

    def normals4(_):
        g, st[0], st[1] = _draw_normal4(*st)
        return g
    return euler_paths(params_vec, N, path_idx, normals4)


def fe_moments_xorwow(params_vec, N: int, path_idx, epoch: int, seed: int):
    """Golden engine: (E[X], E[X^2]), X = (S_T - K)^+, K = S_0, as float64
    0-dim tensors."""
    S_T, _ = fe_terminal_xorwow(params_vec, N, path_idx, epoch, seed)
    return moments_f64(torch.clamp_min(S_T - params_vec[1], 0.0))
