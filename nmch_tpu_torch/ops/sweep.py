"""Parameter sweeps in plain PyTorch: FE and EM moments of P points at once.

The counterparts of ``nmch_tpu/ops/sweep_pallas.py::fe_sweep_scan`` and
``em_sweep_scan``, and the plain versions of the sweep kernels
(``csrc/sweep.cu``, ``ops/sweep_cuda.py``).  The contract
(``sweep_pallas.py:12-13,89-94``): point p prices at epoch
``(epoch0 + p) mod 2^32`` with path ids 0..n_paths-1 and path_hi = 0, so
point p equals a single-point run at that epoch with base_path 0.

The points ride a leading axis: paths in (P, n_paths/128, 128) tensors,
per-point parameters, constants and epochs in (P, 1, 1) tensors, so each
op of the single-point plain version (``ops/fe.py``, ``ops/em.py``) runs
once for all points.  The EM samplers keep their masked rounds
(``ops/sampling.py``): a round runs while any lane of any point is
active and a lane's counter moves only while that lane is active, so each
path draws exactly what its single-point run draws.  Each point's
moments are ``moments_f64`` of its own (n_paths/128, 128) payoffs, the
single-point sum.
"""

from __future__ import annotations

import torch

from ..rng.philox import MASK32
from .em import EmConsts, em_consts_table, payoffs_from_consts
from .fe import fe_terminal, moments_f64, path_index_grid


def sweep_epochs(epoch0: int, n_points: int, device) -> torch.Tensor:
    """(P, 1, 1) int64 u32 epochs: (epoch0 + p) mod 2^32."""
    p = torch.arange(n_points, dtype=torch.int64, device=device)
    return ((p + int(epoch0)) & MASK32).reshape(n_points, 1, 1)


def point_moments(payoff: torch.Tensor):
    """(P,) float64 (E[X], E[X^2]) of (P, R, 128) payoffs, point by point."""
    m, m2 = zip(*(moments_f64(x) for x in payoff))
    return torch.stack(m), torch.stack(m2)


def _columns(table: torch.Tensor, device) -> tuple:
    """The columns of a (P, C) table as C tensors of shape (P, 1, 1)."""
    P, C = table.shape
    return table.to(device).T.reshape(C, P, 1, 1).unbind()


def fe_sweep_plain(params_matrix, seed_words, epoch0: int, *, N: int,
                   n_paths: int, rng: str = "philox", device="cpu"):
    """(E[X], E[X^2]) per point as two float64 (P,) tensors on ``device``.

    params_matrix: float32 (P, 8) rows of (T, S_0, v_0, r, k, rho, theta,
    sigma); seed_words: the (k0, k1) u32 key; rng: philox, threefry4 or
    device (``rng/device.py``, 4 words a block)."""
    k0, k1 = (int(w) for w in seed_words)
    P = params_matrix.shape[0]
    params = torch.stack(_columns(params_matrix, device))
    S_T, _ = fe_terminal(params, N, path_index_grid(n_paths, 0, device),
                         sweep_epochs(epoch0, P, device), k0, k1, rng=rng)
    return point_moments(torch.clamp_min(S_T - params[1], 0.0))


def em_sweep_plain(params_matrix, seed_words, epoch0: int, *, N: int,
                   n_paths: int, rng: str = "philox",
                   conditional: bool = False,
                   poisson_cut: float | None = None, device="cpu",
                   per_path: bool = False):
    """(E[X], E[X^2]) per point as two float64 (P,) tensors on ``device``,
    the EM scheme with the loop constants of ``em_consts_table``
    (poisson_cut None means 4000).  per_path=True also returns each
    path's payoff (float32) and final counter (int64), (P, n_paths/128,
    128)."""
    k0, k1 = (int(w) for w in seed_words)
    table = em_consts_table(params_matrix, N, poisson_cut)
    cols = _columns(table, device)
    c = EmConsts(*cols[:-1], float(table[0, -1]))
    payoff, ctr = payoffs_from_consts(
        c, N, path_index_grid(n_paths, 0, device),
        sweep_epochs(epoch0, table.shape[0], device), k0, k1, rng,
        conditional)
    m, m2 = point_moments(payoff)
    return (m, m2, payoff, ctr) if per_path else (m, m2)
