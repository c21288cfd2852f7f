"""Stateful-family FE through the hand-written CUDA ``csrc/fe_stateful.cu``.

The counterpart of ``nmch_tpu/ops/fe_stateful_pallas.py``: the kernel K5
(``fe_moments_stateful_pallas``) and the two jumps that the JAX package
runs as plain XLA (``fe_stateful_state``, ``advance_state``), here small
kernels on host-computed tables.  On a CUDA device each wrapper launches
its kernel or raises; on the CPU it runs the plain version of
``ops/fe_stateful.py``, which computes the same words and payoffs
operation for operation.  States are int64 (6, n_paths) tensors of u32
words (``ops/fe_stateful.py``).

Each launch adds one to the wrapper's ``launches`` and to its
``variant_launches``: ``fe_xorwow``/``fe_mrg32k3a`` (K5),
``jump_init_<rng>`` and ``jump_advance_<rng>``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fe import LANES
from .fe_stateful import N_STATE, advance_state, check_family, \
    check_state, fe_moments_stateful_plain, fe_stateful_state, \
    host_jump_table, init_lane_tables
from .launch import call_kernel, check_device, check_params, check_sizes, \
    check_u32, count_launch, scratch

FAMILIES = ("xorwow", "mrg32k3a")  # the kernels' `rng` argument is the index
MAX_PATHS = 1 << 31     # the stream layout's path bits (rng/xorwow.py)


def _check_paths(n_paths: int) -> int:
    n_paths = int(n_paths)
    if n_paths <= 0 or n_paths % LANES or n_paths >= MAX_PATHS:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {LANES} below 2^31 (the stateful stream "
                         f"layout)")
    return n_paths


def _table_words(tab) -> torch.Tensor:
    """u32 numpy words as a flat int32 tensor (the same bits)."""
    return torch.from_numpy(np.ascontiguousarray(tab, dtype=np.uint32)
                            .view(np.int32).reshape(-1).copy())


def xorwow_rows(tab: np.ndarray) -> np.ndarray:
    """XORWOW column tables (..., 5, 32, 5) [input word wi, input bit b,
    output word wo] in the row form of the init kernel's shared jumps:
    (..., 5, 5, 32) [wo, wi, output bit l], bit b of the word set where
    output bit (wo, l) takes input bit (wi, b)."""
    tab = np.asarray(tab, dtype=np.uint32)
    bits = (tab[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    rows = np.moveaxis(bits, (-4, -3, -2, -1), (-3, -1, -4, -2))
    return (rows.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=-1).astype(np.uint32)


def lane_interleaved(lane_tabs: np.ndarray) -> np.ndarray:
    """(32, ...) per-lane tables as the init kernel reads them: word k of
    lane l's table at k * 32 + l."""
    return np.ascontiguousarray(
        np.asarray(lane_tabs, dtype=np.uint32).reshape(32, -1).T)


@functools.lru_cache(maxsize=4)
def _init_tables(rng: str, device: str):
    """(the 58 jump tables of ``rng``'s stream layout, the 32 combined
    tables of path bits 0..4 lane-interleaved) on ``device``: XORWOW's
    (58, 5, 5, 32) rows (``xorwow_rows``), MRG32k3a's (58, 2, 3, 3) J1,
    J2; ``init_lane_tables``."""
    if rng == "xorwow":
        from ..rng.xorwow import _jump_tables
        tab = xorwow_rows(_jump_tables())
    else:
        from ..rng.mrg32k3a import _jump_tables
        tab = np.stack(_jump_tables(), axis=1)
    return (_table_words(tab).to(device),
            _table_words(lane_interleaved(init_lane_tables(rng))).to(device))


@functools.lru_cache(maxsize=8)
def _advance_table(rng: str, n_steps: int, device: str):
    """(device table, Weyl increment) of the n_steps jump."""
    a, b = host_jump_table(rng, n_steps)
    if rng == "xorwow":
        return _table_words(a).to(device), int(b)
    return _table_words(np.stack([a, b])).to(device), 0


def _seed_words(rng: str, seed: int):
    """The 6 u32 words of ``seed``'s state (epoch 0, path 0)."""
    if rng == "xorwow":
        from ..rng.xorwow import seed_state
        s, d = seed_state(seed)
        return (*s, d)
    from ..rng.mrg32k3a import seed_state
    s1, s2 = seed_state(seed)
    return (*s1, *s2)


def fe_stateful_moments_cuda(params, state, *, N: int, rng: str):
    """(E[X], E[X^2]) as float64 0-dim tensors and the advanced state, over
    the FE paths that start at ``state`` (int64 (6, n_paths) on the
    device that runs them).

    params: float32 tensor (8,) on the CPU, (T, S_0, v_0, r, k, rho,
    theta, sigma); rng: "xorwow" or "mrg32k3a"."""
    check_family(rng)
    n_paths = _check_paths(check_state(state))
    device, N, _ = check_sizes(N, n_paths, state.device)
    check_params(params)
    if device.type == "cpu":
        return fe_moments_stateful_plain(params, state, N, rng)

    state = state.contiguous()
    state_out = torch.empty_like(state)
    partials, out = scratch(device, 2 * (n_paths // LANES), 2)
    name = f"fe_{rng}"
    call_kernel("nmch_fe_stateful_moments", name, device, *params.tolist(),
                N, n_paths, FAMILIES.index(rng), state.data_ptr(),
                state_out.data_ptr(), partials.data_ptr(), out.data_ptr())
    count_launch(fe_stateful_moments_cuda, name)
    return out[0], out[1], state_out


fe_stateful_moments_cuda.launches = 0
fe_stateful_moments_cuda.variant_launches = {}


def fe_stateful_state_cuda(rng: str, seed: int, n_paths: int, epoch: int,
                           device) -> torch.Tensor:
    """States of paths 0..n_paths-1 at the start of ``epoch`` of ``seed``'s
    streams, int64 (6, n_paths) on ``device`` (``ops/fe_stateful.py::
    fe_stateful_state``)."""
    check_family(rng)
    n_paths = _check_paths(n_paths)
    epoch = check_u32("epoch", epoch)
    device = check_device(device)
    if device.type == "cpu":
        return fe_stateful_state(rng, seed, n_paths, epoch, device)
    tables, lane_tables = _init_tables(rng, str(device))
    out = torch.empty(N_STATE, n_paths, dtype=torch.int64, device=device)
    name = f"jump_init_{rng}"
    call_kernel("nmch_stateful_init", name, device, FAMILIES.index(rng),
                tables.data_ptr(), lane_tables.data_ptr(),
                *_seed_words(rng, seed), epoch, n_paths, out.data_ptr())
    count_launch(fe_stateful_state_cuda, name)
    return out


fe_stateful_state_cuda.launches = 0
fe_stateful_state_cuda.variant_launches = {}


def advance_state_cuda(rng: str, state, n_steps: int) -> torch.Tensor:
    """Every state moved n_steps recurrence steps forward, a new int64
    (6, n_paths) tensor (``ops/fe_stateful.py::advance_state``)."""
    check_family(rng)
    n_paths = _check_paths(check_state(state))
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps} must be >= 0")
    device = state.device
    if device.type == "cpu":
        return advance_state(rng, state, n_steps)
    table, d_inc = _advance_table(rng, n_steps, str(device))
    state = state.contiguous()
    out = torch.empty_like(state)
    name = f"jump_advance_{rng}"
    call_kernel("nmch_stateful_advance", name, device, FAMILIES.index(rng),
                table.data_ptr(), d_inc, n_paths, state.data_ptr(),
                out.data_ptr())
    count_launch(advance_state_cuda, name)
    return out


advance_state_cuda.launches = 0
advance_state_cuda.variant_launches = {}
