"""Forward Euler from carried per-path recurrence states: the host side of
``nmch_tpu/ops/fe_stateful_pallas.py`` and the plain version of its
kernel (TPU kernel K5, ``csrc/fe_stateful.cu`` here).

A state is an int64 (6, n_paths) tensor of u32 words, path i in column i:
XORWOW's (x, y, z, w, v, d) or MRG32k3a's s1 || s2.  The layout of
``nmch_tpu`` is u32 (6, n_paths/128, 128); ``state_from_numpy`` and
``state_to_numpy`` convert between the two.

Stream contract (shared with the golden engines ``ops/fe_xorwow.py`` and
``ops/fe_mrg.py``): epoch e of path p starts at recurrence step
p * 2^67 + e * 2^40 (``fe_stateful_state``).  One pricing run draws
D = ``draws_per_compute(N)`` steps per path and returns the advanced
state; ``advance_state`` by ``epoch_stride(rng) - D`` then lands exactly
on epoch e+1's start, so carried states and the golden's skip-ahead give
the same prices at every epoch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rng.philox import MASK32
from .fe import LANES, euler_paths, moments_f64
from .sampling import STATEFUL_RNGS, stream_state_init

N_STATE = 6          # u32 state words, both families


def check_family(rng: str) -> None:
    """Refuse a generator that is not a stateful family."""
    if rng not in STATEFUL_RNGS:
        raise ValueError(f"rng={rng!r}: this kernel hosts the stateful "
                         f"families {STATEFUL_RNGS} only (counter rngs: "
                         f"ops/fe_cuda.py)")


def draws_per_compute(N: int) -> int:
    """Recurrence steps one FE pricing run draws per path: 4 per counter
    block, ceil(N/2) blocks (an odd N's masked tail still draws)."""
    return 4 * ((int(N) + 1) // 2)


def epoch_stride(rng: str) -> int:
    """Recurrence steps between successive epochs of one path's stream."""
    check_family(rng)
    if rng == "xorwow":
        from ..rng.xorwow import EPOCH_LOG2
    else:
        from ..rng.mrg32k3a import EPOCH_LOG2
    return 1 << EPOCH_LOG2


@functools.lru_cache(maxsize=8)
def host_jump_table(rng: str, n_steps: int):
    """The exact n_steps-step jump as u32 tables: XORWOW (5, 32, 5)
    columns (``rng/xorwow.py::_jump_tables`` layout) and the Weyl
    increment; MRG32k3a the two (3, 3) matrices.  Cached: every carried
    run jumps by the same ``epoch_stride - D``."""
    check_family(rng)
    if rng == "xorwow":
        from ..rng.xorwow import WEYL, _columns_to_table, _mat_pow
        return (_columns_to_table(_mat_pow(n_steps)),
                np.uint32((WEYL * n_steps) & 0xFFFFFFFF))
    from ..rng.mrg32k3a import M1, M2, _A1, _A2, _mat_pow
    return (np.array(_mat_pow(_A1, n_steps, M1), dtype=np.uint32),
            np.array(_mat_pow(_A2, n_steps, M2), dtype=np.uint32))


def check_state(state) -> int:
    """Raise unless ``state`` is an int64 (6, n) tensor, n a positive
    multiple of 128; returns n."""
    if not isinstance(state, torch.Tensor) or state.dtype != torch.int64 \
            or state.dim() != 2 or state.shape[0] != N_STATE:
        raise ValueError("state must be an int64 tensor of shape (6, "
                         "n_paths)")
    n = state.shape[1]
    if n <= 0 or n % LANES:
        raise ValueError(f"state holds {n} paths: expected a positive "
                         f"multiple of {LANES}")
    return n


def fe_stateful_state(rng: str, seed: int, n_paths: int, epoch: int,
                      device="cpu") -> torch.Tensor:
    """States of paths 0..n_paths-1 at the start of epoch ``epoch`` of
    ``seed``'s streams: int64 (6, n_paths) on ``device``."""
    check_family(rng)
    pidx = torch.arange(int(n_paths), dtype=torch.int64, device=device)
    return torch.stack(stream_state_init(rng, seed, pidx, epoch))


# the split skip-ahead of the init kernel (csrc/fe_stateful.cu::
# stateful_init): a warp's 32 paths differ only in their low LANE_BITS path
# bits, whose jumps (tables EPOCH_BITS .. EPOCH_BITS + LANE_BITS - 1) one
# combined table per lane applies; every other jump is warp-uniform
WARP = 32
LANE_BITS = 5
EPOCH_BITS = 27      # jump tables [0, 27) select the epoch, [27, 58) path


@functools.lru_cache(maxsize=2)
def init_lane_tables(rng: str) -> np.ndarray:
    """The 32 combined jump tables of the low path bits: table l is the
    product of the path jumps 0..4 that lane l's bits select (F^(l 2^67)),
    in the single tables' u32 layout: XORWOW (32, 5, 32, 5) columns,
    MRG32k3a (32, 2, 3, 3) J1, J2."""
    check_family(rng)
    lanes = range(WARP)
    if rng == "xorwow":
        from ..rng.xorwow import N_BITS, _jump_tables, table_bit_matrix
        mats = table_bit_matrix(_jump_tables()[EPOCH_BITS:
                                               EPOCH_BITS + LANE_BITS])
        out = np.zeros((WARP, N_BITS, N_BITS), dtype=np.float32)
        for lane in lanes:
            m = np.eye(N_BITS, dtype=np.float32)
            for k in range(LANE_BITS):
                if lane >> k & 1:
                    m = np.remainder(mats[k] @ m, 2.0)   # exact: sums <= 160
            out[lane] = m
        # [out bit, in bit] -> columns: word wo of column (wi, b)
        bits = out.reshape(WARP, 5, 32, 5, 32).transpose(0, 3, 4, 1, 2)
        return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
            .sum(axis=-1).astype(np.uint32)
    from ..rng.mrg32k3a import M1, M2, _jump_tables, _mat_mul
    out = np.empty((WARP, 2, 3, 3), dtype=np.uint32)
    for j, (tabs, m) in enumerate(zip(_jump_tables(), (M1, M2))):
        for lane in lanes:
            P = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
            for k in range(LANE_BITS):
                if lane >> k & 1:
                    P = _mat_mul(P, tuple(tuple(int(x) for x in row) for row
                                          in tabs[EPOCH_BITS + k]), m)
            out[lane, j] = P
    return out


def fe_stateful_state_split(rng: str, seed: int, n_paths: int, epoch: int,
                            device="cpu") -> torch.Tensor:
    """``fe_stateful_state`` as the init kernel computes it: each warp of
    32 paths takes the warp-uniform jumps (the epoch's bits, its paths'
    bits 5 and up) on the seed's state once, then each lane its combined
    table (``init_lane_tables``).  The jumps are powers of one transition,
    so they commute and the states are fe_stateful_state's bit for bit.
    n_paths: a positive multiple of 32."""
    check_family(rng)
    n_paths = int(n_paths)
    if n_paths <= 0 or n_paths % WARP:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {WARP}")
    epoch = int(epoch)
    warp_bits = torch.arange(n_paths // WARP, dtype=torch.int64,
                             device=device)     # path bits 5 and up
    lane_tabs = init_lane_tables(rng)
    if rng == "xorwow":
        from ..rng.xorwow import _jump_bit_matrices, bits_to_words, \
            gf2_apply, seed_state, table_bit_matrix, words_to_bits
        base, d0 = seed_state(seed)
        mats = _jump_bit_matrices(str(device))
        bits = words_to_bits(torch.tensor(base, dtype=torch.int64,
                                          device=device).view(5, 1))
        for m in range(EPOCH_BITS):
            if epoch >> m & 1:
                bits = gf2_apply(mats[m], bits)
        bits = bits.expand(-1, warp_bits.numel())
        for m in range(EPOCH_BITS + LANE_BITS, mats.shape[0]):
            on = (warp_bits >> (m - EPOCH_BITS - LANE_BITS) & 1).bool()
            if bool(on.any()):
                bits = torch.where(on, gf2_apply(mats[m], bits), bits)
        lane_mats = torch.from_numpy(table_bit_matrix(lane_tabs)).to(device)
        bits = torch.remainder(torch.einsum("lij,jw->iwl", lane_mats, bits),
                               2.0).reshape(bits.shape[0], n_paths)
        return torch.cat([bits_to_words(bits),
                          torch.full((1, n_paths), d0, dtype=torch.int64,
                                     device=device)])
    from ..rng.mrg32k3a import M1, M2, _jump_tensors, matvec, seed_state
    J = _jump_tensors(str(device))
    out = []
    for j, (b, m) in enumerate(zip(seed_state(seed), (M1, M2))):
        s = torch.tensor(b, dtype=torch.int64, device=device).view(3, 1)
        for k in range(EPOCH_BITS):
            if epoch >> k & 1:
                s = matvec(J[j][k], s, m)
        s = s.expand(3, warp_bits.numel())
        for k in range(EPOCH_BITS + LANE_BITS, J[j].shape[0]):
            on = (warp_bits >> (k - EPOCH_BITS - LANE_BITS) & 1).bool()
            if bool(on.any()):
                s = torch.where(on, matvec(J[j][k], s, m), s)
        lanes = torch.from_numpy(lane_tabs[:, j].astype(np.int64)).to(device)
        out.append(torch.stack([matvec(lanes[lane], s, m)
                                for lane in range(WARP)], dim=-1)
                   .reshape(3, n_paths))
    return torch.cat(out)


def advance_state(rng: str, state: torch.Tensor, n_steps: int):
    """Every path's state moved n_steps recurrence steps forward: one
    dense jump (a GF(2) product for XORWOW, two modular 3x3 products for
    MRG32k3a)."""
    check_state(state)
    dev = state.device
    if rng == "xorwow":
        from ..rng.xorwow import bits_to_words, gf2_apply, \
            table_bit_matrix, words_to_bits
        tab, d_inc = host_jump_table(rng, int(n_steps))
        mat = torch.from_numpy(table_bit_matrix(tab)).to(dev)
        s = bits_to_words(gf2_apply(mat, words_to_bits(state[:5])))
        return torch.cat([s, ((state[5] + int(d_inc)) & MASK32)[None]])
    from ..rng.mrg32k3a import M1, M2, matvec
    J1, J2 = (torch.from_numpy(J.astype(np.int64)).to(dev)
              for J in host_jump_table(rng, int(n_steps)))
    return torch.cat([matvec(J1, state[:3], M1), matvec(J2, state[3:], M2)])


def fe_moments_stateful_plain(params, state, N: int, rng: str):
    """The plain version of K5: (E[X], E[X^2]) as float64 0-dim tensors
    and the advanced state, from paths starting at ``state``.

    params: float32 (8,) on the device of ``state``."""
    check_family(rng)
    check_state(state)
    words = list(state.unbind(0))
    if rng == "xorwow":
        from .fe_xorwow import _draw_normal4

        def normals4(_):
            g, s, d = _draw_normal4(tuple(words[:5]), words[5])
            words[:] = [*s, d]
            return g
    else:
        from .fe_mrg import _draw_normal4

        def normals4(_):
            g, s1, s2 = _draw_normal4(tuple(words[:3]), tuple(words[3:]))
            words[:] = [*s1, *s2]
            return g
    S_T, _ = euler_paths(params, N, state[0], normals4)
    m, m2 = moments_f64(torch.clamp_min(S_T - params[1], 0.0))
    return m, m2, torch.stack(words)


def state_from_numpy(a) -> torch.Tensor:
    """``nmch_tpu``'s u32 (6, R, 128) state -> the port's int64 (6, n)."""
    a = np.asarray(a, dtype=np.uint32)
    if a.ndim != 3 or a.shape[0] != N_STATE or a.shape[2] != LANES:
        raise ValueError(f"expected a (6, R, {LANES}) state, got {a.shape}")
    return torch.from_numpy(a.astype(np.int64).reshape(N_STATE, -1))


def state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """The port's int64 (6, n) state -> ``nmch_tpu``'s u32 (6, R, 128)."""
    check_state(state)
    return state.cpu().numpy().astype(np.uint32).reshape(N_STATE, -1, LANES)
