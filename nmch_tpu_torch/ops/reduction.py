"""The f32 tile-tree plus Kahan reduction of ``benchmarks/reduction_bench.py``
(TPU kernel K7), in plain PyTorch.

``nmch_tpu``'s reduction probe sums an HBM-resident float32 array of
(rows, 128) in (512, 128) tiles: a tree sum of each tile, then a
Kahan-compensated sum of the tile sums across the sequential grid
(``nmch_tpu/ops/fe_pallas.py::_kahan_add``).  The card's kernel
(``csrc/reduction.cu``, ``ops/reduction_cuda.py``) keeps that
arithmetic, all in float32; this module is its plain version.

The order inside a tile is the kernel's, fixed here and in
``csrc/reduction.cu`` alike, so that the kernel equals this version
bitwise on any data: the tile's 65,536 floats are 16,384 float4s; thread
t of the tile's 256 threads takes float4s t, t + 256, ..., t + 63 * 256
and keeps one running sum per float4 lane; its sum is (x + y) + (z + w);
each warp of 32 threads folds its lanes with shuffle-down steps of 16,
8, 4, 2, 1, and the 8 warp sums fold by 4, 2, 1.  XLA's ``jnp.sum`` of a
tile takes another order, so on random data the port and ``nmch_tpu``
agree to rounding (rel 1e-6), and bitwise only where every partial is
exact (constant data).
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 512                 # rows per tile (reduction_bench.py:33)
LANES = 128
TILE_ELEMS = TILE * LANES  # 65,536 floats
THREADS = 256              # threads per tile in csrc/reduction.cu
VEC = 4                    # floats per load (float4)
STRIDES = TILE_ELEMS // (THREADS * VEC)   # 64 float4s per thread
WARP = 32


def check_rows(x: torch.Tensor) -> int:
    """Validate a (rows, 128) float32 input; returns the tile count."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError("x must be a float32 tensor of shape (rows, 128)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major (rows, 128))")
    rows = x.shape[0]
    if rows == 0 or rows % TILE:
        raise ValueError(f"rows={rows} must be a positive multiple of "
                         f"TILE={TILE}")
    return rows // TILE


def kahan_add(acc, comp, val):
    """One compensated addition, ``_kahan_add``'s four float32 operations
    in its order; returns the new (acc, comp)."""
    y = val - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def _fold(v: torch.Tensor, width: int) -> torch.Tensor:
    """Shuffle-down tree over the last axis (``width`` lanes, a power of
    2): lane l adds lane l + s for s = width/2, ..., 1; returns lane 0."""
    s = width // 2
    while s:
        v = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def tile_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 (n_tiles,): each (512, 128) tile's sum in the kernel's
    order (see the module docstring)."""
    n_tiles = check_rows(x)
    v = x.reshape(n_tiles, STRIDES, THREADS, VEC)
    acc = v[:, 0].clone()
    for k in range(1, STRIDES):
        acc = acc + v[:, k]
    per_thread = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    warps = _fold(per_thread.reshape(n_tiles, THREADS // WARP, WARP), WARP)
    return _fold(warps, THREADS // WARP)


def red_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 0-dim on x's device: the tile sums added with
    ``kahan_add`` in tile order from (0, 0), as ``_red_kernel`` starts at
    grid step 0 (the sequential part runs on numpy float32 scalars)."""
    acc = comp = np.float32(0.0)
    for s in tile_sums_plain(x).cpu().numpy():
        acc, comp = kahan_add(acc, comp, s)
    return torch.tensor(acc, dtype=torch.float32, device=x.device)
