"""The fused QMC bridge + simulator through the hand-written CUDA kernel
``csrc/qmc_fused.cu``.

The counterpart of ``benchmarks/qmc_fused_probe.py``'s
``qmc_payoff_sums_fused`` (kernel K9) and ``qmc_payoff_sums_fused_hilo``
(kernel K10) in one function: ``precision`` "HIGHEST" is K9's float32
product, "HIGH" K10's three bf16 hi/lo products, "DEFAULT" one bf16
product.  Each point's thread makes its increments from its own column
of the normals and steps them at once, so no increment reaches device
memory.  The kernel sums each increment over the bridge matrix's
non-zeros only, following a plan of A's non-zero pattern
(``fused_plan``) that the wrapper builds with torch ops on A's device
and caches while A is unchanged.  On a CUDA tensor the wrapper launches
the kernel (then one block per replicate that sums the per-block
partials) or raises; on a CPU tensor it runs the plain version,
``ops/fe_qmc.py::qmc_payoff_sums_fused_plain``, whose dense loop gives
the same increments and payoffs operation for operation (a skipped
product is a signed zero, which leaves a float32 sum as it is).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from .fe import LANES
from .fe_qmc import PRECISIONS, check_fused, fused_operands, \
    qmc_payoff_sums_fused_plain
from .launch import call_kernel, check_device, count_launch, scratch

# the kernels-line names of the three precisions
KERNEL_NAMES = {"HIGHEST": "qmc_fused", "HIGH": "qmc_fused_hilo",
                "DEFAULT": "qmc_fused_bf16"}
SLAB_COLS = 32           # columns a segment stages (csrc: kSlabCols)
TILE_ROWS = (32, 16, 8, 4, 2, 1)   # the time steps of a tile, largest first
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """A's non-zero pattern as the kernel walks it, int32 tensors on A's
    device.  The time axis runs in tiles of ``R`` rows; a segment is a
    tile, or at R = 1 a piece of at most ``SLAB_COLS`` columns of a row
    with more non-zeros than that.

    segs: (S, 4) per segment (first index into ``cols``, its columns, its
    entries, the end of its pieces); cols: the segments' columns, each
    segment's ascending; pieces: per row (R > 1) or per segment (R = 1),
    in row order, n_entries << 1 | ends_row; entries: (E, 4) = (slot of
    the column among the segment's, row, column, 0) in row order, columns
    ascending within a row."""

    R: int
    slab_cols: int      # the most columns of a segment
    seg_entries: int    # the most entries of a segment
    segs: torch.Tensor
    cols: torch.Tensor
    pieces: torch.Tensor
    entries: torch.Tensor

    def smem_bytes(self, precision: str) -> int:
        """Dynamic shared memory of a block of LANES points: the slab (8
        bytes a column and point) and a segment's entries (8 bytes, 16 at
        HIGH)."""
        entry = 16 if precision == "HIGH" else 8
        return 8 * LANES * self.slab_cols + entry * self.seg_entries


def _tile_mask(nz: torch.Tensor, R: int) -> torch.Tensor:
    """(ceil(N / R), N) bool: the columns each tile of R rows touches."""
    N = nz.shape[0]
    nt = -(-N // R)
    pad = torch.zeros(nt * R - N, N, dtype=torch.bool, device=nz.device)
    return torch.cat([nz, pad]).reshape(nt, R, N).any(1)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def fused_plan(A: torch.Tensor) -> FusedPlan:
    """The plan of A's non-zeros (A float32 (N, N)) for ``csrc/qmc_fused.cu``,
    built with torch ops on A's device.  Every precision's operands are
    zero wherever A is, so one plan serves all three.  R is the largest
    of ``TILE_ROWS`` whose tiles touch at most ``SLAB_COLS`` columns; at
    R = 1 a longer row is cut into pieces of ``SLAB_COLS`` columns."""
    N = A.shape[0]
    dev = A.device
    nz = A != 0
    for R in TILE_ROWS:
        tm = _tile_mask(nz, R)
        tile_cols = tm.sum(1)
        if R == 1 or int(tile_cols.max()) <= SLAB_COLS:
            break
    nt = tm.shape[0]
    # segments: (tile, chunk of SLAB_COLS columns); more than one a tile
    # only at R = 1
    nch = torch.clamp_min(-(-tile_cols // SLAB_COLS), 1)
    seg_base = _exclusive_cumsum(nch)
    S = int(nch.sum())
    ts = torch.repeat_interleave(torch.arange(nt, device=dev), nch)
    cs = torch.arange(S, device=dev) - seg_base[ts]
    col_begin = _exclusive_cumsum(tile_cols)[ts] + cs * SLAB_COLS
    col_count = torch.clamp(tile_cols[ts] - cs * SLAB_COLS, 0, SLAB_COLS)
    cols = tm.nonzero()[:, 1]
    rows_e, cols_e = nz.nonzero(as_tuple=True)
    k = (torch.cumsum(tm, 1) - 1)[rows_e // R, cols_e]
    chunk = k // SLAB_COLS
    seg_e = seg_base[rows_e // R] + chunk
    entry_count = torch.bincount(seg_e, minlength=S)
    if R > 1:
        counts = nz.sum(1)
        ends = torch.ones(N, dtype=torch.int64, device=dev)
        piece_end = torch.clamp_max((ts + 1) * R, N)
    else:
        counts = entry_count
        ends = (cs == nch[ts] - 1).long()
        piece_end = torch.arange(1, S + 1, device=dev)
    E = rows_e.numel()
    if E > _INT32_MAX:
        raise ValueError(f"A has {E} non-zeros: the plan's int32 indices "
                         f"hold at most {_INT32_MAX}")
    entries = torch.stack([k % SLAB_COLS, rows_e, cols_e,
                           torch.zeros_like(k)], 1)
    segs = torch.stack([col_begin, col_count, entry_count, piece_end], 1)
    i32 = torch.int32
    return FusedPlan(
        R=R, slab_cols=int(col_count.max()),
        seg_entries=int(entry_count.max()),
        segs=segs.to(i32).contiguous(), cols=cols.to(i32).contiguous(),
        pieces=(counts * 2 + ends).to(i32).contiguous(),
        entries=entries.to(i32).contiguous())


# id(A) -> (weak reference to A, A's stamp, plan)
_PLANS: dict = {}


def cached_plan(A: torch.Tensor) -> FusedPlan:
    """``fused_plan(A)``, rebuilt only when A is another tensor or has been
    written to since (its version counter, storage, shape or device
    differ); A is held weakly and its entry dropped when it dies.

    A tensor without a version counter (made under ``inference_mode``)
    gets a new plan at every call.  A write that bypasses the counter
    (through ``.data``, DLPack or a raw pointer) is not seen: pass a new
    tensor after such a write, or the stale plan skips A's new non-zeros."""
    try:
        version = A._version
    except RuntimeError:       # inference tensors track no version
        return fused_plan(A)
    key = id(A)
    stamp = (version, A.data_ptr(), tuple(A.shape), A.device)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is A and hit[1] == stamp:
        return hit[2]
    plan = fused_plan(A)
    _PLANS[key] = (weakref.ref(A, lambda _, key=key: _PLANS.pop(key, None)),
                   stamp, plan)
    return plan


def qmc_payoff_sums_fused_cuda(params, z1, z2, A_scaled, n_shifts: int, *,
                               precision: str = "HIGHEST"):
    """Per-replicate (sum payoff, sum payoff^2), float64 (n_shifts,)
    tensors on the normals' device.

    params: float32 (8,) on the CPU, (T, S_0, v_0, r, k, rho, theta,
    sigma); z1, z2: float32 (N, M) contiguous bridge-ordered unit normals
    (``qmc_normals_mxu``), M a multiple of 1024 * n_shifts; A_scaled:
    float32 (N, N) contiguous, sqrt(dt) * ``bb_increment_matrix(N)``, on
    the same device.  Each launch adds one to
    ``qmc_payoff_sums_fused_cuda.launches`` and to
    ``variant_launches[KERNEL_NAMES[precision]]``."""
    N, M = check_fused(params, z1, z2, A_scaled, n_shifts, precision)
    device = check_device(z1.device)
    if device.type == "cpu":
        return qmc_payoff_sums_fused_plain(params, z1, z2, A_scaled,
                                           n_shifts, precision=precision)
    plan = cached_plan(A_scaled)
    ops = [op.contiguous() for op in fused_operands(A_scaled, precision)]
    a_lo = ops[1] if len(ops) > 1 else ops[0]
    n_blocks = M // n_shifts // LANES
    partials, out = scratch(device, 2 * n_shifts * n_blocks, (n_shifts, 2))
    name = KERNEL_NAMES[precision]
    call_kernel("nmch_qmc_fused_sums", name, device, *params.tolist(),
                z1.data_ptr(), z2.data_ptr(), ops[0].data_ptr(),
                a_lo.data_ptr(), N, M, n_shifts, PRECISIONS.index(precision),
                partials.data_ptr(), out.data_ptr(), plan.segs.data_ptr(),
                plan.segs.shape[0], plan.cols.data_ptr(),
                plan.pieces.data_ptr(), plan.entries.data_ptr(),
                plan.slab_cols, plan.seg_entries)
    count_launch(qmc_payoff_sums_fused_cuda, name)
    return out[:, 0], out[:, 1]


qmc_payoff_sums_fused_cuda.launches = 0
qmc_payoff_sums_fused_cuda.variant_launches = {}
