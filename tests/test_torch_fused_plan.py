"""The plan of the bridge matrix's non-zeros that the fused QMC kernel walks
(nmch_tpu_torch/ops/qmc_fused_cuda.py::fused_plan, csrc/qmc_fused.cu).

The kernel sums each increment over A's non-zeros only.  These tests pin
the plan of the port's ``bb_increment_matrix`` (held to nmch_tpu's in
test_torch_qmc.py), check that it holds every operand of every precision
exactly, and run a torch emulation of the kernel's sparse walk, op by op
in the plan's order, against the dense ``_fused_increments`` that the
plain version (and so nmch_tpu's K9/K10, test_torch_qmc_fused.py) uses:
bitwise, on the bridge and on a dense random A, which shows on the CPU
that skipping A's zeros leaves every float32 sum as it is."""

import numpy as np
import pytest
import torch

from nmch_tpu_torch.ops import fe_qmc as tq
from nmch_tpu_torch.ops.qmc_fused_cuda import SLAB_COLS, _PLANS, \
    cached_plan, fused_plan

torch.set_num_threads(2)

CPU = torch.device("cpu")


def scaled_bridge(N: int) -> torch.Tensor:
    sqrt_dt = np.sqrt(1.0 / N).astype(np.float32)
    return torch.from_numpy(sqrt_dt * tq.bb_increment_matrix(N))


def dense_random(N: int, seed: int = 5) -> torch.Tensor:
    g = np.random.default_rng(seed).standard_normal((N, N))
    return torch.from_numpy((g / N).astype(np.float32))


def segments(plan):
    """(columns, entries, pieces) of each segment, as Python lists."""
    e0 = p0 = 0
    for c0, cn, en, pend in plan.segs.tolist():
        yield (plan.cols[c0:c0 + cn].tolist(),
               plan.entries[e0:e0 + en].tolist(),
               plan.pieces[p0:pend].tolist())
        e0 += en
        p0 = pend


def sparse_walk(plan, a_ops, z: torch.Tensor, precision: str):
    """The kernel's increments (N, M), emulated: per segment the slab of z
    at its columns (split into bf16 hi/lo where the precision needs it),
    then each row's entries in order, one float32 product and add per
    operand pair, and the row's increment where its last piece ends."""
    N, M = z.shape
    if precision == "HIGHEST":
        z_hi, z_lo = z, None
    else:
        z_hi, z_lo = (t.float() for t in tq.hilo_split(z))
    terms = 3 if precision == "HIGH" else 1
    out = torch.empty(N, M)
    acc = [torch.zeros(M) for _ in range(terms)]
    row = 0
    for cols, entries, pieces in segments(plan):
        hi = z_hi[cols]
        lo = z_lo[cols] if precision == "HIGH" else None
        e = 0
        for hdr in pieces:
            for slot, r, c, _ in entries[e:e + (hdr >> 1)]:
                assert r == row
                a = a_ops[0][r, c]
                acc[0] = acc[0] + a * hi[slot]
                if precision == "HIGH":
                    acc[1] = acc[1] + a * lo[slot]
                    acc[2] = acc[2] + a_ops[1][r, c] * hi[slot]
            e += hdr >> 1
            if hdr & 1:
                out[row] = acc[0] if terms == 1 \
                    else (acc[0] + acc[1]) + acc[2]
                acc = [torch.zeros(M) for _ in range(terms)]
                row += 1
    assert row == N
    return out


@pytest.mark.parametrize("N,nnz,R", [(16, 80, 32), (101, 781, 16),
                                     (200, 1744, 16), (1000, 10976, 16)])
def test_bridge_plan_pins_the_nonzeros(N, nnz, R):
    """10,976 non-zeros at N = 1000 (10 or 11 a row), 1,744 at 200; every
    tile stages at most SLAB_COLS columns; rows in order, each row's
    columns ascending, each entry's slot naming its column."""
    A = scaled_bridge(N)
    plan = fused_plan(A)
    assert plan.entries.shape == (nnz, 4) and plan.R == R
    assert plan.slab_cols <= SLAB_COLS
    assert int(plan.pieces.sum()) == 2 * nnz + N   # every row ends
    assert plan.pieces.numel() == N and plan.segs.shape[0] == -(-N // R)
    rows = plan.entries[:, 1]
    assert bool((rows[1:] >= rows[:-1]).all())
    key = plan.entries[:, 1].long() * N + plan.entries[:, 2].long()
    assert bool((key[1:] > key[:-1]).all())
    for cols, entries, _ in segments(plan):
        assert cols == sorted(set(cols))
        assert all(cols[slot] == c for slot, _, c, _ in entries)
    if N == 1000:
        per_row = torch.bincount(rows.long(), minlength=N)
        assert int(per_row.min()) == 10 and int(per_row.max()) == 11


@pytest.mark.parametrize("which", ["bridge", "dense"])
def test_plan_scatters_back_to_every_operand(which):
    """Scattering A's operands back at the plan's (row, column) gives each
    precision's operands exactly: the plan misses no non-zero of any."""
    A = scaled_bridge(101) if which == "bridge" else dense_random(101)
    plan = fused_plan(A)
    r, c = plan.entries[:, 1].long(), plan.entries[:, 2].long()
    for precision in tq.PRECISIONS:
        for op in tq.fused_operands(A, precision):
            back = torch.zeros_like(op)
            back[r, c] = op[r, c]
            assert torch.equal(back.view(torch.int32),
                               op.view(torch.int32))


def test_dense_rows_are_cut_into_pieces():
    """A dense A at N = 101: R = 1, each row in pieces of 32, 32, 32 and 5
    columns, only the last ending the row."""
    plan = fused_plan(dense_random(101))
    assert plan.R == 1 and plan.slab_cols == SLAB_COLS
    assert plan.segs.shape[0] == 4 * 101
    assert plan.pieces[:4].tolist() == [64, 64, 64, 11]
    assert plan.segs[:4, 1].tolist() == [32, 32, 32, 5]
    assert plan.seg_entries == SLAB_COLS


@pytest.mark.parametrize("precision", tq.PRECISIONS)
@pytest.mark.parametrize("which", ["bridge", "dense"])
def test_sparse_walk_is_bitwise_the_dense_increments(which, precision):
    """The emulated walk equals ``_fused_increments`` bitwise at N = 101 on
    ``qmc_normals_mxu``'s normals (64 points)."""
    A = scaled_bridge(101) if which == "bridge" else dense_random(101)
    z, _ = tq.qmc_normals_mxu(101, 32, 1, 1234, 5, n_shifts=2, device=CPU)
    a_ops = tq.fused_operands(A, precision)
    want = tq._fused_increments(a_ops, z, slice(0, 101), precision)
    got = sparse_walk(fused_plan(A), a_ops, z, precision)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_zero_matrix_plan_steps_every_row_with_zero():
    A = torch.zeros(7, 7)
    plan = fused_plan(A)
    assert plan.entries.shape == (0, 4) and plan.slab_cols == 0
    assert plan.pieces.tolist() == [1] * 7
    z = torch.randn(7, 16, generator=torch.Generator().manual_seed(0))
    for precision in tq.PRECISIONS:
        a_ops = tq.fused_operands(A, precision)
        got = sparse_walk(plan, a_ops, z, precision)
        want = tq._fused_increments(a_ops, z, slice(0, 7), precision)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_plan_cache_follows_the_tensor_and_its_writes():
    """One plan while A is unchanged; a write to A (its version counter)
    or another tensor builds a new one."""
    A = scaled_bridge(16)
    assert A[0, 15] == 0
    first = cached_plan(A)
    assert cached_plan(A) is first
    assert cached_plan(A.clone()) is not first
    A[0, 15] = 1.0             # a zero of the bridge becomes a non-zero
    again = cached_plan(A)
    assert again is not first
    assert again.entries.shape[0] == first.entries.shape[0] + 1


def test_plan_of_an_inference_tensor_is_built_every_call():
    """A tensor made under inference_mode has no version counter: the
    cache builds its plan anew each call and keeps nothing of it."""
    with torch.inference_mode():
        A = scaled_bridge(16) + 0.0
    before = len(_PLANS)
    first = cached_plan(A)
    assert cached_plan(A) is not first and len(_PLANS) == before
    want = fused_plan(A)
    for got, ref in zip((first.segs, first.cols, first.pieces,
                         first.entries),
                        (want.segs, want.cols, want.pieces, want.entries)):
        assert torch.equal(got, ref)
