"""The reduction probe of the PyTorch port (ops/reduction.py,
ops/reduction_cuda.py, nmch_tpu_torch/benchmarks/reduction_bench.py)
against nmch_tpu's TPU kernel K7 (benchmarks/reduction_bench.py::
_red_kernel) run in interpret mode, and the no-jax rule for every module
of the probes' slice.

``pallas_sum`` takes no ``interpret`` argument and refuses the CPU, so
the test builds the same pallas_call (reduction_bench.py:50-57) with
interpret=True; benchmarks/ is not a package, so the file is loaded by
path."""

import importlib.util
import pathlib
import re
import statistics
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nmch_tpu.ops.fe_pallas import _kahan_add
from nmch_tpu_torch.benchmarks import reduction_bench
from nmch_tpu_torch.ops.reduction import TILE, kahan_add, red_sum_plain, \
    tile_sums_plain
from nmch_tpu_torch.ops.reduction_cuda import red_sum_cuda
from nmch_tpu_torch.utils.timing import timed_blocked

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_benchmark(name: str):
    """A script of the repository's benchmarks/ folder, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JRB = load_benchmark("reduction_bench")


def tpu_sum(x: np.ndarray) -> np.float32:
    """K7 in interpret mode, with pallas_sum's specs."""
    rows = x.shape[0]
    return np.float32(pl.pallas_call(
        JRB._red_kernel,
        grid=(rows // JRB.TILE,),
        in_specs=[pl.BlockSpec((JRB.TILE, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.SMEM((1,), jnp.float32)],
        interpret=True,
    )(jnp.asarray(x))[0, 0])


def test_tile_and_limits_match_nmch_tpu():
    assert TILE == JRB.TILE == 512
    assert reduction_bench.SIZES == (102_400_000, 1_024_000_000)
    assert [reduction_bench.rows_for(n) for n in reduction_bench.SIZES] \
        == [799_744, 8_000_000]


def test_kahan_add_is_nmch_tpus_four_ops():
    """kahan_add on float32 scalars equals _kahan_add on refs, bitwise,
    along a sequence whose compensation matters."""
    vals = np.random.default_rng(0).uniform(-1, 1, 200).astype(np.float32)
    vals[::7] *= np.float32(1e7)
    acc = comp = np.float32(0.0)
    sum_ref = np.zeros((1, 1), np.float32)
    comp_ref = np.zeros(1, np.float32)
    for v in vals:
        acc, comp = kahan_add(acc, comp, v)
        _kahan_add(sum_ref, comp_ref, 0, v)
        assert acc.view(np.uint32) == sum_ref[0, 0].view(np.uint32)
        assert comp.view(np.uint32) == comp_ref[0].view(np.uint32)


@pytest.mark.parametrize("tiles", [4, 7])
def test_red_sum_plain_matches_k7_in_interpret_mode(tiles):
    """Constant data: bitwise (every partial exact). Uniform data: rel
    1e-6, since the tile tree's order differs from XLA's jnp.sum."""
    rows = tiles * TILE
    const = np.full((rows, 128), 0.5, np.float32)
    got = red_sum_plain(torch.from_numpy(const)).numpy()
    assert got.view(np.uint32) == tpu_sum(const).view(np.uint32)
    assert float(got) == rows * 128 / 2
    x = np.random.default_rng(tiles).uniform(0, 1, (rows, 128)) \
        .astype(np.float32)
    got = float(red_sum_plain(torch.from_numpy(x)))
    want = float(tpu_sum(x))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert abs(got - x.astype(np.float64).sum()) <= 1e-6 * abs(want)


def test_red_sum_plain_matches_k7_on_cancelling_tiles():
    """Tile sums alternating near +1e6 and -1e6 (every element of tile t
    is (-1)^t 1e6 / 65536 plus a small multiple of 1/16, so each tile sum
    is exact in any order), which the Kahan chain across the tiles must
    add with the compensation: rel 1e-6 of K7 in interpret mode and of
    the float64 sum."""
    tiles = 6
    small = np.random.default_rng(3).integers(-8, 8, (tiles, TILE * 128))
    sign = np.where(np.arange(tiles) % 2, -1.0, 1.0)[:, None]
    x = (sign * (1e6 / 65536) + small / 16).astype(np.float32) \
        .reshape(tiles * TILE, 128)
    got = float(red_sum_plain(torch.from_numpy(x)))
    want = float(tpu_sum(x))
    exact = x.astype(np.float64).sum()
    assert abs(exact) > 1e3
    assert abs(got - want) <= 1e-6 * abs(want)
    assert abs(got - exact) <= 1e-6 * abs(exact)


def test_tile_sums_take_every_element_once():
    """Small integers sum exactly in any order: each tile sum is the
    exact one, so the kernel's order covers each element once."""
    x = np.random.default_rng(1).integers(0, 8, (3 * TILE, 128)) \
        .astype(np.float32)
    got = tile_sums_plain(torch.from_numpy(x)).numpy()
    want = x.reshape(3, -1).astype(np.int64).sum(1)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    one_hot = np.zeros((TILE, 128), np.float32)
    one_hot[317, 45] = 3.0
    assert float(tile_sums_plain(torch.from_numpy(one_hot))[0]) == 3.0


def test_red_sum_cuda_runs_the_plain_version_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2 * TILE, 128)).astype(np.float32))
    before = red_sum_cuda.launches
    assert torch.equal(red_sum_cuda(x), red_sum_plain(x))
    assert red_sum_cuda.launches == before


@pytest.mark.parametrize("x,msg", [
    (torch.zeros(512, 64), "shape (rows, 128)"),
    (torch.zeros(512, 128, dtype=torch.float64), "float32"),
    (torch.zeros(128, 512).t(), "contiguous"),
    (torch.zeros(500, 128), "rows=500 must be a positive multiple of "
                            "TILE=512"),
    (torch.zeros(0, 128), "rows=0"),
])
def test_red_sum_cuda_refuses_bad_input(x, msg):
    with pytest.raises(ValueError, match=re.escape(msg)):
        red_sum_cuda(x)


def test_reduction_bench_plain_path_sums_to_n_over_2():
    """The probe's measure on the CPU at two tiles: both routes, sum n/2,
    each timed in its turns and given their median."""
    recs = reduction_bench.measure(2 * TILE * 128, torch.device("cpu"),
                                   reps=1)
    assert [r["name"] for r in recs] == ["cuda+kahan", "torch.sum"]
    for r in recs:
        assert r["n"] == 2 * TILE * 128 and r["sum"] == r["n"] / 2
        assert r["ms"] > 0 and r["gbytes_per_s"] > 0
        assert len(r["ms_turns"]) == 2 * reduction_bench.TURNS
        assert r["ms"] == statistics.median(r["ms_turns"])


def test_timed_blocked_warms_up_then_times_the_queued_runs():
    calls = []
    out, ms = timed_blocked(lambda: calls.append(1) or len(calls), "cpu", 3)
    assert out == 4 and len(calls) == 4 and ms >= 0
    with pytest.raises(ValueError, match="reps=0"):
        timed_blocked(lambda: None, "cpu", 0)


def test_probes_refuse_to_run_without_a_card(monkeypatch):
    """The entry points run on the card only: without one, main raises
    (qmc_fused_probe runs on the CPU only with --cpu)."""
    from nmch_tpu_torch.benchmarks import bf16_probe, qmc_fused_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (reduction_bench.main, qmc_fused_probe.main,
                 bf16_probe.main):
        with pytest.raises(RuntimeError, match="is_available"):
            main([])


PROBE_MODULES = (
    "nmch_tpu_torch/benchmarks/__init__.py",
    "nmch_tpu_torch/benchmarks/reduction_bench.py",
    "nmch_tpu_torch/benchmarks/qmc_fused_probe.py",
    "nmch_tpu_torch/benchmarks/bf16_probe.py",
    "nmch_tpu_torch/ops/reduction.py",
    "nmch_tpu_torch/ops/reduction_cuda.py",
    "nmch_tpu_torch/ops/chain.py",
    "nmch_tpu_torch/ops/chain_cuda.py",
    "nmch_tpu_torch/ops/qmc_fused_cuda.py",
    "nmch_tpu_torch/ops/fe_qmc.py",
    "nmch_tpu_torch/utils/timing.py",
    "chip_smoke.py",
)
_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|nmch_tpu)\b(?!_torch)"
                        r"|from\s+(jax|nmch_tpu)\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", PROBE_MODULES)
def test_probe_modules_import_neither_jax_nor_nmch_tpu(path):
    """A grep of each module's source for an import of jax or nmch_tpu."""
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(src), path


def test_probe_modules_import_without_jax():
    mods = ", ".join(p[:-3].replace("/", ".").removesuffix(".__init__")
                     for p in PROBE_MODULES if p != "chip_smoke.py")
    code = (f"import sys, {mods}; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'nmch_tpu' not in sys.modules, 'nmch_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)
