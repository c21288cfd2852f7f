"""The issue-rate probe of the PyTorch port (ops/chain.py, ops/chain_cuda.py,
nmch_tpu_torch/benchmarks/bf16_probe.py) against nmch_tpu's TPU kernel K8
(benchmarks/bf16_probe.py::_chain_kernel) run in interpret mode.

``chain`` takes no ``interpret`` argument and refuses the CPU, so the
test builds the same pallas_call (bf16_probe.py:78-83) with
interpret=True.

What can be held on the CPU: every bf16 variant bitwise at K=4096, and
the float32 chains with a sqrt or rsqrt tail within rel 1e-6 at K=4096
(they contract to a fixed point).  The float32 ALU chain cannot be held
to nmch_tpu past a few iterations: without a square root, abs(x - 1)
stretches differences, so the chain is chaotic, and XLA's CPU compiler
rewrites the chain (not plain FMA contraction): at K=1 only ~28% of the
elements are bitwise equal, at K=4096 none, with rel diffs of order 10.
So the ALU chain is held to nmch_tpu at K=1 within rel 1e-6, and op by
op, bitwise, to a numpy evaluation of the probe's body at K=64."""

import functools
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nmch_tpu_torch.benchmarks import bf16_probe
from nmch_tpu_torch.ops import chain as tc
from nmch_tpu_torch.ops.chain_cuda import CapabilityError, chain_cuda

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_benchmarks_bf16_probe", REPO / "benchmarks" / "bf16_probe.py")
JBP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JBP)

JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
VARIANTS = [("alu", False, False), ("sqrt", True, False),
            ("rsqrt", True, True)]


def tpu_chain(x, *, K: int, with_sqrt: bool, rsqrt: bool):
    """K8 in interpret mode, with chain's specs."""
    kern = functools.partial(JBP._chain_kernel, K=K, with_sqrt=with_sqrt,
                             rsqrt=rsqrt)
    return pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x)


def inputs(dtype: str, rows: int):
    """The probe's uniform(0.5, 1.5) tile in dtype, for both packages."""
    xj = jnp.asarray(np.random.default_rng(0).uniform(0.5, 1.5, (rows, 128)),
                     JDTYPES[dtype])
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))) \
        .to(tc.DTYPES[dtype])
    return xj, xt


def as_f32(a) -> np.ndarray:
    return np.array(a.float() if isinstance(a, torch.Tensor)
                    else a.astype(jnp.float32))


def test_constants_match_the_probe():
    assert (tc.K, tc.OPS, tc.ELEMENT_OPS) == (JBP.K, JBP.OPS, JBP.OPS + 1)
    assert bf16_probe.REPS == JBP.REPS
    assert tc.ROWS == {"f32": 128, "bf16": 256}
    # exactly representable in float32; both round to 1.0 in bf16, as
    # jnp.asarray(c, bfloat16) rounds them in the probe
    assert float(np.float32(tc.C)) == tc.C and float(np.float32(tc.D)) == tc.D
    for v in (tc.C, tc.D):
        assert float(jnp.asarray(v, jnp.bfloat16)) == 1.0
        assert float(torch.tensor(v, dtype=torch.bfloat16)) == 1.0


@pytest.mark.parametrize("tag,with_sqrt,rsqrt", VARIANTS)
def test_bf16_chain_is_bitwise_k8_at_k4096(tag, with_sqrt, rsqrt):
    xj, xt = inputs("bf16", 32)
    want = tpu_chain(xj, K=tc.K, with_sqrt=with_sqrt, rsqrt=rsqrt)
    got = tc.chain_plain(xt, K=tc.K, with_sqrt=with_sqrt, rsqrt=rsqrt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


@pytest.mark.parametrize("tag,rsqrt", [("sqrt", False), ("rsqrt", True)])
def test_f32_root_chains_match_k8_at_k4096(tag, rsqrt):
    xj, xt = inputs("f32", 16)
    want = as_f32(tpu_chain(xj, K=tc.K, with_sqrt=True, rsqrt=rsqrt))
    got = as_f32(tc.chain_plain(xt, K=tc.K, with_sqrt=True, rsqrt=rsqrt))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_f32_alu_chain_matches_k8_at_k1():
    xj, xt = inputs("f32", 16)
    want = as_f32(tpu_chain(xj, K=1, with_sqrt=False, rsqrt=False))
    got = as_f32(tc.chain_plain(xt, K=1, with_sqrt=False))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def numpy_chain(x: np.ndarray, K: int, with_sqrt: bool):
    """The probe's body (bf16_probe.py:53-68) op by op on float32 numpy
    arrays (each op one IEEE rounding), with the abs or sqrt tail; the
    square root in float64, then rounded (a correctly rounded float32
    sqrt)."""
    one, c, d = np.float32(1.0), np.float32(tc.C), np.float32(tc.D)
    for _ in range(K):
        x = x * c
        x = x + d
        x = x * d
        x = np.abs(x - one)
        x = x * c
        x = x + d
        x = x * d
        x = x - one
        if with_sqrt:
            ax = np.abs(x) + one
            x = np.sqrt(ax.astype(np.float64)).astype(np.float32)
        else:
            x = np.abs(x)
    return x


@pytest.mark.parametrize("with_sqrt", [False, True])
def test_f32_chain_is_the_body_op_by_op_at_k64(with_sqrt):
    _, xt = inputs("f32", 16)
    want = numpy_chain(xt.numpy(), 64, with_sqrt)
    got = tc.chain_plain(xt, K=64, with_sqrt=with_sqrt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_chain_cuda_runs_the_plain_version_on_the_cpu():
    _, xt = inputs("bf16", 8)
    before = chain_cuda.launches
    got = chain_cuda(xt, K=3, with_sqrt=True, rsqrt=True)
    assert torch.equal(got, tc.chain_plain(xt, K=3, with_sqrt=True,
                                           rsqrt=True))
    assert chain_cuda.launches == before
    # rsqrt is read only with with_sqrt, as in the probe
    assert torch.equal(chain_cuda(xt, K=3, with_sqrt=False, rsqrt=True),
                       tc.chain_plain(xt, K=3, with_sqrt=False))


@pytest.mark.parametrize("x,K,msg", [
    (torch.ones(4, 64), 1, "shape (rows, 128)"),
    (torch.ones(4, 128, dtype=torch.float16), 1, "float32 or bfloat16"),
    (torch.ones(128, 4).t(), 1, "contiguous"),
    (torch.ones(0, 128), 1, "at least one row"),
    (torch.ones(4, 128), -1, "K=-1 must be in [0, 2^31)"),
])
def test_chain_cuda_refuses_bad_input(x, K, msg):
    with pytest.raises(ValueError, match=re.escape(msg)):
        chain_cuda(x, K=K, with_sqrt=False)


def test_bf16_probe_plain_path_and_keys():
    """collect() over the probe's measure on the CPU at a tiny K: the
    JAX script's keys, each ratio the bf16/f32 ratio of the unrounded
    rates."""
    rates = {}

    def measure(dtype, rows, with_sqrt, rsqrt):
        elops, dt = bf16_probe.measure(dtype, rows, with_sqrt, rsqrt,
                                       device=torch.device("cpu"), K=2,
                                       reps=1)
        rates[dtype, "rsqrt" if rsqrt else "sqrt" if with_sqrt
              else "alu"] = elops
        return elops, dt
    out = bf16_probe.collect(measure, 512)
    for name in ("f32", "bf16"):
        for tag in ("alu", "sqrt", "rsqrt"):
            assert out[f"{name}_{tag}_Gelops"] >= 0
            assert out[f"{name}_{tag}_ms"] > 0
    for tag in ("alu", "sqrt", "rsqrt"):
        assert out[f"ratio_{tag}"] == round(
            rates["bf16", tag] / rates["f32", tag], 3)
    assert len(out) == 15


def test_bf16_probe_ratio_from_rates_that_round_to_zero(monkeypatch):
    """A slow host's rates round to 0.0 Gelops; each ratio still comes
    from the unrounded rates (a stubbed timer: float32 runs take 1e9 ms,
    bf16 runs 2.5e8), and a float32 rate of 0 leaves its ratio out."""
    def timer(fn, device, reps):
        y = fn()
        return y, 1e9 if y.dtype == torch.float32 else 2.5e8
    monkeypatch.setattr(bf16_probe, "timed_blocked", timer)
    out = bf16_probe.collect(functools.partial(
        bf16_probe.measure, device=torch.device("cpu"), K=2, reps=1), 128)
    for tag in ("alu", "sqrt", "rsqrt"):
        assert out[f"f32_{tag}_Gelops"] == out[f"bf16_{tag}_Gelops"] == 0.0
        assert out[f"ratio_{tag}"] == 8.0   # twice the rows, 4x the rate
    out = bf16_probe.collect(lambda dtype, rows, ws, rs: (
        (0.0 if dtype == "f32" else 1e9), 1e-3))
    assert not any(k.startswith("ratio_") for k in out)
    assert out["f32_alu_Gelops"] == 0.0 and out["bf16_alu_Gelops"] == 1.0


def test_bf16_probe_reports_a_refused_variant_as_error():
    """A variant refused for a stated capability becomes *_error and its
    ratio is left out; any other failure propagates."""
    def fake(dtype, rows, with_sqrt, rsqrt):
        if dtype == "bf16" and with_sqrt:
            raise CapabilityError("compute capability 8.0: the chain "
                                  "kernels are built for sm_90a only\nmore")
        return (2e9 if dtype == "bf16" else 1e9) * rows, 1e-3
    out = bf16_probe.collect(fake)
    assert out["bf16_sqrt_error"] == ("compute capability 8.0: the chain "
                                      "kernels are built for sm_90a only")
    assert "bf16_rsqrt_error" in out and "bf16_sqrt_Gelops" not in out
    assert "ratio_sqrt" not in out and "ratio_rsqrt" not in out
    assert out["ratio_alu"] == 4.0      # twice the rows, twice the rate
    assert out["f32_alu_Gelops"] == 128.0

    def broken(*a):
        raise RuntimeError("chain_f32_alu launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        bf16_probe.collect(broken)
