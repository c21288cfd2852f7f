"""The fused QMC bridge + simulator of the PyTorch port (ops/fe_qmc.py's
qmc_payoff_sums_fused_plain, ops/qmc_fused_cuda.py,
nmch_tpu_torch/benchmarks/qmc_fused_probe.py) against nmch_tpu's TPU
kernels K9 (benchmarks/qmc_fused_probe.py::qmc_payoff_sums_fused) and
K10 (::qmc_payoff_sums_fused_hilo), run in interpret mode.

The normals are the port's ``qmc_normals_mxu`` and the bridge matrix its
``bb_increment_matrix`` (both held to nmch_tpu in test_torch_qmc.py), so
both packages get the same inputs.  One JAX call per case and kernel,
shared through a module-scoped fixture."""

import importlib.util
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmch_tpu
from nmch_tpu.ops import fe_qmc as jq
from nmch_tpu_torch import HestonParams
from nmch_tpu_torch.benchmarks import qmc_fused_probe
from nmch_tpu_torch.ops import fe_qmc as tq
from nmch_tpu_torch.ops.qmc_fused_cuda import KERNEL_NAMES, \
    qmc_payoff_sums_fused_cuda

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_benchmarks_qmc_fused_probe",
    REPO / "benchmarks" / "qmc_fused_probe.py")
JQF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JQF)

PV = HestonParams().as_tensor("cpu")
PJ = nmch_tpu.HestonParams().as_array()
CPU = torch.device("cpu")
CASES = [(16, 2048, 2), (64, 1024, 1)]     # (N, points per replicate, R)


def scaled_bridge(N: int) -> np.ndarray:
    """sqrt(dt) * A as the probe's main builds it (qmc_fused_probe.py:
    228-229)."""
    sqrt_dt = np.sqrt(HestonParams().T / N).astype(np.float32)
    return sqrt_dt * tq.bb_increment_matrix(N)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "N%d-n%d-R%d" % c)
def case(request):
    """Inputs of one case and nmch_tpu's per-replicate sums from K9 and
    K10 in interpret mode."""
    N, n, R = request.param
    z1, z2 = tq.qmc_normals_mxu(N, n, 3, 1234, 5, n_shifts=R, device=CPU)
    A = scaled_bridge(N)
    args = (PJ, jnp.asarray(z1.numpy()), jnp.asarray(z2.numpy()),
            jnp.asarray(A), R)
    # DEFAULT is K9 at HIGHEST on the bf16-rounded operands, widened to
    # float32: a product of two bf16 values is exact in float32, so that
    # is one bf16 pass through K9's own body (interpret mode computes
    # precision=DEFAULT in float32 on the CPU, so it cannot be asked for)
    bf16 = [jnp.asarray(tq.hilo_split(torch.from_numpy(np.asarray(x)))[0]
                        .float().numpy()) for x in (z1, z2, A)]
    want = {
        "HIGHEST": JQF.qmc_payoff_sums_fused(*args, interpret=True),
        "HIGH": JQF.qmc_payoff_sums_fused_hilo(*args, interpret=True),
        "DEFAULT": JQF.qmc_payoff_sums_fused(PJ, *bf16, R, interpret=True)}
    want = {k: np.stack([np.asarray(a, np.float64) for a in v])
            for k, v in want.items()}
    return dict(N=N, R=R, z1=z1, z2=z2, A=torch.from_numpy(A), want=want)


@pytest.mark.parametrize("precision", tq.PRECISIONS)
def test_fused_plain_matches_k9_k10_in_interpret_mode(case, precision):
    """Per-replicate sums at rel 1e-5 (the port's CPU rule for moments):
    the port sums in float64, the TPU kernel in float32, and XLA's dot
    takes another order than the kernel's sequential one.  DEFAULT is
    held to K9 on the bf16-rounded operands (see ``case``)."""
    got = torch.stack(tq.qmc_payoff_sums_fused_plain(
        PV, case["z1"], case["z2"], case["A"], case["R"],
        precision=precision)).numpy()
    want = case["want"][precision]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_fused_plain_matches_the_three_stage_pipeline(case):
    """HIGHEST against production's form on the same normals (increments
    by the float32 product, then the plain K6): the two schedules differ
    only in the products' summation order."""
    A, z1, z2 = case["A"], case["z1"], case["z2"]
    prod = torch.stack(tq.qmc_payoff_sums_plain(
        PV, tq._matmul_f32(A, z1), tq._matmul_f32(A, z2), case["R"]))
    fused = torch.stack(tq.qmc_payoff_sums_fused_plain(
        PV, z1, z2, A, case["R"]))
    torch.testing.assert_close(fused, prod, rtol=1e-5, atol=0)


def numpy_increments(A, z, precision):
    """The kernel's increments in numpy float32: per output element a
    sequential multiply-then-add over j (each op one IEEE rounding); HIGH
    as (hh + hl) + lh of the bf16 parts' products."""
    def bf16(x):
        u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32)
    if precision == "HIGHEST":
        terms = [(A, z)]
    else:
        ah, zh = bf16(A), bf16(z)
        terms = [(ah, zh)]
        if precision == "HIGH":
            terms += [(ah, bf16(z - zh)), (bf16(A - ah), zh)]
    parts = []
    for a, zz in terms:
        acc = np.zeros((A.shape[0], z.shape[1]), np.float32)
        for j in range(z.shape[0]):
            acc = acc + a[:, j:j + 1] * zz[j]
        parts.append(acc)
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]) + parts[2]


@pytest.mark.parametrize("precision", tq.PRECISIONS)
def test_fused_plain_is_the_kernel_order_bitwise(precision):
    """Every precision: the sums equal those of the plain K6 driven by a numpy evaluation of
    the kernel's increment order, bitwise; N = 13 has no divisor near
    125, so every step is its own chunk."""
    for N in (13, 16):
        z1, z2 = tq.qmc_normals_mxu(N, 1024, 1, 1234, 0, n_shifts=2,
                                    device=CPU)
        A = scaled_bridge(N)
        d1, d2 = (torch.from_numpy(numpy_increments(A, z.numpy(), precision))
                  for z in (z1, z2))
        want = torch.stack(tq.qmc_payoff_sums_plain(PV, d1, d2, 2))
        got = torch.stack(tq.qmc_payoff_sums_fused_plain(
            PV, z1, z2, torch.from_numpy(A), 2, precision=precision))
        assert torch.equal(got, want), (N, precision)


def test_hilo_split_and_time_chunk_match_nmch_tpu():
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, 3.0e38]
    hi, lo = tq.hilo_split(torch.from_numpy(x))
    jhi, jlo = JQF._hilo_split(jnp.asarray(x))
    for a, b in ((hi, jhi), (lo, jlo)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(),
            np.asarray(b).view(np.int16))
    for N in (1, 7, 16, 64, 101, 125, 126, 250, 997, 1000, 1024):
        assert tq.pick_time_chunk(N) == jq._pick_time_chunk(N)


def test_fused_cuda_runs_the_plain_version_on_the_cpu():
    z1, z2 = tq.qmc_normals_mxu(16, 1024, 1, 1234, 0, device=CPU)
    A = torch.from_numpy(scaled_bridge(16))
    before = qmc_payoff_sums_fused_cuda.launches
    for precision in tq.PRECISIONS:
        got = qmc_payoff_sums_fused_cuda(PV, z1, z2, A, 1,
                                         precision=precision)
        want = tq.qmc_payoff_sums_fused_plain(PV, z1, z2, A, 1,
                                              precision=precision)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[0].dtype == torch.float64 and got[0].shape == (1,)
    assert qmc_payoff_sums_fused_cuda.launches == before
    assert set(KERNEL_NAMES) == set(tq.PRECISIONS)


def _bad(**kw):
    z = torch.zeros(16, 2048)
    args = dict(params=PV, z1=z, z2=z.clone(), A_scaled=torch.zeros(16, 16),
                n_shifts=2, precision="HIGHEST")
    args.update(kw)
    return args


@pytest.mark.parametrize("kw,msg", [
    (dict(n_shifts=4), "M=2048 must be a multiple of 1024*n_shifts"),
    (dict(z1=torch.zeros(16, 1000), z2=torch.zeros(16, 1000), n_shifts=1),
     "M=1000 must be a multiple of 1024*n_shifts"),
    (dict(precision="FAST"), "unknown precision 'FAST'"),
    (dict(A_scaled=torch.zeros(16, 15)), "A_scaled must be a contiguous "
                                         "float32 tensor of shape (16, 16)"),
    (dict(z2=torch.zeros(8, 2048)), "z1 (16, 2048) on cpu and z2 (8, 2048)"),
    (dict(z1=torch.zeros(16, 2048, dtype=torch.float64)), "z1 must be a "
                                                          "contiguous"),
    (dict(params=PV.double()), "params must be a float32 tensor"),
])
def test_fused_refuses_bad_arguments_in_nmch_tpus_words(kw, msg):
    """The M check in qmc_payoff_sums_fused's words (qmc_fused_probe.py:
    150-151, 368-369), and the port's own checks."""
    a = _bad(**kw)
    for fn in (qmc_payoff_sums_fused_cuda, tq.qmc_payoff_sums_fused_plain):
        with pytest.raises(ValueError, match=re.escape(msg)):
            fn(a["params"], a["z1"], a["z2"], a["A_scaled"], a["n_shifts"],
               precision=a["precision"])
    if "M=" in msg:
        z = jnp.zeros(tuple(a["z1"].shape), jnp.float32)
        for jfn in (JQF.qmc_payoff_sums_fused,
                    JQF.qmc_payoff_sums_fused_hilo):
            with pytest.raises(ValueError, match=re.escape(msg)):
                jfn(PJ, z, z, jnp.zeros((16, 16)), a["n_shifts"],
                    interpret=True)


@pytest.mark.parametrize("extra", [[], ["--hilo"], ["--precision", "DEFAULT"]])
def test_probe_cpu_check_agrees(extra, capsys):
    """--cpu at a tiny size: both routes' plain versions, AGREE, the JAX
    script's lines, and one JSON record."""
    rc = qmc_fused_probe.main(["--cpu", "--n", "2048", "--N", "16",
                               "--n-shifts", "2", *extra])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0].startswith("replicate sums prod vs fused: max rel diff ")
    assert out[1].startswith("  prod : [") and out[2].startswith("  fused: [")
    assert out[3] == "AGREE"
    rec = json.loads(out[4])
    assert rec["agree"] and rec["max_rel_diff"] < qmc_fused_probe.AGREE_REL
    assert rec["precision"] == ("HIGH" if extra == ["--hilo"]
                                else extra[1] if extra else "HIGHEST")
    assert len(rec["prod_sums"]) == 2


def test_probe_parser_keeps_the_jax_flags():
    args = qmc_fused_probe.build_parser().parse_args([])
    assert (args.n, args.N, args.n_shifts, args.precision, args.hilo,
            args.cpu) == (1 << 19, 1000, 8, "HIGHEST", False, False)
    with pytest.raises(SystemExit):
        qmc_fused_probe.build_parser().parse_args(["--precision", "FAST"])
