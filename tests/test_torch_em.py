"""EM golden and kernel wrapper of the PyTorch port against nmch_tpu.

Per path, the port's plain version and nmch_tpu's jitted scan draw the
same blocks.  Measured on the CPU over every case below (4096 paths x
N=16; philox and threefry4, conditional off and on, cut None, 64 and
128; default, Feller-violating and high-variance parameters):

* final counters equal on 100% of paths;
* payoffs bitwise equal on 92-96% (sampled terminal price) and 6-15%
  (conditional payoff) of paths, since torch's CPU log/exp are not
  XLA's; within rel 1e-4 on >= 99.95% of paths.  The rest (at most 2
  paths of 4096) are paths where a last-bit difference moved a Poisson
  index across an integer without changing the counter;
* moments over the agreeing paths equal to rel 1.0e-7.

The bars: counters, and agreeing paths, on >= 99.9% of paths; moments
at rel 1e-5.
"""

import functools
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.ops import em as jem
from nmch_tpu.ops import sampling as js
from nmch_tpu.ops.em_pallas import em_moments_pallas
from nmch_tpu.ops.fe import path_index_grid as j_path_index_grid
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng import normal as jn
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch.ops import em as tem
from nmch_tpu_torch.ops import sampling as ts
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda, variant_name
from nmch_tpu_torch.ops.fe import path_index_grid

torch.set_num_threads(2)

N_PATHS, N = 4096, 16
SHARE = 0.999
REL = 1e-5
PATH_REL = 1e-4     # a path's payoff, torch's CPU log/exp vs XLA's
PARAMS = [
    JHestonParams(),                                  # PTRS (lam ~ 35)
    JHestonParams(sigma=1.0, theta=0.01, k=1.0),      # Knuth, alpha < 1
    JHestonParams(v_0=0.4, theta=0.4, rho=-0.3),      # lam ~ 140: cut 64
]
EM_SRC = (pathlib.Path(__file__).resolve().parents[1]
          / "nmch_tpu_torch" / "csrc" / "em_path.cuh")
FE_SRC = EM_SRC.with_name("fe_path.cuh")


def _pv(p: JHestonParams) -> torch.Tensor:
    return torch.from_numpy(np.array(p.as_array()))


@functools.lru_cache(maxsize=None)
def _jax_per_path_and_scan(rng, conditional, cut):
    """nmch_tpu's per-path payoffs and final counters (em_path_law /
    em_terminal_core, as em_moments_scan composes them), and its
    em_moments_scan, in one jitted function."""
    def f(pv, pidx, epoch, k0, k1):
        lo = pidx.astype(jnp.uint32)
        hi = jnp.zeros_like(lo)
        scan = jem.em_moments_scan(pv, N, pidx, epoch, k0, k1, rng=rng,
                                   conditional=conditional, poisson_cut=cut)
        if conditional:
            m, s, _, _, ctr = jem.em_path_law(pv, N, lo, hi, epoch, k0, k1,
                                              rng=rng, poisson_cut=cut)
            return jem.em_conditional_payoff(m, s, pv[1]), ctr, scan
        S_T, _, _, ctr = jem.em_terminal_core(pv, N, lo, hi, epoch, k0, k1,
                                              rng=rng, poisson_cut=cut)
        return jnp.maximum(S_T - pv[1], 0.0), ctr, scan
    return jax.jit(f)


def _moments(pay: np.ndarray):
    pay = pay.astype(np.float64)
    return np.array([pay.mean(), (pay * pay).mean()])


@pytest.mark.parametrize("cut", [None, 64.0, 128.0])
@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("rng", ["philox", "threefry4"])
def test_moments_match_nmch_tpu_scan_and_pallas(rng, conditional, cut):
    k0, k1 = split_seed(1234)
    epoch, base = 3, 4096
    jidx = j_path_index_grid(N_PATHS, base)
    for i, p in enumerate(PARAMS):
        pv = p.as_array()
        j_pay, j_ctr, scan = _jax_per_path_and_scan(rng, conditional, cut)(
            pv, jidx, jnp.uint32(epoch), k0, k1)
        j_pay = np.asarray(j_pay).ravel()
        j_ctr = np.asarray(j_ctr).astype(np.int64).ravel()
        t_pay, t_ctr = tem.em_payoffs(_pv(p), N,
                                      path_index_grid(N_PATHS, base), epoch,
                                      k0, k1, rng=rng,
                                      conditional=conditional,
                                      poisson_cut=cut)
        got = np.array([float(x) for x in tem.moments_f64(t_pay)])
        t_pay = t_pay.numpy().ravel()
        same_ctr = t_ctr.numpy().ravel() == j_ctr
        assert same_ctr.mean() >= SHARE
        # a rounding difference can also move a Poisson index across an
        # integer without changing the counter; such a path's payoff then
        # differs by far more than rounding
        agree = same_ctr & (np.abs(t_pay - j_pay)
                            <= PATH_REL * np.abs(j_pay) + 1e-7)
        assert agree.mean() >= SHARE
        np.testing.assert_allclose(_moments(t_pay[agree]),
                                   _moments(j_pay[agree]), rtol=REL)
        if i == 0:       # em_moments_scan is the moments of em_payoffs
            np.testing.assert_array_equal(got, [float(x) for x in (
                tem.em_moments_scan(_pv(p), N, path_index_grid(N_PATHS, base),
                                    epoch, k0, k1, rng=rng,
                                    conditional=conditional,
                                    poisson_cut=cut))])

        # the whole-run moments: nmch_tpu's jitted scan and its Pallas
        # kernel in interpret mode; paths that do not agree may move them
        # by at most their own payoff differences
        slack = _moments(np.abs(t_pay - j_pay) * ~agree) \
            + _moments(np.abs(t_pay + j_pay) * ~agree)
        pallas = em_moments_pallas(
            pv, jnp.stack([jnp.uint32(k0), jnp.uint32(k1)]),
            jnp.uint32(epoch), jnp.uint32(base), N=N, n_paths=N_PATHS,
            rng=rng, conditional=conditional, poisson_cut=cut,
            interpret=True)
        for want in (scan, pallas):
            want = np.array([float(x) for x in want])
            assert (np.abs(got - want) <= REL * np.abs(want) + slack).all()


@pytest.mark.parametrize("pi", [0, 1, 2])
@pytest.mark.parametrize("N_", [1, 16, 1000])
def test_em_consts_bitwise_f32(pi, N_):
    """em_consts rounds each loop constant as nmch_tpu's em_path_law does
    in float32 (the bits both the plain version and the kernel start
    from)."""
    def consts(pv):
        T, S_0, v_0, r, k, rho, theta, sigma = (pv[i] for i in range(8))
        dt = T / jnp.float32(N_)
        exp_kdt = jnp.exp(-k * dt)
        sig2 = sigma * sigma
        one_m = np.float32(1.0) - exp_kdt
        log_s0 = jnp.log(S_0)
        return [v_0, S_0,
                np.float32(2.0) * k * exp_kdt / (sig2 * one_m),
                np.float32(2.0) * k * theta / sig2,
                sig2 * one_m / (np.float32(2.0) * k),
                dt * np.float32(0.5), log_s0, log_s0 + r * T, rho / sigma,
                k * theta * T, k, np.float32(1.0) - rho * rho]
    pv = np.array(PARAMS[pi].replace(S_0=1.3, r=0.05).as_array())
    want = [np.float32(x) for x in jax.jit(consts)(pv)]
    got = tem.em_consts(torch.from_numpy(pv), N_)
    assert len(got) == len(want) + 1
    for name, g, w in zip(tem.EmConsts._fields, got, want):
        assert np.float32(g) == g                     # exactly a float32
        assert np.float32(g).view(np.uint32) == w.view(np.uint32), name


@pytest.mark.parametrize("N_", [1, 16, 1000])
def test_em_consts_table_transcendentals_are_f64_rounded(N_):
    """exp(-k dt) and ln S_0 are float64 results rounded once to float32,
    so the constants do not depend on the host's float32 libm: the whole
    table equals numpy's float32 arithmetic around those two values, over
    4096 random points (no XLA involved)."""
    rs = np.random.default_rng(N_)
    n = 4096
    f32 = np.float32
    T, S_0, v_0, r = (rs.uniform(lo, hi, n).astype(f32) for lo, hi in (
        (0.05, 5.0), (0.2, 5.0), (0.01, 0.5), (-0.05, 0.1)))
    k, rho, theta, sigma = (rs.uniform(lo, hi, n).astype(f32) for lo, hi in (
        (0.05, 8.0), (-0.95, 0.95), (0.005, 0.5), (0.05, 1.5)))
    pm = np.stack([T, S_0, v_0, r, k, rho, theta, sigma], axis=1)
    got = tem.em_consts_table(torch.from_numpy(pm), N_, 128.0).numpy()
    dt = T / f32(N_)
    e = np.exp(-(k * dt).astype(np.float64)).astype(f32)
    log_s0 = np.log(S_0.astype(np.float64)).astype(f32)
    sig2 = sigma * sigma
    one_m = f32(1.0) - e
    want = np.stack([v_0, S_0, f32(2.0) * k * e / (sig2 * one_m),
                     f32(2.0) * k * theta / sig2,
                     sig2 * one_m / (f32(2.0) * k), dt * f32(0.5), log_s0,
                     log_s0 + r * T, rho / sigma, k * theta * T, k,
                     f32(1.0) - rho * rho, np.full(n, f32(128.0))], axis=1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    x = torch.from_numpy(-(k * dt))
    assert torch.equal(tem.exp_f32(x), torch.from_numpy(e))
    assert torch.equal(tem.log_f32(torch.from_numpy(S_0)),
                       torch.from_numpy(log_s0))


def _random_param_rows(seed, n=4096):
    """test_em_consts_table_transcendentals_are_f64_rounded's rows."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    T, S_0, v_0, r = (rs.uniform(lo, hi, n).astype(f32) for lo, hi in (
        (0.05, 5.0), (0.2, 5.0), (0.01, 0.5), (-0.05, 0.1)))
    k, rho, theta, sigma = (rs.uniform(lo, hi, n).astype(f32) for lo, hi in (
        (0.05, 8.0), (-0.95, 0.95), (0.005, 0.5), (0.05, 1.5)))
    return torch.from_numpy(
        np.stack([T, S_0, v_0, r, k, rho, theta, sigma], axis=1))


def _assert_rows_equal(got, want):
    """Bit for bit, a nan matching any nan (its sign is the host's)."""
    got = torch.tensor(list(got), dtype=torch.float32)
    both_nan = got.isnan() & want.isnan()
    same = got.view(torch.int32) == want.view(torch.int32)
    assert (same | both_nan).all(), (got, want)


@pytest.mark.parametrize("cut", [None, 128.0])
@pytest.mark.parametrize("N_", [1, 16, 1000, 2**24 + 1])
def test_em_consts_is_its_table_row_bitwise(N_, cut):
    """The scalar em_consts equals em_consts_table row for row, bit for
    bit, on the 4096 random rows of each of the table's seeds (at N =
    2^24 + 1 the float32 N is 2^24, not N)."""
    pm = torch.cat([_random_param_rows(s) for s in (1, 16, 1000)])
    table = tem.em_consts_table(pm, N_, cut)
    got = torch.tensor([tem.em_consts(row, N_, cut) for row in pm],
                       dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), table.view(torch.int32))


_BASE = [1.0, 1.0, 0.1, 0.0, 0.5, -0.7, 0.1, 0.3]   # T S_0 v_0 r k rho th sig
_EDGES = {                  # index in _BASE -> values that make edge outputs
    7: [1e-20, 1e-23, 1e-30, 1e-45, 0.0, -0.0, 3e38],   # sigma^2 tiny / 0
    4: [1e-30, 1e-45, 0.0, -0.0, -1e5, 3e38],       # 1 - e^{-k dt} is 0
    5: [1.0, -1.0],                                 # 1 - rho^2 is 0
    1: [0.0, -1.0, 1e-45],                          # ln S_0: -inf, nan
    0: [0.0, 1e-45, 3e38],                          # dt: 0, subnormal
    6: [0.0, 3e38],
    2: [float("nan")],
    3: [float("inf"), float("-inf")],
}


def _edge_rows():
    for i, values in _EDGES.items():
        for v in values:
            row = list(_BASE)
            row[i] = v
            yield row


@pytest.mark.parametrize("N_", [1, 1000, 2**30])
@pytest.mark.parametrize("form", ["f32", "f64", "strided", "row"])
def test_em_consts_edge_rows_match_table(N_, form):
    """Rows whose constants are inf, nan, subnormal or zero: em_consts
    raises nowhere and matches the table's bits (any nan for a nan); the
    row given as float64, as a non-contiguous view, or as a (1, 8)."""
    rows = torch.tensor(list(_edge_rows()), dtype=torch.float64)
    table = tem.em_consts_table(rows, N_, 128.0)
    for row, want in zip(rows, table):
        if form == "f32":
            row = row.float()
        elif form == "strided":
            row = torch.stack([row.float(), row.float()], dim=1)[:, 1]
            assert not row.is_contiguous()
        elif form == "row":
            row = row.float().reshape(1, 8)
        _assert_rows_equal(tem.em_consts(row, N_, 128.0), want)
    kinds = (table.isinf().any(), table.isnan().any(),
             ((table != 0) & (table.abs() < 2.0**-126)).any(),
             (table == 0).any())
    assert all(kinds)                           # the edges are reached


def test_em_consts_dispatches_no_arithmetic():
    """em_consts does its arithmetic on Python floats: the only aten
    operators it dispatches convert ``params`` (detach, a copy to float32
    on the CPU, a view of a (1, 8)), whatever the row's form; the table
    it matches dispatches the arithmetic itself."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    pv = torch.tensor(_BASE)
    for row in (pv, pv.double(), torch.stack([pv, pv], 1)[:, 0],
                pv.reshape(1, 8), pv.clone().requires_grad_()):
        with Record() as rec:
            tem.em_consts(row, N, 128.0)
        assert rec.ops <= {"detach", "_to_copy", "view"}, rec.ops
    with Record() as rec:
        tem.em_consts_table(pv.reshape(1, 8), N, 128.0)
    assert {"mul", "div", "exp", "log"} <= rec.ops  # the mode sees arithmetic


def test_poisson_cut_defaults_pinned():
    """None is curand's 4000 at the ops layer (em_consts, em_moments_scan,
    em_moments_cuda, poisson_from_stream) and FAST_POISSON_CUT = 128 at
    the method layer (NMCH_EM, the CLI: tests/test_torch_methods.py and
    test_torch_cli.py), as in nmch_tpu."""
    assert tem.FAST_POISSON_CUT == jem.FAST_POISSON_CUT == 128.0
    assert ts.POISSON_LARGE == js._POISSON_LARGE == 4000.0
    pv = _pv(PARAMS[2])
    assert tem.em_consts(pv, N).poisson_cut == 4000.0
    args = (pv, N, path_index_grid(256), 0, 7, 9)
    none = tem.em_payoffs(*args, poisson_cut=None)
    assert all(torch.equal(a, b) for a, b in
               zip(none, tem.em_payoffs(*args, poisson_cut=4000.0)))
    assert not torch.equal(none[1],
                           tem.em_payoffs(*args, poisson_cut=64.0)[1])
    assert torch.equal(
        torch.stack(em_moments_cuda(pv, (7, 9), 0, 0, N=N, n_paths=256,
                                    device="cpu")),
        torch.stack(tem.moments_f64(none[0])))


@pytest.mark.parametrize("rng,conditional", [("philox", False),
                                             ("threefry4", True)])
def test_wrapper_on_cpu_is_the_plain_version_bitwise(rng, conditional):
    pv = _pv(PARAMS[1])
    key = split_seed(42)
    before = em_moments_cuda.launches
    variants = dict(em_moments_cuda.variant_launches)
    m, m2, pay, ctr = em_moments_cuda(pv, key, 3, 384, N=9, n_paths=512,
                                      device="cpu", rng=rng,
                                      conditional=conditional,
                                      poisson_cut=64.0, per_path=True)
    want = tem.em_moments_scan(pv, 9, path_index_grid(512, 384), 3, *key,
                               rng=rng, conditional=conditional,
                               poisson_cut=64.0)
    assert torch.equal(m, want[0]) and torch.equal(m2, want[1])
    assert m.dtype == torch.float64
    w_pay, w_ctr = tem.em_payoffs(pv, 9, path_index_grid(512, 384), 3, *key,
                                  rng=rng, conditional=conditional,
                                  poisson_cut=64.0)
    assert torch.equal(pay, w_pay) and torch.equal(ctr, w_ctr)
    assert pay.shape == (4, 128) and ctr.dtype == torch.int64
    two = em_moments_cuda(pv, key, 3, 384, N=9, n_paths=512, device="cpu",
                          rng=rng, conditional=conditional, poisson_cut=64.0)
    assert torch.equal(two[0], m) and torch.equal(two[1], m2)
    # no kernel was launched
    assert em_moments_cuda.launches == before
    assert em_moments_cuda.variant_launches == variants
    assert variant_name(rng, conditional) in ("em_philox",
                                              "em_threefry4_cond")


@pytest.mark.parametrize("kwargs,match", [
    ({"params": torch.zeros(8, dtype=torch.float64)}, "float32"),
    ({"params": torch.zeros(7)}, "shape"),
    ({"N": 0}, "N="),
    ({"n_paths": 200}, "multiple of 128"),
    ({"epoch": 2**32}, "uint32"),
    ({"base_path": -1}, "uint32"),
    ({"seed_words": (2**32, 0)}, "uint32"),
    ({"rng": "mrg32k3a"}, "philox"),
    ({"rng": "threefry"}, "threefry4"),
    ({"device": "meta"}, "neither cpu nor cuda"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    args = dict(params=_pv(PARAMS[0]), seed_words=(1, 2), epoch=0,
                base_path=0, N=4, n_paths=128, device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        em_moments_cuda(args.pop("params"), args.pop("seed_words"),
                        args.pop("epoch"), args.pop("base_path"), **args)


def test_terminal_and_norm_cdf_match_nmch_tpu():
    k0, k1 = split_seed(5)
    p = PARAMS[0]
    S_j, v_j = jax.jit(jem.em_terminal, static_argnums=(1,))(
        p.as_array(), 8, j_path_index_grid(512), jnp.uint32(0), k0, k1)
    S_t, v_t = tem.em_terminal(_pv(p), 8, path_index_grid(512), 0, k0, k1)
    for a, b in ((S_j, S_t), (v_j, v_t)):
        a, b = np.asarray(a), b.numpy()
        assert (np.abs(a - b) <= REL * np.abs(a)).mean() >= SHARE
    x = np.linspace(-8, 8, 4097, dtype=np.float32)
    np.testing.assert_allclose(
        tem.norm_cdf_vec(torch.from_numpy(x)).numpy(),
        np.asarray(jem.norm_cdf_vec(jnp.asarray(x))), rtol=0, atol=2e-7)


# --- the kernel's float32 literal table ---------------------------------

def _kernel_constants() -> dict:
    """em_path.cuh's constants and the sincos_2pi constants it takes from
    fe_path.cuh (whose other literals test_torch_normal.py holds)."""
    out = {}
    for src, keep in ((EM_SRC, ("k",)), (FE_SRC, ("kScCos", "kScSin"))):
        for name, lit in re.findall(
                r"constexpr (?:float|int) (k\w+) = ([^;]+);",
                src.read_text()):
            if name.startswith(keep):
                out[name] = np.float32(float(lit.rstrip("f")))
    return out


def _f32_literals(fn, pattern: str):
    """The np.float32(...) arguments that ``pattern`` captures in the
    source of nmch_tpu's ``fn`` (arithmetic of literals evaluated)."""
    m = re.search(pattern, inspect.getsource(fn), re.S)
    assert m, (fn.__name__, pattern)
    return [np.float32(eval(g, {"__builtins__": {}})) for g in m.groups()]


def _nmch_tpu_constants() -> dict:
    f = r"np\.float32\(([^)]+)\)"
    want = {}
    p = js.poisson_from_stream
    want["kPtrsB0"], want["kPtrsB1"] = _f32_literals(
        p, rf"b = {f} \+ {f} \* sqrt_lam")
    want["kPtrsA0"], want["kPtrsA1"] = _f32_literals(p, rf"a = {f} \+ {f} \* b")
    (want["kPtrsInvAlpha0"], want["kPtrsInvAlpha1"],
     want["kPtrsInvAlpha2"]) = _f32_literals(
        p, rf"invalpha = {f} \+ {f} / \(b - {f}\)")
    want["kPtrsVr0"], want["kPtrsVr1"] = _f32_literals(
        p, rf"vr = {f} - {f} / \(b - np\.float32\(2\.0\)\)")
    want["kPtrsK"], = _f32_literals(p, rf"\+ lam\s*\+ {f}\)")
    want["kPtrsUsSqueeze"], = _f32_literals(p, rf"us >= {f}")
    want["kPtrsUsReject"], = _f32_literals(p, rf"us < {f}")
    want["kPoissonSmall"] = np.float32(js._POISSON_SMALL)
    want["kHalfLn2Pi"] = js._HALF_LN_2PI
    (want["kStirling12"], want["kStirling360"],
     want["kStirling1260"]) = _f32_literals(
        js._stirling_corr, rf"c = {f} - i2 \* \({f}\s*- i2 \* {f}\)")
    g = js.gamma_ms_from_stream
    want["kThird"], = _f32_literals(g, rf"d = alpha - {f}")
    want["kMtSqueeze"], = _f32_literals(g, rf"- {f} \* x2 \* x2")
    want["kMtLogFloor"], = _f32_literals(g, rf"jnp\.maximum\(v, {f}\)")
    want["kPoissonMaxRounds"] = np.float32(inspect.signature(
        p).parameters["max_rounds"].default)
    want["kGammaMaxRounds"] = np.float32(inspect.signature(
        g).parameters["max_rounds"].default)
    # sincos_2pi's Horner steps, signs folded into the coefficients
    sc = inspect.getsource(jn.sincos_2pi)
    for prefix, var in (("kScCos", "c"), ("kScSin", "s")):
        first = re.search(rf"{var} = {f}\n", sc).group(1)
        steps = re.findall(rf"{var} = {var} \* r2 ([+-]) {f}", sc)
        vals = [np.float32(first)] + [np.float32(sign + lit)
                                      for sign, lit in steps]
        for i, v in enumerate(vals):
            want[f"{prefix}{i}"] = v
    want["kAsP"] = jem._AS_P
    for i, b in enumerate(jem._AS_B):
        want[f"kAsB{i}"] = b
    want["kInvSqrt2Pi"] = jem._INV_SQRT_2PI
    want["kSigFloor"], = _f32_literals(jem.em_conditional_payoff,
                                       rf"jnp\.maximum\(sig_eff, {f}\)")
    return want


def test_kernel_literal_table_matches_nmch_tpu():
    """em_path.cuh's constants (PTRS, Stirling, Marsaglia–Tsang,
    sincos_2pi, Abramowitz–Stegun), each literal rounded to float32,
    equal the JAX package's: the constant check that runs without
    nvcc."""
    got = _kernel_constants()
    want = _nmch_tpu_constants()
    missing = sorted(set(got) - set(want) - {"kEmConsts", "kScCos4"})
    assert not missing, missing
    assert got["kScCos4"] == np.float32(1.0) == want["kScCos4"]
    assert got["kEmConsts"] == len(tem.EmConsts._fields)
    for name, w in want.items():
        assert np.asarray(got[name], np.float32).view(np.uint32) == \
            np.asarray(w, np.float32).view(np.uint32), name


@pytest.mark.parametrize("rng", ["philox", "threefry4", "xorwow"])
def test_payoffs_both_from_consts_is_each_estimator_bitwise(rng):
    """One law run gives both estimators: at one point, the sampled one is
    ``terminal_from_consts``'s S_T and the conditional one leaves the
    stream where the law ends; at four sweep points on a leading axis, at
    their own epochs, each point's pair is bitwise that point's own
    ``em_payoffs`` (the checks that share a plain run between a variant
    and its conditional twin rely on this)."""
    from nmch_tpu_torch.ops.sweep import _columns
    seed = 1234 if rng == "xorwow" else None
    pidx = path_index_grid(1024, 4096)
    zero = torch.zeros_like(pidx)
    pm = torch.stack([_pv(p) for p in (
        JHestonParams(), JHestonParams(sigma=1.0, theta=0.01, k=1.0),
        JHestonParams(v_0=0.4, theta=0.4), JHestonParams(k=0.1, theta=0.5))])
    c = tem.em_consts(pm[0], N, 128.0)
    both = tem.payoffs_both_from_consts(c, N, pidx, 3, 11, 22, rng, seed)
    S_T, _, _, ctr_t = tem.terminal_from_consts(c, N, pidx, zero, 3, 11, 22,
                                                rng, seed)
    *_, ctr_law = tem.path_law_from_consts(c, N, pidx, zero, 3, 11, 22, rng,
                                           seed)
    assert torch.equal(both[False][0].view(torch.int32),
                       torch.clamp_min(S_T - c.S_0, 0.0).view(torch.int32))
    for got, want in ((both[False][1], ctr_t), (both[True][1], ctr_law)):
        if seed is None:
            assert torch.equal(got, want)
        else:       # the final 6-tuple of state words
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    if seed is not None:
        return
    assert torch.equal(both[False][1], ctr_law + 1)   # one more block
    table = tem.em_consts_table(pm, N, 128.0)
    cols = _columns(table, "cpu")
    epochs = [7, 2, 2**32 - 1, 0]
    sweep = tem.payoffs_both_from_consts(
        tem.EmConsts(*cols[:-1], float(table[0, -1])), N, pidx,
        torch.tensor(epochs).reshape(4, 1, 1), 11, 22, rng)
    for p, ep in enumerate(epochs):
        for cond in (False, True):
            pay, ctr = tem.em_payoffs(pm[p], N, pidx, ep, 11, 22, rng,
                                      cond, 128.0)
            assert torch.equal(pay.view(torch.int32),
                               sweep[cond][0][p].view(torch.int32))
            assert torch.equal(ctr, sweep[cond][1][p])
