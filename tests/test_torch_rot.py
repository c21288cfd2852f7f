"""Rotation sampling (rot 2, 4, 8) and the kernel-form plain version of the
PyTorch port against nmch_tpu, and the CUDA kernel's rotation constants.

Tolerances: the step functions run op by op in both packages, so they
agree bitwise (the rot-8 scale aside, whose exp and log are torch's, not
XLA's), and the moments agree with nmch_tpu's own block body run op by
op within rel 1e-6 (measured 1.5e-8 at rot 8).  Against nmch_tpu's
jitted fe_moments_rot_scan, which XLA compiles with contracted
multiply-adds and fused transcendentals (per path not bitwise, as in
tests/test_torch_fe.py), rot 2 and 4 hold rel 1e-5 (measured 1e-6) and
rot 8 rel 2e-4: its radius-antithetic images reach |z| of 4 to 5 on
pairs of small radius, where the reflected variance update cancels, and
the jitted rounding moves the moments by up to 7.2e-5 (measured over 12
seeds at N = 10, 16, 64 and 1024 groups), which op-by-op nmch_tpu does
not.
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

from nmch_tpu.ops import fe as jfe
from nmch_tpu.ops.fe_pallas import fe_moments_pallas
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch import HestonParams
from nmch_tpu_torch.ops import fe as tfe
from nmch_tpu_torch.ops.fe_cuda import fe_moments_cuda
from nmch_tpu_torch.oracle import heston_call_undiscounted
from nmch_tpu_torch.results import SimResult

torch.set_num_threads(2)

N_GROUPS, BASE, EPOCH = 1024, 256, 3
REL = {2: 1e-5, 4: 1e-5, 8: 2e-4}
KERNEL_SRC = (pathlib.Path(__file__).resolve().parents[1]
              / "nmch_tpu_torch" / "csrc" / "fe_path.cuh")
P = JHestonParams()


def _pv() -> torch.Tensor:
    return torch.from_numpy(np.array(P.as_array()))


def _rel(a, b) -> float:
    return max(abs(float(x) - float(y)) / abs(float(y)) for x, y in zip(a, b))


def _pairs(seed: int, n: int = 1 << 14):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    a[:4] = [0.0, 1e-3, 4.5, -0.1]        # t = 0 (floored), tiny, > 10
    b[:4] = [0.0, -2e-3, 0.5, 0.14]       # and near the Taylor switch
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_rot_moments(rng: str, N: int) -> dict:
    """nmch_tpu's fe_moments_rot_scan at rot 2, 4, 8: one jit per (rng, N),
    shared by the cases of this module (6 compiles)."""
    k0, k1 = split_seed(1234)

    def all_rots(pv, pidx, ep):
        return [jfe.fe_moments_rot_scan(pv, N, pidx, ep, k0, k1, rng, r)
                for r in (2, 4, 8)]
    out = jax.jit(all_rots)(P.as_array(), jfe.path_index_grid(N_GROUPS, BASE),
                            jnp.uint32(EPOCH))
    return {r: tuple(float(x) for x in m) for r, m in zip((2, 4, 8), out)}


@pytest.mark.parametrize("rot", [2, 4, 8])
@pytest.mark.parametrize("N", [9, 10])
@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_rot_scan_matches_nmch_tpu(rng, N, rot):
    k0, k1 = split_seed(1234)
    got = tfe.fe_moments_rot_scan(_pv(), N,
                                  tfe.path_index_grid(N_GROUPS, BASE), EPOCH,
                                  k0, k1, rng=rng, rot=rot)
    assert got[0].dtype == torch.float64
    assert _rel(got, _jax_rot_moments(rng, N)[rot]) <= REL[rot]


def _jax_rot_op_by_op(rng: str, N: int, rot: int):
    """nmch_tpu's moments of fe_moments_rot_scan with its fe_rot_block_body
    dispatched op by op in a Python loop (no jit, so no fusion)."""
    k0, k1 = split_seed(1234)
    T, S_0, v_0, r, k, rho, theta, sigma = (jnp.float32(x)
                                            for x in P.as_array())
    dt = T / jnp.float32(N)
    cst = jfe.fe_consts(r, k, theta, sigma, rho,
                        jnp.sqrt(jnp.float32(1.0) - rho * rho), dt,
                        jnp.sqrt(dt))
    pidx = jfe.path_index_grid(N_GROUPS, BASE)
    ones = jnp.full(pidx.shape, 1.0, jnp.float32)
    Ss, vs = [ones * S_0] * rot, [ones * v_0] * rot
    for j in range((N + 1) // 2):
        Ss, vs = jfe.fe_rot_block_body(jnp.uint32(j), Ss, vs, pidx,
                                       jnp.zeros_like(pidx),
                                       jnp.uint32(EPOCH), k0, k1, cst, N,
                                       rot, rng)
    y = jnp.maximum(Ss[0] - S_0, 0.0)
    for S in Ss[1:]:
        y = y + jnp.maximum(S - S_0, 0.0)
    y = np.asarray(y * np.float32(1.0 / rot), np.float64)
    return y.mean(), (y * y).mean()


@pytest.mark.parametrize("rot", [2, 4, 8])
@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_rot_scan_matches_nmch_tpu_block_body_op_by_op(rng, rot):
    k0, k1 = split_seed(1234)
    got = tfe.fe_moments_rot_scan(_pv(), 9,
                                  tfe.path_index_grid(N_GROUPS, BASE), EPOCH,
                                  k0, k1, rng=rng, rot=rot)
    assert _rel(got, _jax_rot_op_by_op(rng, 9, rot)) <= 1e-6


@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_kernel_plain_is_the_scans_bitwise(rng):
    """fe_moments_kernel_plain (the kernel's form, box hc) equals
    fe_moments_rot_scan at rot 2, 4, 8 and fe_moments_scan at rot 1,
    bitwise, for the counter generators; antithetic is rot 2."""
    k0, k1 = split_seed(5)
    pidx = tfe.path_index_grid(256, 128)
    for rot in (1, 2, 4, 8):
        got = tfe.fe_moments_kernel_plain(_pv(), (k0, k1), 4, 128, N=7,
                                          n_paths=256, rng=rng, rot=rot)
        want = (tfe.fe_moments_scan(_pv(), 7, pidx, 4, k0, k1, rng=rng)
                if rot == 1 else
                tfe.fe_moments_rot_scan(_pv(), 7, pidx, 4, k0, k1, rng=rng,
                                        rot=rot))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), rot
    anti = tfe.fe_moments_antithetic_scan(_pv(), 7, pidx, 4, k0, k1, rng=rng)
    assert all(torch.equal(a, b) for a, b in zip(
        anti, tfe.fe_moments_rot_scan(_pv(), 7, pidx, 4, k0, k1, rng=rng,
                                      rot=2)))


def test_rot4_matches_nmch_tpu_pallas_interpret_odd_n():
    """The kernel form against nmch_tpu's K1 in interpret mode at rot 4
    and odd N (the tail masked for every copy), through the wrapper's
    CPU path."""
    k0, k1 = split_seed(7)
    want = fe_moments_pallas(P.as_array(), jnp.stack([k0, k1]),
                             jnp.uint32(2), jnp.uint32(256), N=11,
                             n_paths=1024, rot=4, interpret=True)
    before = fe_moments_cuda.launches
    got = fe_moments_cuda(_pv(), (k0, k1), 2, 256, N=11, n_paths=1024,
                          device="cpu", rot=4)
    assert fe_moments_cuda.launches == before
    assert _rel(got, want) <= 1e-5


def test_rotation_images_exact():
    """The images are exact sign and swap maps of the pair (rot 8: of the
    scaled pair), nmch_tpu's images bitwise at rot 2 and 4."""
    a, b = _pairs(0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for rot in (2, 4):
        want = jfe.rotation_images(jnp.asarray(a), jnp.asarray(b), rot)
        got = tfe.rotation_images(ta, tb, rot)
        assert len(got) == rot
        for (wa, wb), (ga, gb) in zip(want, got):
            np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
            np.testing.assert_array_equal(np.asarray(wb), gb.numpy())
    got = tfe.rotation_images(ta, tb, 8)
    s = tfe.radius_antithetic_scale(ta, tb)
    c, d = s * ta, s * tb
    want = [(ta, tb), (-ta, -tb), (tb, -ta), (-tb, ta),
            (c, d), (-c, -d), (d, -c), (-d, c)]
    for (wa, wb), (ga, gb) in zip(want, got):
        assert torch.equal(wa, ga) and torch.equal(wb, gb)


def test_radius_antithetic_scale_within_2_ulp_and_conditioning():
    """Within 2 ulp of nmch_tpu's scale plus what the exps' difference
    moves it by: torch's CPU exp and log are not XLA's (each within an
    ulp), and between t = 0.01 and 10 the scale takes -ln(1 - e^-t), so a
    difference of up to 2 ulp in e^-t (or 1 ulp in rounding 1 - e^-t)
    moves -ln(1 - e^-t) by that much relative to 1 - e^-t, and s by half
    of it relative to -ln(1 - e^-t) (measured: up to 36 ulp of s at t ~
    4.5, 6 ulp at t ~ 0.02).  The bitwise share is printed."""
    a, b = _pairs(1)
    want = np.asarray(jfe.radius_antithetic_scale(jnp.asarray(a),
                                                  jnp.asarray(b)))
    got = tfe.radius_antithetic_scale(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (got > 0).all()
    t = np.maximum((a.astype(np.float64) ** 2 + b.astype(np.float64) ** 2)
                   / 2, 1e-35)
    main = (t >= 0.01) & (t <= 10)
    t = np.where(main, t, 1.0)
    emt = np.exp(-t)
    em = -np.expm1(-t)
    lg = -np.log1p(-emt)
    d_em = np.maximum(2 * np.spacing(emt.astype(np.float32)),
                      np.spacing(em.astype(np.float32)))
    cond = np.where(main, 0.5 * want * d_em / (em * lg), 0.0)
    bound = 2 * np.spacing(want) + cond
    assert (np.abs(got - want) <= bound).all()
    print("bitwise share", (got.view(np.uint32) == want.view(np.uint32))
          .mean())


def _consts():
    c = jfe.fe_consts(jnp.float32(0.0), jnp.float32(0.5), jnp.float32(0.1),
                      jnp.float32(0.3), jnp.float32(-0.7),
                      jnp.sqrt(jnp.float32(1.0 - 0.49)), jnp.float32(1e-3),
                      jnp.sqrt(jnp.float32(1e-3)))
    return c, tuple(torch.tensor(np.asarray(x)) for x in c)


@pytest.mark.parametrize("fast_sqrt", [False, True])
def test_rot_group_step_bitwise_nmch_tpu_op_by_op(fast_sqrt):
    """fe_rot_group_step, run op by op as nmch_tpu's (not jitted), is
    bitwise its result for every rot, the rot-8 scale given to both.
    fast_sqrt takes rsqrt, whose CPU versions differ by up to 2 ulp
    between torch and XLA (on the card the kernel and torch both call
    libdevice's rsqrtf): there the bar is rel 1e-6."""
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((4, 128)).astype(np.float32)
            for _ in range(2))
    S = (1 + 0.1 * rng.standard_normal((8, 4, 128))).astype(np.float32)
    v = (0.1 * rng.random((8, 4, 128))).astype(np.float32)
    v[0, 0, :4] = 0.0                  # rsqrt's floor
    scale = np.array(jfe.radius_antithetic_scale(jnp.asarray(a),
                                                 jnp.asarray(b)))
    jc, tc = _consts()
    for rot in (1, 2, 4, 8):
        want = jfe.fe_rot_group_step(
            [jnp.asarray(x) for x in S[:rot]],
            [jnp.asarray(x) for x in v[:rot]], jnp.asarray(a),
            jnp.asarray(b), jc, rot, fast_sqrt=fast_sqrt,
            scale=jnp.asarray(scale))
        got = tfe.fe_rot_group_step(
            [torch.from_numpy(x) for x in S[:rot]],
            [torch.from_numpy(x) for x in v[:rot]], torch.from_numpy(a),
            torch.from_numpy(b), tc, rot, fast_sqrt=fast_sqrt,
            scale=torch.from_numpy(scale))
        for w, g in zip(want[0] + want[1], got[0] + got[1]):
            if fast_sqrt:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_rot_group_step_matches_rotation_images_spec():
    """The shared sign/swap algebra equals fe_step mapped over
    rotation_images (tests/test_fe.py:291's spec): bitwise at rot 1, 2,
    4, where the images are exact; rot 8's scaled images round their
    products in another order (nmch_tpu's tolerances)."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal((4, 128))
                             .astype(np.float32)) for _ in range(2))
    _, cst = _consts()
    S0 = torch.full((4, 128), 1.0)
    v0 = torch.full((4, 128), 0.1)
    for rot in (1, 2, 4, 8):
        Ss, vs = tfe.fe_rot_group_step([S0] * rot, [v0] * rot, a, b, cst,
                                       rot)
        for t, (g1, g2) in enumerate(tfe.rotation_images(a, b, rot)):
            S_ref, v_ref = tfe.fe_step(S0, v0, g1, g2, cst)
            if t < 4:
                assert torch.equal(Ss[t], S_ref) and torch.equal(vs[t], v_ref)
            else:
                np.testing.assert_allclose(Ss[t].numpy(), S_ref.numpy(),
                                           rtol=2e-6)
                np.testing.assert_allclose(vs[t].numpy(), v_ref.numpy(),
                                           rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("rot", [4, 8])
def test_group_variance_ratio_above_one(rot):
    """var(X) / (rot var(Y)) > 1: a group of rot coupled copies is worth
    more than rot iid paths (tests/test_fe.py:193,336; measured 1.87 at
    rot 4, 1.48 at rot 8)."""
    k0, k1 = split_seed(1234)
    pv = HestonParams().as_tensor("cpu")
    m, m2 = tfe.fe_moments_rot_scan(pv, 32, tfe.path_index_grid(4096), 0,
                                    k0, k1, rot=rot)
    mi, mi2 = tfe.fe_moments_scan(pv, 32, tfe.path_index_grid(rot * 4096),
                                  0, k0, k1)
    ratio = (float(mi2) - float(mi) ** 2) / (
        rot * (float(m2) - float(m) ** 2))
    assert ratio > 1.0, ratio


@pytest.mark.parametrize("box,fast_sqrt,rot", [
    ("hc", False, 4), ("turns", True, 2), ("hc16", False, 4),
    ("hc16f", True, 4), ("hc16", False, 8), ("hc16f", True, 8)])
def test_device_variants_price_within_oracle_bar(box, fast_sqrt, rot):
    """The device stream has no nmch_tpu oracle (the TPU's bits are its
    hardware's): each variant's plain version is deterministic and
    prices within 3 ci + 2e-3 of the semi-analytic oracle."""
    key = split_seed(1234)
    pv = HestonParams().as_tensor("cpu")
    kw = dict(N=16, n_paths=1024, rng="device", rot=rot, box=box,
              fast_sqrt=fast_sqrt)
    m, m2 = tfe.fe_moments_kernel_plain(pv, key, 0, 0, **kw)
    again = tfe.fe_moments_kernel_plain(pv, key, 0, 0, **kw)
    assert torch.equal(m, again[0]) and torch.equal(m2, again[1])
    res = SimResult(float(m), float(m2), 1024)
    bar = 3 * res.ci_error + 2e-3
    assert abs(res.price - heston_call_undiscounted(HestonParams())) <= bar


def _src_literal(fn, pattern: str) -> np.float32:
    m = re.search(pattern, inspect.getsource(fn))
    assert m, (fn.__name__, pattern)
    return np.float32(eval(m.group(1), {"__builtins__": {}}))


def test_kernel_rotation_constants_match_nmch_tpu():
    """fe_path.cuh's constants of radius_antithetic_scale and fast_sqrt,
    each literal rounded to float32, are nmch_tpu's."""
    src = KERNEL_SRC.read_text()
    got = {n: np.float32(float(v.rstrip("f"))) for n, v in
           re.findall(r"constexpr float (k\w+) = ([^;]+);", src)}
    f = r"np\.float32\(([^)]+)\)"
    ras = jfe.radius_antithetic_scale
    want = {
        "kSixth": _src_literal(ras, rf"\({f}\s*\+ t \* np"),
        "kM24th": _src_literal(ras, rf"\+ t \* {f}\)\)\)"),
        "kTaylorMax": _src_literal(ras, rf"t < {f}"),
        "kAsymptoteMin": _src_literal(ras, rf"t > {f}"),
        "kTFloor": _src_literal(ras, rf"\* np\.float32\(0\.5\), {f}\)"),
        "kLogFloor": _src_literal(ras, rf"jnp\.maximum\(em, {f}\)"),
        "kRsqrtFloor": _src_literal(jfe.fe_rot_group_step,
                                    rf"jnp\.maximum\(vv, {f}\)"),
    }
    for name, w in want.items():
        assert got[name].view(np.uint32) == w.view(np.uint32), name
