"""Normals of the PyTorch port against nmch_tpu's (hc bitwise; the
packed hc16/hc16f blocks, the fast polynomials and with_scale within 1
ulp; turns within 2), and the CUDA kernel's float32 literal table
against nmch_tpu's constants."""

import inspect
import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nmch_tpu.rng import normal as jn
from nmch_tpu_torch.rng import normal as tn

torch.set_num_threads(2)

EDGE_WORDS = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
KERNEL_SRC = (pathlib.Path(__file__).resolve().parents[1]
              / "nmch_tpu_torch" / "csrc" / "fe_path.cuh")


def _words(seed: int, n: int = 1 << 14) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    # every edge word in every slot, against every other edge word
    grid = np.stack(np.meshgrid(*[EDGE_WORDS] * 4, indexing="ij")).reshape(4, -1)
    w[:, :grid.shape[1]] = grid
    return w


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_normal4_from_bits_bitwise(seed):
    w = _words(seed)
    want = jn.normal4_from_bits(*(jnp.asarray(x) for x in w))
    got = tn.normal4_from_bits(*(torch.from_numpy(x.astype(np.int64))
                                 for x in w))
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_uniform_and_neg2log_bitwise():
    w = _words(2)[0]
    u_j = jn.uniform_open01(jnp.asarray(w))
    u_t = tn.uniform_open01(torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(_bits(u_j), _bits(u_t.numpy()))
    np.testing.assert_array_equal(_bits(jn.neg2log(u_j)),
                                  _bits(tn.neg2log(u_t).numpy()))


def test_uniform_halfopen01_and_sincos_2pi_bitwise():
    w = _words(4)[0]
    u_j = jn.uniform_halfopen01(jnp.asarray(w))
    u_t = tn.uniform_halfopen01(torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(_bits(u_j), _bits(u_t.numpy()))
    assert float(u_t.min()) == 0.0 and float(u_t.max()) < 1.0
    # the turns phase of boxmuller is an open-(0, 1] uniform
    u = np.concatenate([np.asarray(jn.uniform_open01(jnp.asarray(w))),
                        np.asarray(u_j),
                        np.arange(9, dtype=np.float32) / 8])
    for a, b in zip(jn.sincos_2pi(jnp.asarray(u)),
                    tn.sincos_2pi(torch.from_numpy(u))):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_boxmuller_within_2_ulp():
    """boxmuller's log is torch's (not XLA's) on the CPU, so its radius
    may round differently; both outputs stay within 2 ulp."""
    w = _words(5)
    u1j, u2j = (jn.uniform_open01(jnp.asarray(x)) for x in w[:2])
    u1t, u2t = (tn.uniform_open01(torch.from_numpy(x.astype(np.int64)))
                for x in w[:2])
    for a, b in zip(jn.boxmuller(u1j, u2j), tn.boxmuller(u1t, u2t)):
        a = np.asarray(a, np.float32)
        b = b.numpy()
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a - b) <= 2 * ulp).all()


def _assert_within_ulp(want, got, n_ulp: int):
    a = np.asarray(want, np.float32)
    b = got.numpy()
    assert b.dtype == np.float32 and np.isfinite(b).all()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= n_ulp * ulp).all()
    return (a.view(np.uint32) == b.view(np.uint32)).mean()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_normal4_from_bits3_within_1_ulp(fast, with_scale):
    """The device generator's packed 3-word blocks (boxes hc16/hc16f):
    four normals, and each pair's radius-antithetic scale, within 1 ulp
    of nmch_tpu's (measured: bitwise)."""
    w = _words(6)[:3]
    want = jn.normal4_from_bits3(*(jnp.asarray(x) for x in w), fast=fast,
                                 with_scale=with_scale)
    got = tn.normal4_from_bits3(*(torch.from_numpy(x.astype(np.int64))
                                  for x in w), fast=fast,
                                with_scale=with_scale)
    assert len(got) == len(want) == (6 if with_scale else 4)
    shares = [_assert_within_ulp(a, b, 1) for a, b in zip(want, got)]
    print("bitwise shares", shares)


@pytest.mark.parametrize("fast", [False, True])
def test_neg2log_and_halfcircle_pair_within_1_ulp(fast):
    """neg2log's fast polynomial and _halfcircle_pair's fast and
    with_scale paths, within 1 ulp of nmch_tpu's (measured: bitwise)."""
    w = _words(7)
    u_j = jn.uniform_open01(jnp.asarray(w[0]))
    u_t = tn.uniform_open01(torch.from_numpy(w[0].astype(np.int64)))
    _assert_within_ulp(jn.neg2log(u_j, fast=fast), tn.neg2log(u_t, fast=fast),
                       1)
    f = (w[1] & 0x007FFFFF) | 0x3F800000
    sign = w[2] & 0x80000000
    want = jn._halfcircle_pair(jnp.asarray(w[0]),
                               jnp.asarray(f).view(jnp.float32),
                               jnp.asarray(sign), fast=fast, with_scale=True)
    got = tn._halfcircle_pair(torch.from_numpy(w[0].astype(np.int64)),
                              tn.f32_from_u32(torch.from_numpy(
                                  f.astype(np.int64))),
                              torch.from_numpy(sign.astype(np.int64)),
                              fast=fast, with_scale=True)
    for a, b in zip(want, got):
        _assert_within_ulp(a, b, 1)


def test_turns_box_within_2_ulp():
    """normal4_from_bits(box="turns"): boxmuller on each pair, its log
    torch's on the CPU (not XLA's), so within 2 ulp."""
    w = _words(8)
    want = jn.normal4_from_bits(*(jnp.asarray(x) for x in w), box="turns")
    got = tn.normal4_from_bits(*(torch.from_numpy(x.astype(np.int64))
                                 for x in w), box="turns")
    for a, b in zip(want, got):
        _assert_within_ulp(a, b, 2)


def test_sqrt_f32_correctly_rounded():
    x = np.random.default_rng(3).random(1 << 14, dtype=np.float32) * 40
    np.testing.assert_array_equal(
        _bits(np.sqrt(x)), _bits(tn.sqrt_f32(torch.from_numpy(x)).numpy()))


def test_bitcasts_roundtrip_all_sign_classes():
    w = np.concatenate([EDGE_WORDS, np.array([0x3F800000, 0xBF800000],
                                             np.uint32)])
    t = torch.from_numpy(w.astype(np.int64))
    f = tn.f32_from_u32(t)
    np.testing.assert_array_equal(_bits(f.numpy()), w)
    assert torch.equal(tn.u32_from_f32(f), t)


def test_other_boxes_refused():
    """normal4_from_bits takes hc and turns, as nmch_tpu's does; the
    packed boxes have their own 3-word function."""
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown box 'hc16'"):
        tn.normal4_from_bits(z, z, z, z, box="hc16")


def _f32_literals(fn, pattern: str) -> tuple:
    """The float32 values of the literals ``pattern`` captures in the
    source of nmch_tpu's ``fn``."""
    m = re.search(pattern, inspect.getsource(fn))
    assert m, (fn.__name__, pattern)
    return tuple(np.float32(eval(g, {"__builtins__": {}})) for g in m.groups())


def _kernel_literals() -> dict:
    src = KERNEL_SRC.read_text()
    out = {}
    for name in ("kSinHc", "kCosHc", "kNeg2Log", "kNeg2Ln2", "kC254Ln2",
                 "kPi", "kPi1p5", "kMagic", "kSinF", "kCosF", "kNeg2LogF",
                 "kScaleFloor"):
        m = re.search(rf"\b{name}\b(?:\[\d+\])?\s*=\s*(\{{[^}}]*\}}|[^;]+);",
                      src)
        assert m, f"{name} not found in {KERNEL_SRC.name}"
        lits = re.findall(r"[-+]?[0-9.]+(?:e[-+]?\d+)?f", m.group(1))
        out[name] = [np.float32(float(x[:-1])) for x in lits]
    return out


def test_kernel_literal_table_matches_nmch_tpu():
    """The kernel's constants, each literal rounded to float32, equal the
    JAX package's (the constant check that runs without nvcc)."""
    lit = _kernel_literals()
    want = {
        "kSinHc": jn._SIN_HC, "kCosHc": jn._COS_HC, "kNeg2Log": jn._NEG2LOG,
        "kNeg2Ln2": (jn._NEG2LN2,), "kC254Ln2": (jn._C254LN2,),
        "kPi": (np.float32(np.pi),), "kPi1p5": (np.float32(1.5 * np.pi),),
        "kMagic": (np.float32(12582912.0),),
        "kSinF": jn._SIN_F, "kCosF": jn._COS_F, "kNeg2LogF": jn._NEG2LOG_F,
        "kScaleFloor": _f32_literals(
            jn._halfcircle_pair, r"jnp\.maximum\(q, np\.float32\(([^)]+)\)"),
    }
    for name, vals in want.items():
        assert len(lit[name]) == len(vals), name
        np.testing.assert_array_equal(_bits(lit[name]), _bits(vals),
                                      err_msg=name)
