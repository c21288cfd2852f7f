"""MRG32k3a of the PyTorch port against nmch_tpu: the host jump tables and
seed states, the exact modular product, the recurrence words, the
skip-ahead states over (seed, path, epoch) and the uniforms (the
round-to-nearest u32 -> float32 at the edge words and ties), all bitwise;
the FE golden's moments at rel 1e-5 (torch's CPU log is not XLA's bit for
bit, so a path's S_T is not bitwise; the integer states are)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.ops.fe import path_index_grid as j_path_index_grid
from nmch_tpu.ops.fe_mrg import fe_moments_mrg as j_fe_moments
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng import mrg32k3a as jm
from nmch_tpu_torch.ops.fe import path_index_grid
from nmch_tpu_torch.ops.fe_mrg import fe_moments_mrg
from nmch_tpu_torch.rng import mrg32k3a as tm
from nmch_tpu_torch.rng.streams import check_stateful_epoch, \
    stateful_max_epoch

torch.set_num_threads(2)

REL = 1e-5
PATHS = np.array([0, 1, 2, 127, 128, 4095, 12345, 2**20 + 5, 2**31 - 2,
                  2**31 - 1], dtype=np.uint32)
M1 = jm.M1
# 0, m1 - 1, 2^32 - 1, and words whose low 8 bits are 0x80: at or above
# 2^31 a float32 is 256 apart there, so these are ties (to even)
EDGE_WORDS = np.array([0, 1, M1 - 1, M1 - 2, 2**32 - 1, 2**24 - 1, 2**24,
                       2**24 + 1, 2**25 + 2, 0x01000080, 0x12345680,
                       0x7FFFFF80, 0x80000080, 0x80000180, 0xC0000080,
                       0xFFFFFE80, 0xFFFFFF80, 2**31], dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_jump_tables_and_constants_bitwise():
    for a, b in zip(tm._jump_tables(), jm._jump_tables()):
        assert a.shape == (58, 3, 3)
        np.testing.assert_array_equal(a, b)
    assert (tm.M1, tm.M2, tm.A12, tm.A13N, tm.A21, tm.A23N) == \
        (jm.M1, jm.M2, jm.A12, jm.A13N, jm.A21, jm.A23N)
    assert stateful_max_epoch("mrg32k3a") == jm.MAX_EPOCH == 2**27
    with pytest.raises(ValueError, match="not a stateful family"):
        stateful_max_epoch("philox")
    check_stateful_epoch("mrg32k3a", 2**27 - 1)
    with pytest.raises(ValueError, match="epochs per path block"):
        check_stateful_epoch("mrg32k3a", 2**27)


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**64 - 1])
def test_seed_state_bitwise(seed):
    assert tm.seed_state(seed) == jm.seed_state(seed)


@pytest.mark.parametrize("m", [jm.M1, jm.M2])
def test_modmul_is_the_exact_product(m):
    rng = np.random.default_rng(0)
    a = rng.integers(0, m, 4096)
    b = rng.integers(0, m, 4096)
    a[:3], b[:3] = [m - 1, m - 1, 0], [m - 1, 1, m - 1]
    got = tm.modmul(torch.from_numpy(a), torch.from_numpy(b), m).numpy()
    want = [(int(x) * int(y)) % m for x, y in zip(a, b)]
    assert got.tolist() == want
    ja = jnp.asarray(a.astype(np.uint32))
    jb = jnp.asarray(b.astype(np.uint32))
    c = jm._C1 if m == jm.M1 else jm._C2
    np.testing.assert_array_equal(got, _words(jm.modmul(ja, jb, m, c)))


@functools.lru_cache(maxsize=None)
def _jax_state_at(seed):
    return jax.jit(functools.partial(jm.mrg_state_at, seed))


@pytest.mark.parametrize("seed", [1, 1234])
@pytest.mark.parametrize("epoch", [0, 1, 3, 12345, 2**27 - 1])
def test_state_at_bitwise_over_seed_path_epoch(seed, epoch):
    """Every (seed, path, epoch) of the grid, path 2^31 - 1 and epoch
    2^27 - 1 included."""
    j1, j2 = _jax_state_at(seed)(jnp.asarray(PATHS), jnp.uint32(epoch))
    t1, t2 = tm.mrg_state_at(seed, _t(PATHS), epoch)
    for a, b in zip(t1 + t2, j1 + j2):
        np.testing.assert_array_equal(a.numpy(), _words(b))


def test_step_words_bitwise():
    rng = np.random.default_rng(2)
    s1 = rng.integers(0, jm.M1, (3, 4096))
    s2 = rng.integers(0, jm.M2, (3, 4096))
    s1[:, 0], s2[:, 0] = jm.M1 - 1, jm.M2 - 1
    s1[:, 1], s2[:, 1] = 0, 0
    j1 = tuple(jnp.asarray(x.astype(np.uint32)) for x in s1)
    j2 = tuple(jnp.asarray(x.astype(np.uint32)) for x in s2)
    t1, t2 = tuple(_t(x) for x in s1), tuple(_t(x) for x in s2)
    for _ in range(3):
        jz, j1, j2 = jm.mrg_step(j1, j2)
        tz, t1, t2 = tm.mrg_step(t1, t2)
        np.testing.assert_array_equal(tz.numpy(), _words(jz))
    for a, b in zip(t1 + t2, j1 + j2):
        np.testing.assert_array_equal(a.numpy(), _words(b))


def test_u01_from_z_bitwise_at_edge_words_and_ties():
    want = np.asarray(jm.u01_from_z(jnp.asarray(EDGE_WORDS)))
    got = tm.u01_from_z(_t(EDGE_WORDS))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # the conversion is round-to-nearest-even, as a direct cast is
    conv = tm.u32_to_f32(_t(EDGE_WORDS)).numpy()
    np.testing.assert_array_equal(conv, EDGE_WORDS.astype(np.float32))
    assert conv[EDGE_WORDS == 0x80000080][0] == 2.0**31
    assert conv[EDGE_WORDS == 0x80000180][0] == 2.0**31 + 512.0


@functools.lru_cache(maxsize=None)
def _jax_fe():
    return jax.jit(j_fe_moments, static_argnums=(1, 4))


@pytest.mark.parametrize("N,epoch,seed", [(16, 0, 7), (9, 2, 1234)])
def test_fe_golden_moments_match_nmch_tpu(N, epoch, seed):
    p = JHestonParams(k=2.0, theta=0.05, sigma=0.6, rho=0.3, r=0.05,
                      v_0=0.2, T=0.5) if seed == 7 else JHestonParams()
    want = _jax_fe()(p.as_array(), N, j_path_index_grid(1024),
                     jnp.uint32(epoch), seed)
    got = fe_moments_mrg(torch.from_numpy(np.array(p.as_array())), N,
                         path_index_grid(1024), epoch, seed)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= REL * abs(float(w))
