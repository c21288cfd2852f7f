"""XORWOW of the PyTorch port against nmch_tpu: the host jump tables and
seed states, the recurrence words, the skip-ahead states over (seed, path,
epoch) and the uniforms, all bitwise; the FE golden's moments at rel 1e-5
(torch's CPU log is not XLA's bit for bit, so a path's S_T is not bitwise;
the integer states are)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.ops.fe import path_index_grid as j_path_index_grid
from nmch_tpu.ops.fe_xorwow import fe_moments_xorwow as j_fe_moments
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng import bits as jbits
from nmch_tpu.rng import xorwow as jx
from nmch_tpu_torch.ops.fe import path_index_grid
from nmch_tpu_torch.ops.fe_xorwow import fe_moments_xorwow
from nmch_tpu_torch.rng import bits as tbits
from nmch_tpu_torch.rng import normal as tn
from nmch_tpu_torch.rng import xorwow as tx
from nmch_tpu_torch.rng.streams import stateful_max_epoch

torch.set_num_threads(2)

REL = 1e-5
PATHS = np.array([0, 1, 2, 127, 128, 4095, 12345, 2**20 + 5, 2**31 - 2,
                  2**31 - 1], dtype=np.uint32)
EDGE_WORDS = np.array([0, 1, 511, 512, 2**9 * 3 - 1, 2**31 - 1, 2**31,
                       2**32 - 512, 2**32 - 129, 2**32 - 128, 2**32 - 2,
                       2**32 - 1], dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_state_at(seed):
    return jax.jit(functools.partial(jx.xorwow_state_at, seed))


def test_jump_tables_and_constants_bitwise():
    np.testing.assert_array_equal(tx._jump_tables(), jx._jump_tables())
    assert tx._jump_tables().shape == (58, 5, 32, 5)
    assert (tx.WEYL, tx.PATH_LOG2, tx.EPOCH_LOG2, tx.MAX_EPOCH) == \
        (jx.WEYL, jx.PATH_LOG2, jx.EPOCH_LOG2, jx.MAX_EPOCH)
    assert stateful_max_epoch("xorwow") == jx.MAX_EPOCH == 2**27
    assert tx._mat_pow(12345) == jx._mat_pow(12345)


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**40 + 7, 2**64 - 1])
def test_seed_state_and_splitmix64_bitwise(seed):
    assert tx.seed_state(seed) == jx.seed_state(seed)
    assert tbits.splitmix64(seed) == jbits.splitmix64(seed)


def test_u23_to_f32_bitwise():
    x = np.array([0, 1, 2, 12345, 2**22, 2**23 - 1], dtype=np.uint32)
    want = np.asarray(jbits.u23_to_f32(jnp.asarray(x))).view(np.uint32)
    got = tbits.u23_to_f32(_t(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 1234])
@pytest.mark.parametrize("epoch", [0, 1, 3, 12345, 2**27 - 1])
def test_state_at_bitwise_over_seed_path_epoch(seed, epoch):
    """Every (seed, path, epoch) of the grid, path 2^31 - 1 and epoch
    2^27 - 1 included."""
    js, jd = _jax_state_at(seed)(jnp.asarray(PATHS), jnp.uint32(epoch))
    ts, td = tx.xorwow_state_at(seed, _t(PATHS), epoch)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), _words(b))
    np.testing.assert_array_equal(td.numpy(), _words(jd))


def test_state_at_keeps_the_layout_of_path_idx():
    pidx = path_index_grid(256, 384)
    s, d = tx.xorwow_state_at(5, pidx, 2)
    flat, _ = tx.xorwow_state_at(5, pidx.reshape(-1), 2)
    assert s[0].shape == (2, 128) and d.shape == (2, 128)
    assert all(torch.equal(a.reshape(-1), b) for a, b in zip(s, flat))


def test_step_words_bitwise():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (6, 4096), dtype=np.uint64).astype(np.uint32)
    w[:, :len(EDGE_WORDS)] = EDGE_WORDS
    js, jd = tuple(jnp.asarray(x) for x in w[:5]), jnp.asarray(w[5])
    ts, td = tuple(_t(x) for x in w[:5]), _t(w[5])
    for _ in range(3):
        jo, js, jd = jx.xorwow_step(js, jd)
        to, ts, td = tx.xorwow_step(ts, td)
        np.testing.assert_array_equal(to.numpy(), _words(jo))
    for a, b in zip(ts + (td,), js + (jd,)):
        np.testing.assert_array_equal(a.numpy(), _words(b))


def test_u01_from_out_bitwise_at_edge_words_and_open():
    """((o >> 9) + 0.5) 2^-23: strictly inside (0, 1), and not the
    samplers' uniform_open01 (2 - f, in (0, 1])."""
    want = np.asarray(jx.u01_from_out(jnp.asarray(EDGE_WORDS)))
    got = tx.u01_from_out(_t(EDGE_WORDS))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 < got.min().item() and got.max().item() < 1.0
    other = tn.uniform_open01(_t(EDGE_WORDS))
    assert not torch.equal(got, other) and other.max().item() == 1.0


def test_gf2_bit_matrix_matches_the_columns():
    """The float32 GF(2) product reproduces the host column algebra."""
    cols = jx._mat_pow(777)
    mat = torch.from_numpy(tx.table_bit_matrix(tx._columns_to_table(cols)))
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2**32, (5, 64), dtype=np.uint64)
    got = tx.bits_to_words(tx.gf2_apply(mat, tx.words_to_bits(_t(w))))
    for j in range(64):
        want = tx._unpack(tx._mat_vec(cols, tx._pack(w[:, j])))
        assert tuple(got[:, j].tolist()) == want


@functools.lru_cache(maxsize=None)
def _jax_fe():
    return jax.jit(j_fe_moments, static_argnums=(1, 4))


@pytest.mark.parametrize("N,epoch,seed", [(16, 0, 7), (9, 2, 1234)])
def test_fe_golden_moments_match_nmch_tpu(N, epoch, seed):
    p = JHestonParams()
    want = _jax_fe()(p.as_array(), N, j_path_index_grid(1024),
                     jnp.uint32(epoch), seed)
    got = fe_moments_xorwow(torch.from_numpy(np.array(p.as_array())), N,
                            path_index_grid(1024), epoch, seed)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= REL * abs(float(w))
