"""Philox4x32-10 of the PyTorch port, bitwise against nmch_tpu's."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nmch_tpu.rng import philox as jp
from nmch_tpu_torch.rng import philox as tp

torch.set_num_threads(2)

EDGES = np.array([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF], np.uint64)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mulhilo32_edges():
    a, b = (x.ravel() for x in np.meshgrid(EDGES, EDGES))
    hi, lo = tp.mulhilo32(_t(a), _t(b))
    exact = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in exact]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in exact]
    jhi, jlo = jp.mulhilo32(jnp.asarray(a.astype(np.uint32)),
                            jnp.asarray(b.astype(np.uint32)))
    assert hi.tolist() == np.asarray(jhi).astype(np.int64).tolist()
    assert lo.tolist() == np.asarray(jlo).astype(np.int64).tolist()


@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1, 2**32 + 5,
                                  0xDEADBEEF12345678, 2**64 - 1])
def test_philox_words_bitwise(seed):
    rng = np.random.default_rng(seed % 2**32)
    epochs = np.array([0, 1, 7, 2**32 - 1], np.uint32)
    blocks = np.array([0, 1, 499, 2**32 - 1], np.uint32)
    paths = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    j, e, p = (x.ravel() for x in np.meshgrid(blocks, epochs, paths,
                                               indexing="ij"))
    k0, k1 = jp.split_seed(seed)
    want = jp.philox4x32(jnp.asarray(j), jnp.asarray(e), jnp.asarray(p),
                         jnp.zeros(p.shape, jnp.uint32), k0, k1)
    got = tp.draw4(_t(j), _t(e), _t(p), torch.zeros(p.shape, dtype=torch.int64),
                   *tp.split_seed(seed))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def test_philox_scalar_counters_match_tensor_counters():
    """Python-int and numpy-uint32 counters give the tensor result (a
    numpy uint32 would otherwise wrap inside the products)."""
    paths = _t(np.arange(128) * 7919)
    zero = torch.zeros_like(paths)
    k0, k1 = tp.split_seed(99)
    ref = tp.philox4x32(torch.full_like(paths, 2**32 - 1), torch.full_like(
        paths, 5), paths, zero, k0, k1)
    for j, e in ((2**32 - 1, 5), (np.uint32(2**32 - 1), np.uint32(5))):
        got = tp.philox4x32(j, e, paths, zero, k0, k1)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**32 - 1, 2**32, 2**64 - 1,
                                  2**64 + 3, -1])
def test_split_seed(seed):
    assert tuple(map(int, tp.split_seed(seed))) == \
        tuple(map(int, jp.split_seed(seed)))
