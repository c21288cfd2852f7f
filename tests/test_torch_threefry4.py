"""Threefry-4x32 of the PyTorch port, bitwise against nmch_tpu's, and the
CUDA kernels' copy of it (csrc/counter_rng.cuh) against the port's
rotation table."""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nmch_tpu.rng import threefry4 as jt
from nmch_tpu.rng.philox import split_seed as j_split_seed
from nmch_tpu_torch.rng import threefry4 as tt
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

RNG_HEADER = (pathlib.Path(__file__).resolve().parents[1]
              / "nmch_tpu_torch" / "csrc" / "counter_rng.cuh")


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("rounds", [12, 20])
@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1, 0xDEADBEEF12345678])
def test_draw4_words_bitwise(seed, rounds):
    rng = np.random.default_rng(seed % 2**32)
    epochs = np.array([0, 1, 7, 2**32 - 1], np.uint32)
    blocks = np.array([0, 1, 499, 2**32 - 1], np.uint32)
    paths = rng.integers(0, 2**32, 128, dtype=np.uint64).astype(np.uint32)
    j, e, p = (x.ravel() for x in np.meshgrid(blocks, epochs, paths,
                                               indexing="ij"))
    hi = np.where(p % 3 == 0, p ^ 0x5A5A5A5A, 0).astype(np.uint32)
    k0, k1 = j_split_seed(seed)
    want = jt.draw4_threefry4(jnp.asarray(j), jnp.asarray(e), jnp.asarray(p),
                              k0, k1, path_hi=jnp.asarray(hi), rounds=rounds)
    got = tt.draw4_threefry4(_t(j), _t(e), _t(p), *split_seed(seed),
                             path_hi=_t(hi), rounds=rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def test_threefry4x32_all_key_words_and_edges():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64)
    ctrs = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64)
    keys[:, :2] = [[0, 0xFFFFFFFF]] * 4
    ctrs[:, :2] = [[0xFFFFFFFF, 0]] * 4
    for rounds in (4, 12, 20, 72):
        want = jt.threefry4x32(*(jnp.asarray(k.astype(np.uint32))
                                 for k in keys),
                               *(jnp.asarray(c.astype(np.uint32))
                                 for c in ctrs), rounds=rounds)
        got = tt.threefry4x32(*(_t(k) for k in keys), *(_t(c) for c in ctrs),
                              rounds=rounds)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                          g.numpy())


def test_scalar_counters_match_tensor_counters():
    paths = _t(np.arange(128) * 7919)
    k0, k1 = split_seed(99)
    ref = tt.draw4_threefry4(torch.full_like(paths, 2**32 - 1),
                             torch.full_like(paths, 5), paths, k0, k1)
    for j, e in ((2**32 - 1, 5), (np.uint32(2**32 - 1), np.uint32(5))):
        got = tt.draw4_threefry4(j, e, paths, k0, k1)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("rounds", [0, 6, 76])
def test_bad_rounds_rejected(rounds):
    with pytest.raises(ValueError, match="multiple of 4"):
        tt.threefry4x32(0, 0, 0, 0, 0, 0, 0, 0, rounds=rounds)


def test_kernel_rotation_table_and_parity():
    """counter_rng.cuh spells out the 12 rounds of threefry4x32_12: its
    rotation pairs, key injections and parity word are the port's."""
    src = RNG_HEADER.read_text()
    body = src[src.index("threefry4x32_12("):]
    pairs = [tuple(map(int, m)) for m in
             re.findall(r"threefry_round<(\d+), (\d+)>\(", body)]
    assert pairs == [tt.ROTS[r % 8] for r in range(12)]
    assert re.findall(r"threefry_inject<(\d+)>\(", body) == ["1", "2", "3"]
    assert f"0x{tt.PARITY:08X}u" in src
