"""Threefry-2x32 and the device stream of the PyTorch port, bitwise against
nmch_tpu's generators, and the CUDA kernels' copy of both
(csrc/counter_rng.cuh) against the port's constants."""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nmch_tpu.rng import threefry as jt
from nmch_tpu.rng.philox import philox4x32 as j_philox
from nmch_tpu.rng.philox import split_seed as j_split_seed
from nmch_tpu_torch.ops.fe import make_draw4
from nmch_tpu_torch.rng import device as td
from nmch_tpu_torch.rng import threefry as tt
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

RNG_HEADER = (pathlib.Path(__file__).resolve().parents[1]
              / "nmch_tpu_torch" / "csrc" / "counter_rng.cuh")


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


def _grid(seed: int):
    """(block, epoch, path) over edge blocks and epochs and 64 random
    paths (path 0 and 2^32 - 1 among them)."""
    rng = np.random.default_rng(seed % 2**32)
    blocks = np.array([0, 1, 499, 2**32 - 1], np.uint32)
    epochs = np.array([0, 1, 7, 2**32 - 1], np.uint32)
    paths = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    paths[:2] = [0, 2**32 - 1]
    return [x.ravel() for x in np.meshgrid(blocks, epochs, paths,
                                           indexing="ij")]


@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1, 0xDEADBEEF12345678])
def test_draw4_threefry_words_bitwise(seed):
    j, e, p = _grid(seed)
    k0, k1 = j_split_seed(seed)
    want = jt.draw4_threefry(jnp.asarray(j), jnp.asarray(e), jnp.asarray(p),
                             k0, k1)
    _eq(want, tt.draw4_threefry(_t(j), _t(e), _t(p), *split_seed(seed)))


@pytest.mark.parametrize("rounds", [8, 20, 24])
def test_threefry2x32_all_key_words_and_edges(rounds):
    rng = np.random.default_rng(rounds)
    k = rng.integers(0, 2**32, size=(2, 256), dtype=np.uint64)
    x = rng.integers(0, 2**32, size=(2, 256), dtype=np.uint64)
    k[:, :2] = [[0, 0xFFFFFFFF]] * 2
    x[:, :2] = [[0xFFFFFFFF, 0]] * 2
    want = jt.threefry2x32(*(jnp.asarray(v.astype(np.uint32)) for v in k),
                           *(jnp.asarray(v.astype(np.uint32)) for v in x),
                           rounds=rounds)
    _eq(want, tt.threefry2x32(*(_t(v) for v in k), *(_t(v) for v in x),
                              rounds=rounds))


def test_threefry_scalar_counters_match_tensor_counters():
    paths = _t(np.arange(128) * 7919)
    k0, k1 = split_seed(99)
    ref = tt.draw4_threefry(torch.full_like(paths, 2**32 - 1),
                            torch.full_like(paths, 2**32 - 3), paths, k0, k1)
    for j, e in ((2**32 - 1, 2**32 - 3),
                 (np.uint32(2**32 - 1), np.uint32(2**32 - 3))):
        got = tt.draw4_threefry(j, e, paths, k0, k1)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("seed", [1234, 0xDEADBEEF12345678])
def test_device_stream_is_tagged_philox(seed):
    """Call i of the device stream is nmch_tpu's Philox4x32-10 at counter
    (i, epoch, path, "DPRG") under the run's key."""
    j, e, p = _grid(seed)
    k0, k1 = j_split_seed(seed)
    assert td.TAG == int.from_bytes(b"DPRG", "big")
    want = j_philox(jnp.asarray(j), jnp.asarray(e), jnp.asarray(p),
                    jnp.full(p.shape, td.TAG, jnp.uint32), k0, k1)
    _eq(want, td.device_call(_t(j), _t(e), _t(p), *split_seed(seed)))


@pytest.mark.parametrize("words", [3, 4])
def test_device_blocks_consume_words_in_order(words):
    """Block j takes stream words words*j .. words*j + words - 1, 4 words
    a call: with 4 words block j is call j (make_draw4's device stream);
    with 3 (packed_blocks), calls 0-2 feed blocks 0-3 and calls 3-5
    blocks 4-7, and the one-call cache never changes a word."""
    k0, k1 = split_seed(77)
    path = _t(np.array([0, 5, 2**32 - 1]))
    stream = []
    for i in range(9):
        stream += list(td.device_call(i, 3, path, k0, k1))
    block = (td.packed_blocks(3, path, k0, k1) if words == 3 else
             make_draw4("device", path, torch.zeros_like(path), 3, k0, k1))
    for j in range(8):
        got = block(j)
        assert len(got) == words
        for t, g in enumerate(got):
            assert torch.equal(g, stream[words * j + t])


def test_kernel_threefry2x32_and_device_constants():
    """counter_rng.cuh spells out Threefry-2x32-20: rotation groups A, B,
    A, B, A with the port's tables, key injections ks[i % 3] and
    ks[(i + 1) % 3] + i + 1; its derived-key constants and the device
    stream's tag are the port's."""
    src = RNG_HEADER.read_text()
    body = src[src.index("threefry2x32_20("):]
    body = body[:body.index("\n}\n")]
    groups = [tuple(map(int, g)) for g in re.findall(
        r"threefry2x32_mix4<(\d+), (\d+), (\d+), (\d+)>\(", body)]
    assert groups == [tt.ROT_A, tt.ROT_B] * 2 + [tt.ROT_A]
    ks = ("k1", "ks2", "k0")
    injections = re.findall(r"x0 \+= (\w+);\n\s+x1 \+= (\w+) \+ (\d+)u;",
                            body)
    assert injections == [(ks[i % 3], ks[(i + 1) % 3], str(i + 1))
                          for i in range(5)]
    for name, value in (("kGold", tt.GOLD), ("kGold2", tt.GOLD2),
                        ("kDeviceTag", td.TAG),
                        ("kThreefryParity", tt.PARITY)):
        assert re.search(rf"{name} = 0x{value:08X}u;", src), name
