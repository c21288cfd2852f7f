"""The stateful FE path of the PyTorch port (the plain version of K5, the
jumps, the wrappers on the CPU and NMCH_FE with xorwow/mrg32k3a) against
nmch_tpu's ops/fe_stateful_pallas.py and methods/fe.py.

States are compared bitwise (integer words; nmch_tpu's are fed through
``state_from_numpy``).  Moments against nmch_tpu are held at rel 1e-5:
torch's CPU log is not XLA's bit for bit, so a path's S_T may differ in
its last bits (measured worst rel on the moments: ~1.7e-7).  Within the
port, the cuda engine (plain version on the CPU) and the scan engine give
bitwise-equal prices at every epoch.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmch_tpu
from nmch_tpu.ops import fe_stateful_pallas as jsp
from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig
from nmch_tpu_torch.ops import fe_stateful as tsp
from nmch_tpu_torch.ops import fe_stateful_cuda as tsc

torch.set_num_threads(2)

REL = 1e-5
FAMILIES = ("xorwow", "mrg32k3a")
PV = HestonParams().as_tensor("cpu")
J_PV = nmch_tpu.HestonParams().as_array()
CFG = SimConfig(NTPB=256, NB=4, N=16, seed=5)      # 1024 paths


def _rel(a, b) -> float:
    return max(abs(float(x) - float(y)) / abs(float(y)) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def _jax_state(rng, seed, n_paths, epoch):
    return np.asarray(jsp.fe_stateful_state(rng, seed, n_paths, epoch))


@pytest.mark.parametrize("rng", FAMILIES)
@pytest.mark.parametrize("epoch", [0, 5])
def test_fe_stateful_state_bitwise_and_numpy_layout(rng, epoch):
    want = _jax_state(rng, 99, 1024, epoch)
    got = tsp.fe_stateful_state(rng, 99, 1024, epoch)
    assert got.dtype == torch.int64 and got.shape == (6, 1024)
    assert torch.equal(got, tsp.state_from_numpy(want))
    np.testing.assert_array_equal(tsp.state_to_numpy(got), want)


@pytest.mark.parametrize("rng", FAMILIES)
@pytest.mark.parametrize("N,epoch", [(16, 0), (9, 3)])
def test_plain_k5_matches_the_interpreted_pallas_kernel(rng, N, epoch):
    """From nmch_tpu's own states: moments at rel 1e-5, the advanced state
    bitwise; at odd N (a masked tail that still draws) the advanced state
    is the dense jump by draws_per_compute(N)."""
    st0 = _jax_state(rng, 99, 1024, epoch)
    m, m2, st1 = jsp.fe_moments_stateful_pallas(
        J_PV, jnp.asarray(st0), N=N, n_paths=1024, rng=rng, interpret=True)
    got = tsp.fe_moments_stateful_plain(PV, tsp.state_from_numpy(st0), N,
                                        rng)
    assert _rel(got[:2], (m, m2)) <= REL
    np.testing.assert_array_equal(tsp.state_to_numpy(got[2]),
                                  np.asarray(st1))
    assert torch.equal(tsp.advance_state(rng, tsp.state_from_numpy(st0),
                                         tsp.draws_per_compute(N)), got[2])


@pytest.mark.parametrize("rng", FAMILIES)
def test_boundary_jump_lands_on_the_next_epoch(rng):
    """advance_state(st1, epoch_stride - D) is bitwise nmch_tpu's jump and
    fe_stateful_state at e + 1."""
    N, e = 9, 2
    D = tsp.draws_per_compute(N)
    assert D == jsp.draws_per_compute(N) == 20
    assert tsp.epoch_stride(rng) == jsp.epoch_stride(rng) == 2**40
    st0 = tsp.fe_stateful_state(rng, 7, 256, e)
    _, _, st1 = tsp.fe_moments_stateful_plain(PV, st0, N, rng)
    got = tsp.advance_state(rng, st1, tsp.epoch_stride(rng) - D)
    want = jsp.advance_state(rng, jnp.asarray(tsp.state_to_numpy(st1)),
                             jsp.epoch_stride(rng) - D)
    np.testing.assert_array_equal(tsp.state_to_numpy(got), np.asarray(want))
    assert torch.equal(got, tsp.fe_stateful_state(rng, 7, 256, e + 1))


@pytest.mark.parametrize("rng", FAMILIES)
def test_host_jump_table_matches_nmch_tpu(rng):
    for a, b in zip(tsp.host_jump_table(rng, 12345),
                    jsp._host_jump_table(rng, 12345)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("rng", FAMILIES)
def test_wrappers_on_cpu_are_the_plain_versions(rng):
    before = [f.launches for f in (tsc.fe_stateful_moments_cuda,
                                   tsc.fe_stateful_state_cuda,
                                   tsc.advance_state_cuda)]
    st = tsc.fe_stateful_state_cuda(rng, 3, 256, 4, "cpu")
    assert torch.equal(st, tsp.fe_stateful_state(rng, 3, 256, 4))
    got = tsc.fe_stateful_moments_cuda(PV, st, N=7, rng=rng)
    want = tsp.fe_moments_stateful_plain(PV, st, 7, rng)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.float64
    assert torch.equal(tsc.advance_state_cuda(rng, st, 1000),
                       tsp.advance_state(rng, st, 1000))
    assert [f.launches for f in (tsc.fe_stateful_moments_cuda,
                                 tsc.fe_stateful_state_cuda,
                                 tsc.advance_state_cuda)] == before


def test_seed_words_and_device_tables_match_the_host_algebra():
    from nmch_tpu_torch.rng import mrg32k3a as tm, xorwow as tx
    assert tsc._seed_words("xorwow", 5) == (*tx.seed_state(5)[0],
                                            tx.seed_state(5)[1])
    assert tsc._seed_words("mrg32k3a", 5) == sum(tm.seed_state(5), ())
    tab, lanes = (t.numpy().view(np.uint32)
                  for t in tsc._init_tables("xorwow", "cpu"))
    np.testing.assert_array_equal(
        tab, tsc.xorwow_rows(tx._jump_tables()).reshape(-1))
    np.testing.assert_array_equal(
        lanes.reshape(-1, 32).T.reshape(32, 5, 32, 5),
        tsp.init_lane_tables("xorwow"))
    tab, lanes = (t.numpy().view(np.uint32)
                  for t in tsc._init_tables("mrg32k3a", "cpu"))
    j1, j2 = tm._jump_tables()
    np.testing.assert_array_equal(tab.reshape(58, 2, 3, 3)[:, 0], j1)
    np.testing.assert_array_equal(tab.reshape(58, 2, 3, 3)[:, 1], j2)
    np.testing.assert_array_equal(
        lanes.reshape(-1, 32).T.reshape(32, 2, 3, 3),
        tsp.init_lane_tables("mrg32k3a"))


# --- the split skip-ahead of the init kernel --------------------------------

@pytest.mark.parametrize("epoch,n_paths", [(0, 4096), (1, 4096),
                                           (2**27 - 1, 4096),
                                           (2**27 - 1, 1 << 18)])
@pytest.mark.parametrize("rng", FAMILIES)
def test_split_init_is_the_skip_ahead(rng, epoch, n_paths):
    """The warp-uniform jumps, then each lane's combined table: bitwise
    fe_stateful_state (every path bit up to 2^18, every epoch bit)."""
    assert torch.equal(tsp.fe_stateful_state_split(rng, 1234, n_paths, epoch),
                       tsp.fe_stateful_state(rng, 1234, n_paths, epoch))


def test_lane_tables_are_products_of_the_path_jumps():
    """Lane l's combined table is the product of path jumps 0..4 (tables
    27..31) that l's bits select, by the exact host algebra (python ints;
    the tables use numpy's GF(2) products)."""
    from nmch_tpu_torch.rng import mrg32k3a as tm, xorwow as tx
    cols = [tuple(sum(int(t[wi, b, wo]) << (32 * wo) for wo in range(5))
                  for wi in range(5) for b in range(32))
            for t in tx._jump_tables()[27:32]]
    j1, j2 = tm._jump_tables()
    eye = tuple(1 << j for j in range(160))
    for lane in range(32):
        m1 = m2 = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
        xw = eye
        for k in range(5):
            if lane >> k & 1:
                xw = tx._mat_mul(cols[k], xw)
                m1 = tm._mat_mul(m1, tuple(map(tuple, j1[27 + k].tolist())),
                                 tm.M1)
                m2 = tm._mat_mul(m2, tuple(map(tuple, j2[27 + k].tolist())),
                                 tm.M2)
        np.testing.assert_array_equal(tsp.init_lane_tables("xorwow")[lane],
                                      tx._columns_to_table(xw))
        np.testing.assert_array_equal(tsp.init_lane_tables("mrg32k3a")[lane],
                                      np.array([m1, m2], dtype=np.uint32))


def _parity(x: np.ndarray) -> np.ndarray:
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(sh))
    return x & np.uint32(1)


@pytest.mark.parametrize("rng", FAMILIES)
def test_init_kernel_layouts_emulated(rng):
    """csrc/fe_stateful.cu::stateful_init step by step in numpy on the
    device tables (``_init_tables``): the shared jumps (XORWOW: lane l forms
    bit l of each output word from the row form, a ballot gathers it),
    then lane l's combined table read at word k * 32 + l.  The states of
    four warps at epoch 5 bitwise fe_stateful_state's."""
    from nmch_tpu_torch.rng import mrg32k3a as tm
    tabs, lanes = (t.numpy().view(np.uint32) for t in
                   tsc._init_tables(rng, "cpu"))
    lanes = lanes.reshape(-1, 32)
    u32 = np.uint32
    want = tsp.fe_stateful_state(rng, 9, 1 << 12, 5).numpy()
    base = tsc._seed_words(rng, 9)
    l_idx = np.arange(32)
    for warp in (0, 1, 37, 127):
        s = [u32(w) for w in base]
        ms = [m for m in range(27) if 5 >> m & 1] + \
            [32 + k for k in range(26) if warp >> k & 1]
        for m in ms:
            if rng == "xorwow":
                rows = tabs.reshape(58, 5, 5, 32)[m]
                s[:5] = [u32((_parity(np.bitwise_xor.reduce(
                    [rows[wo, wi] & s[wi] for wi in range(5)]))
                    .astype(np.uint64) << l_idx.astype(np.uint64)).sum())
                    for wo in range(5)]
            else:
                j = tabs.reshape(58, 2, 3, 3)[m].astype(object)
                s = [sum(j[0, r, c] * int(s[c]) for c in range(3)) % tm.M1
                     for r in range(3)] + \
                    [sum(j[1, r, c] * int(s[3 + c]) for c in range(3)) % tm.M2
                     for r in range(3)]
        got = np.empty((6, 32), dtype=np.int64)
        for lane in l_idx:
            t = lanes[:, lane]
            if rng == "xorwow":
                acc = np.zeros(5, dtype=u32)
                for wi in range(5):
                    for b in range(32):
                        if int(s[wi]) >> b & 1:
                            acc ^= t[(wi * 32 + b) * 5:(wi * 32 + b) * 5 + 5]
                got[:, lane] = [*acc, base[5]]
            else:
                j = t.reshape(2, 3, 3).astype(object)
                got[:, lane] = [
                    sum(j[0, r, c] * int(s[c]) for c in range(3)) % tm.M1
                    for r in range(3)] + [
                    sum(j[1, r, c] * int(s[3 + c]) for c in range(3)) % tm.M2
                    for r in range(3)]
        np.testing.assert_array_equal(got, want[:, warp * 32:warp * 32 + 32])


@pytest.mark.parametrize("call,match", [
    (lambda st: tsc.fe_stateful_moments_cuda(PV, st, N=4, rng="philox"),
     "stateful families"),
    (lambda st: tsc.fe_stateful_moments_cuda(PV, st[:5], N=4, rng="xorwow"),
     "shape"),
    (lambda st: tsc.fe_stateful_moments_cuda(PV, st.int(), N=4,
                                             rng="xorwow"), "int64"),
    (lambda st: tsc.fe_stateful_moments_cuda(PV, st, N=0, rng="xorwow"),
     "N="),
    (lambda st: tsc.fe_stateful_moments_cuda(PV.double(), st, N=4,
                                             rng="xorwow"), "float32"),
    (lambda st: tsc.fe_stateful_state_cuda("threefry4", 1, 128, 0, "cpu"),
     "stateful families"),
    (lambda st: tsc.fe_stateful_state_cuda("xorwow", 1, 200, 0, "cpu"),
     "multiple of 128"),
    (lambda st: tsc.fe_stateful_state_cuda("xorwow", 1, 2**31, 0, "cpu"),
     "below 2\\^31"),
    (lambda st: tsc.fe_stateful_state_cuda("xorwow", 1, 128, 2**32, "cpu"),
     "uint32"),
    (lambda st: tsc.fe_stateful_state_cuda("xorwow", 1, 128, 0, "meta"),
     "neither cpu nor cuda"),
    (lambda st: tsc.advance_state_cuda("xorwow", st, -1), ">= 0"),
    (lambda st: tsp.state_from_numpy(np.zeros((6, 2, 64))), "6, R, 128"),
])
def test_wrappers_reject_bad_arguments(call, match):
    st = torch.zeros(6, 128, dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        call(st)


# --- the method layer -----------------------------------------------------

def _fe(rng, engine="cuda", cfg=CFG):
    return NMCH_FE(cfg, HestonParams(), engine=engine, rng=rng, device="cpu")


@pytest.mark.parametrize("rng", FAMILIES)
def test_engines_agree_bitwise_at_epochs_0_to_2_and_match_nmch_tpu(rng):
    """The cuda engine (carried states: a fresh skip-ahead at epoch 0, then
    boundary jumps) equals the scan engine (skip-ahead every epoch) bitwise,
    and nmch_tpu's scan engine at rel 1e-5."""
    mc, ms = _fe(rng), _fe(rng, "scan")
    jm = nmch_tpu.NMCH_FE(nmch_tpu.SimConfig(NTPB=256, NB=4, N=16, seed=5),
                          nmch_tpu.HestonParams(), engine="scan", rng=rng)
    for m in (mc, ms, jm):
        m.init(5)
    prices = []
    for _ in range(3):
        rc, rs, rj = mc.compute(), ms.compute(), jm.compute()
        assert rc.price == rs.price and rc.price_squared == rs.price_squared
        assert _rel((rc.price, rc.price_squared),
                    (rj.price, rj.price_squared)) <= REL
        prices.append(rc.price)
    assert len(set(prices)) == 3                 # fresh draws per epoch
    assert mc._state_epoch == 3 and mc._state_offset == 32


def test_continuation_and_checkpoint_resume(tmp_path):
    """A (seed, epoch) checkpoint resumes bitwise; a different seed's
    checkpoint loaded into a used pricer does not reuse its stale states
    (nmch_tpu's round-5 review bug)."""
    m = _fe("xorwow")
    m.init(5)
    prices = [m.compute().price for _ in range(3)]
    m2 = _fe("xorwow")
    m2.init(5)
    m2.compute()
    ck = str(tmp_path / "ck.json")
    m2.save_state(ck)
    m3 = _fe("xorwow")
    m3.load_state(ck)
    assert m3.compute().price == prices[1]
    assert m3.compute().price == prices[2]

    m7 = _fe("xorwow")
    m7.init(7)
    m7.compute()
    ck7 = str(tmp_path / "ck7.json")
    m7.save_state(ck7)
    want = m7.compute().price
    used = _fe("xorwow")
    used.init(5)
    used.compute()
    used.compute()            # its carried state is at seed 5, epoch 2
    used.load_state(ck7)      # seed 7, epoch 1
    assert used._state is None
    assert used.compute().price == want


def test_checkpoint_from_nmch_tpu_resumes_in_the_port(tmp_path):
    jcfg = nmch_tpu.SimConfig(NTPB=256, NB=4, N=16, seed=11)
    jm = nmch_tpu.NMCH_FE(jcfg, nmch_tpu.HestonParams(theta=0.12),
                          engine="pallas", rng="mrg32k3a", interpret=True)
    jm.init(11)
    jm.compute()
    ck = str(tmp_path / "ck.json")
    jm.save_state(ck)
    want = jm.compute()
    m = _fe("mrg32k3a")
    m.load_state(ck)
    got = m.compute()
    assert m.params.theta == 0.12 and m.streams.epoch == 2
    assert _rel((got.price, got.price_squared),
                (want.price, want.price_squared)) <= REL


def test_init_drops_the_carried_states():
    m = _fe("xorwow")
    m.init(5)
    first = m.compute().price
    m.compute()
    m.init(5)
    assert m._state is None
    assert m.compute().price == first


@pytest.mark.parametrize("kw,match", [
    ({"rng": "xorwow", "rot": 4}, "no rot/antithetic"),
    ({"rng": "mrg32k3a", "antithetic": True}, "no rot/antithetic"),
    ({"rng": "xorwow", "cfg": SimConfig(NTPB=2**16, NB=2**15)}, "2\\^31"),
    ({"rng": "mrg32k3a", "engine": "scan",
      "cfg": SimConfig(NTPB=2**16, NB=2**15)}, "2\\^31"),
])
def test_constructor_refusals(kw, match):
    kw = {"engine": "cuda", "cfg": CFG, **kw}
    with pytest.raises(ValueError, match=match):
        NMCH_FE(kw.pop("cfg"), HestonParams(), device="cpu", **kw)


@pytest.mark.parametrize("engine", ["cuda", "scan"])
def test_epoch_bound(engine):
    m = _fe("xorwow", engine)
    m.init(5)
    m.streams.epoch = 2**27
    with pytest.raises(ValueError, match="134217728 epochs per path block"):
        m.compute()


def test_guard_draws_per_compute_below_epoch_stride(monkeypatch):
    """A run that would draw into the next epoch's block raises before any
    state is reused (D = 64 at N=32 against a stride cut to 64)."""
    m = _fe("xorwow", cfg=SimConfig(NTPB=128, NB=1, N=32))
    m.init(5)
    monkeypatch.setattr(tsp, "epoch_stride", lambda rng: 64)
    with pytest.raises(ValueError, match="not fewer than the 64"):
        m.compute()


def test_advance_nibble_entries_emulated():
    """csrc/fe_stateful.cu's XORWOW advance in numpy: the 16 entries of each
    input nibble (entry v = entry v & (v - 1) XOR the column of v's lowest
    bit), one entry XORed in a nibble: bitwise advance_state."""
    steps = tsp.epoch_stride("xorwow") - tsp.draws_per_compute(1000)
    tab = tsc._advance_table("xorwow", steps, "cpu")[0].numpy().view(
        np.uint32).reshape(160, 5)
    nib = np.zeros((40, 16, 5), dtype=np.uint32)
    for v in range(1, 16):
        low = (v & -v).bit_length() - 1
        nib[:, v] = nib[:, v & (v - 1)] ^ tab[4 * np.arange(40) + low]
    st = tsp.fe_stateful_state("xorwow", 11, 512, 2)
    words = st.numpy().astype(np.uint32)
    acc = np.zeros((5, 512), dtype=np.uint32)
    for g in range(40):
        v = (words[g // 8] >> np.uint32(4 * (g % 8))) & np.uint32(15)
        acc ^= nib[g, v].T
    want = tsp.advance_state("xorwow", st, steps).numpy()
    np.testing.assert_array_equal(acc, want[:5])
