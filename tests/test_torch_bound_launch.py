"""A pricer's bound kernel launch (``ops/launch.py::BoundLaunch``): bound
in the first ``compute()`` on a card and reused while the static arguments
stay (seed words, base_path, N, n_paths, device, variant), bound anew where
they change, never on the CPU; each call then brings only its parameters
and epoch, and waits once.  A wrapper called without a launch binds a
fresh one, and the launch layer sits below every wrapper and pricer.

The CPU cases run the bound path on a fake card: the library's two entry
points compute the plain versions from the arguments they receive and
write them through ``out``'s pointer, the buffers are CPU tensors, and the
stream, device and pinned-memory calls are stand-ins.  The card's cases (marker ``cuda``)
hold the bound path bitwise to fresh wrapper calls, and import neither jax
nor nmch_tpu:

    python -m pytest tests/test_torch_bound_launch.py -m cuda -q --noconftest
"""

import ast
import contextlib
import ctypes
import math
import pathlib

import pytest
import torch

import nmch_tpu_torch.methods.base as methods_base
import nmch_tpu_torch.methods.em as methods_em
import nmch_tpu_torch.methods.fe as methods_fe
from nmch_tpu_torch import HestonParams, NMCH_EM, NMCH_FE, SimConfig
from nmch_tpu_torch.ops import em_cuda, fe_cuda, launch as launch_layer
from nmch_tpu_torch.ops.em import EmConsts, moments_f64, payoffs_from_consts
from nmch_tpu_torch.ops.fe import BOXES, fe_moments_kernel_plain, \
    path_index_grid
from nmch_tpu_torch.utils.timing import device_ops

TINY = SimConfig(NTPB=128, NB=1, N=4)
WIDER = SimConfig(NTPB=128, NB=2, N=4)
NAN = float("nan")


def _write(ptr: int, values: torch.Tensor) -> None:
    values = values.to(torch.float64).contiguous()
    ctypes.memmove(ptr, values.data_ptr(), 8 * values.numel())


class FakeLib:
    """The library's two pricing entry points, as plain versions of their
    arguments: ``calls`` keeps each call's epoch and n_paths, ``args`` its
    arguments but the partials' and out's pointers (EM's constants as a
    list)."""

    def __init__(self):
        self.calls = []
        self.args = []

    def nmch_fe_moments(self, *a):
        *pv, k0, k1, epoch, base, N, n_paths, rng, rot, box, fast = a[:-3]
        self.calls.append((epoch, n_paths))
        self.args.append((*a[:-3], a[-1]))
        m = fe_moments_kernel_plain(
            torch.tensor(pv, dtype=torch.float32), (k0, k1), epoch, base,
            N=N, n_paths=n_paths, rng=launch_layer.RNGS[rng], rot=rot,
            box=BOXES[box], fast_sqrt=bool(fast))
        _write(a[-2], torch.stack(m))
        return 0

    def nmch_em_moments(self, consts, k0, k1, epoch, base, N, n_paths, rng,
                        conditional, partials, out, payoff, ctr, stream):
        c = EmConsts(*consts)
        self.calls.append((epoch, n_paths))
        self.args.append((list(consts), k0, k1, epoch, base, N, n_paths, rng,
                          conditional, payoff, ctr, stream))
        pay, _ = payoffs_from_consts(c, N, path_index_grid(n_paths, base),
                                     epoch, k0, k1,
                                     launch_layer.COUNTER_RNGS[rng],
                                     bool(conditional))
        # no counts: the plain version has no warps to count
        _write(out, torch.cat([torch.stack(moments_f64(pay)),
                               torch.tensor([NAN, NAN])]))
        return 0


class FakeStream:
    cuda_stream = 7

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.fixture
def card(monkeypatch):
    """A fake card: pricers on device "cuda" take the bound path; the
    pinned buffers that ``BoundLaunch.fetch`` makes are kept in
    ``pinned``."""
    lib, stream = FakeLib(), FakeStream()
    syncs, pinned = [], []

    def pinned_like(t):
        pinned.append(torch.empty_like(t))
        return pinned[-1]

    monkeypatch.setattr(methods_base, "resolve_device", torch.device)
    monkeypatch.setattr(launch_layer, "load_library", lambda: (lib, None))
    monkeypatch.setattr(launch_layer, "scratch", lambda device, n_partials,
                        out_shape: tuple(torch.empty(n, dtype=torch.float64)
                                         for n in (n_partials, out_shape)))
    monkeypatch.setattr(launch_layer, "pinned_like", pinned_like)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    lib.stream, lib.syncs, lib.pinned = stream, syncs, pinned
    return lib


def _pair(cls, cfg=TINY, seed=1234, **kw):
    """(a pricer on the fake card, the same pricer on the CPU)."""
    out = []
    for device in ("cuda", "cpu"):
        p = cls(cfg, HestonParams(), device=device, **kw)
        p.init(seed)
        out.append(p)
    return out


def _both(pricers, fn):
    return [fn(p) for p in pricers]


def _prices(pricers):
    return _both(pricers, lambda p: (lambda r: (r.price, r.price_squared))(
        p.compute()))


@pytest.mark.parametrize("cls", [NMCH_FE, NMCH_EM])
def test_setters_and_epochs_reuse_the_launch(card, cls):
    """Three epochs with the three setters between them: one binding, one
    call of the library each, and the CPU pricer's prices bitwise."""
    pair = _pair(cls)
    for step, setter in enumerate([None, "set_k", "set_theta", "set_sigma"]):
        if setter:
            _both(pair, lambda p: getattr(p, setter)(0.2 + 0.1 * step))
        card_price, cpu_price = _prices(pair)
        assert card_price == cpu_price
    assert pair[0]._launch.binds == 1
    assert card.calls == [(e, TINY.n_paths) for e in range(4)]


def _new_seed(p, tmp_path):
    p.init(99)


def _load_state(p, tmp_path):
    q = type(p)(p.cfg, HestonParams(), device=p.device.type)
    q.init(77)
    q.compute()
    path = tmp_path / f"{p.device.type}.json"
    q.save_state(path)
    p.load_state(path)


def _new_cfg(p, tmp_path):
    p.cfg = WIDER


def _fe_variant(p, tmp_path):
    p.rot = 2


def _em_variant(p, tmp_path):
    p.conditional = True


@pytest.mark.parametrize("cls,change", [
    (NMCH_FE, _new_seed), (NMCH_FE, _load_state), (NMCH_FE, _new_cfg),
    (NMCH_FE, _fe_variant), (NMCH_EM, _new_seed), (NMCH_EM, _em_variant)])
def test_a_new_static_key_binds_anew(card, tmp_path, cls, change):
    """A new seed (init, load_state), cfg or variant binds the launch
    anew, and the next prices are the CPU pricer's under the same change;
    the call after it reuses the new binding."""
    pair = _pair(cls)
    _prices(pair)
    launch = pair[0]._launch
    out = launch.out
    _both(pair, lambda p: change(p, tmp_path))
    card_price, cpu_price = _prices(pair)
    assert card_price == cpu_price
    assert launch.binds == 2 and launch.out is not out
    card_price, cpu_price = _prices(pair)
    assert card_price == cpu_price and launch.binds == 2


def test_each_call_waits_once(card):
    """A bound call synchronises the device once (the Timer's entry) and
    waits once on the launch's stream, after one copy of out."""
    p = _pair(NMCH_EM)[0]
    for _ in range(3):
        p.compute()
    assert len(card.syncs) == 3 and card.stream.waits == 3
    assert p.result.exec_time_ms >= 0.0


@pytest.mark.parametrize("cls,module,name", [
    (NMCH_FE, methods_fe, "fe_moments_cuda"),
    (NMCH_EM, methods_em, "em_moments_cuda")])
def test_a_wrapper_that_halves_the_paths_changes_the_result(
        card, monkeypatch, cls, module, name):
    """A wrapper installed over the name the pricer calls, which halves
    n_paths, still reaches the kernel: the launch binds for the half, and
    the prices are those of a CPU pricer of half the paths."""
    def half(fn):
        def f(*a, **kw):
            kw["n_paths"] //= 2
            return fn(*a, **kw)
        return f

    whole = _prices(_pair(cls, WIDER))[0]
    ref = _pair(cls, TINY)[1].compute()
    monkeypatch.setattr(module, name, half(getattr(module, name)))
    p = _pair(cls, WIDER)[0]
    halved = (lambda r: (r.price, r.price_squared))(p.compute())
    assert halved == (ref.price, ref.price_squared) != whole
    assert p._launch.key[3] == TINY.n_paths and p._launch.binds == 1


@pytest.mark.parametrize("cls,kw", [
    (NMCH_FE, {}), (NMCH_FE, {"rng": "xorwow"}), (NMCH_FE, {"engine": "qmc"}),
    (NMCH_EM, {}), (NMCH_EM, {"engine": "scan"})])
def test_pricers_that_never_bind(card, cls, kw):
    """CPU pricers, and on a card the stateful, QMC and scan engines, take
    no bound launch."""
    p = cls(TINY, HestonParams(), device="cpu", **kw)
    assert p._launch is None
    if kw:
        q = cls(TINY, HestonParams(), device="cuda", **kw)
        assert q._launch is None
    p.init(3)
    p.compute()
    assert p._launch is None


def test_finalize_releases_the_buffers(card):
    p = _pair(NMCH_FE)[0]
    p.compute()
    p.finalize()
    assert p._launch.out is None and p._launch.key is None
    p.init(1234)
    p.compute()
    assert p._launch.binds == 2 and p._launch.out is not None


def test_call_kernel_guards_only_another_device(monkeypatch):
    """``call_kernel`` (every other wrapper's launch) enters the device
    guard only for a device that is not the current one, and passes that
    device's current stream."""
    calls, guards = [], []

    class Lib:
        def nmch_fake(self, *args):
            calls.append(args)
            return 0

    @contextlib.contextmanager
    def guard(index):
        guards.append(index)
        yield

    monkeypatch.setattr(launch_layer, "load_library", lambda: (Lib(), None))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: type(
        "Stream", (), {"cuda_stream": 10 + index}))
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        launch_layer.call_kernel("nmch_fake", "fake", device, 5)
    assert guards == [1]
    assert calls == [(5, 10), (5, 10), (5, 11)]


def _wrapper_call(p, device, counts):
    """The wrapper call, with no launch, that prices what ``p`` prices at
    epoch 0 (counts: EM's ``counts``)."""
    kw = dict(N=p.cfg.N, n_paths=p.cfg.n_paths, device=device, rng=p.rng)
    pv = p.params.as_tensor("cpu")
    if isinstance(p, NMCH_FE):
        return fe_cuda.fe_moments_cuda(pv, p.streams.key_words, 0, 0,
                                       rot=p.rot, **kw)
    return em_cuda.em_moments_cuda(
        pv, p.streams.key_words, 0, 0, conditional=p.conditional,
        poisson_cut=p.poisson_cut, counts=counts, **kw)


@pytest.mark.parametrize("cls,counts", [
    (NMCH_FE, False), (NMCH_EM, False), (NMCH_EM, True)])
def test_a_call_without_a_launch_binds_a_fresh_one(card, cls, counts):
    """A wrapper called with no launch on a card reaches the library once,
    with the arguments a pricer's bound call passes for the same params
    and epoch; it returns the moments as two 0-dim tensors (EM with
    counts: the vector (4,)), bitwise the CPU plain version's, and makes
    no pinned buffer."""
    p = _pair(cls)[0]
    p.compute()
    pinned = len(card.pinned)
    got = _wrapper_call(p, "cuda", counts)
    want = _wrapper_call(p, "cpu", counts)
    assert len(card.args) == 2 and card.args[1] == card.args[0]
    assert len(card.pinned) == pinned == 1
    if counts:
        assert got.shape == (4,) and got.dtype == torch.float64
        assert got[:2].tolist() == want.tolist()
        assert math.isnan(got[2].item()) and math.isnan(got[3].item())
    else:
        assert len(got) == 2
        assert all(t.shape == () and t.dtype == torch.float64 for t in got)
        assert [t.item() for t in got] == [t.item() for t in want]


def _relative_imports(path: pathlib.Path):
    """(module, names) of each import in ``path``, a relative module
    resolved to its dotted name within the package."""
    pkg = ["nmch_tpu_torch", *path.parent.relative_to(
        pathlib.Path(launch_layer.__file__).parents[1]).parts]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((a.name, []) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            module = ".".join([*base, *(node.module or "").split(".")])
            yield module.strip("."), [a.name for a in node.names]


def test_the_launch_layer_sits_below_the_wrappers():
    """``ops/launch.py`` imports no wrapper (``ops/*_cuda.py``) and no
    pricer (``methods/``), and no wrapper takes a name from
    ``ops/fe_cuda.py`` but ``fe_moments_cuda``."""
    ops = pathlib.Path(launch_layer.__file__).parent
    below = [m for m, _ in _relative_imports(ops / "launch.py")]
    assert below and not [m for m in below if m.endswith("_cuda")
                          or m.startswith("nmch_tpu_torch.methods")]
    wrappers = sorted(ops.glob("*_cuda.py"))
    assert wrappers
    taken = {name for path in wrappers
             for m, names in _relative_imports(path)
             if m == "nmch_tpu_torch.ops.fe_cuda" for name in names}
    assert taken <= {"fe_moments_cuda"}


# --- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


CARD = SimConfig(NTPB=128, NB=32, N=1000)


def _fresh(p, params, epoch):
    """A fresh wrapper call (no bound launch) for what ``p`` priced at
    ``epoch``: its vector, counts included for EM."""
    pv = params.as_tensor("cpu")
    kw = dict(N=p.cfg.N, n_paths=p.cfg.n_paths, device=p.device, rng=p.rng)
    if isinstance(p, NMCH_FE):
        return torch.stack(fe_cuda.fe_moments_cuda(
            pv, p.streams.key_words, epoch, 0, rot=p.rot, **kw))
    return em_cuda.em_moments_cuda(
        pv, p.streams.key_words, epoch, 0, conditional=p.conditional,
        poisson_cut=p.poisson_cut, counts=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,kw", [
    (NMCH_FE, {"rng": "philox"}), (NMCH_FE, {"rng": "threefry4"}),
    (NMCH_FE, {"rot": 2}), (NMCH_EM, {"poisson_cut": 128.0}),
    (NMCH_EM, {"poisson_cut": 4000.0})])
def test_bound_path_is_bitwise_the_fresh_wrappers(dev, cls, kw):
    """Three epochs with a setter in the middle: each call's moments (and
    K2's counts) equal a fresh wrapper call's bitwise, one binding."""
    p = cls(CARD, HestonParams(), device=dev, **kw)
    p.init(20240917)
    for epoch in range(3):
        if epoch == 2:
            p.set_theta(0.2)
        params = p.params
        r = p.compute()
        want = _fresh(p, params, epoch)
        got = p._launch.host.clone()
        assert [r.price, r.price_squared] == want[:2].tolist()
        torch.testing.assert_close(got, want.cpu(), rtol=0, atol=0,
                                   equal_nan=True)
        if cls is NMCH_EM:
            assert got[2].item() > 0
            assert math.isnan(got[3].item()) == (kw["poisson_cut"] == 128.0)
    assert p._launch.binds == 1


@pytest.mark.cuda
def test_a_pricer_launches_on_the_current_stream(dev):
    p = NMCH_FE(CARD, HestonParams(), device=dev)
    p.init(11)
    p.compute()
    launch, seen = p._launch, []
    fn = launch.fn

    def recording(*args):
        seen.append(args[-1])
        return fn(*args)

    launch.fn = recording
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        r = p.compute()
    p.compute()
    assert seen == [s.cuda_stream, torch.cuda.current_stream(dev).cuda_stream]
    assert seen[0] != seen[1]
    assert [r.price, r.price_squared] == _fresh(p, p.params, 1).tolist()


@pytest.mark.cuda
def test_one_fe_compute_is_three_device_ops(dev):
    """K1, its sum and the copy of out: no stack of two views."""
    p = NMCH_FE(CARD, HestonParams(), device=dev)
    p.init(5)
    p.compute()
    ops = device_ops(p.compute)
    assert len(ops) == 3, ops
    assert "fe_paths" in ops[0] and "sum_partials" in ops[1]
    assert "Memcpy" in ops[2]
