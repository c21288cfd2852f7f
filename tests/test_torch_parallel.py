"""Path sharding of the PyTorch port (``nmch_tpu_torch/parallel/mesh.py``)
against its own single run and against ``nmch_tpu``'s sharded_moments.

The cases of ``tests/test_parallel.py``, in one process: each of the
``world`` ranks' parts comes from ``rank_moments`` (rank r prices paths
[r * per, (r + 1) * per) of the same streams) and ``combine_moments``
sums them in rank order, as ``sharded_moments`` does after its gather.
The port's engine "cuda" stands where ``nmch_tpu``'s "pallas" (interpret
mode) stands; on the CPU it runs the kernels' plain versions.

Bars: against the port's single run, rel 1e-12 for FE and EM (the same
draws; only the grouping of the float64 sums differs) and ``nmch_tpu``'s
own bars for QMC (rel 2e-6 on m, 2e-4 on the synthesized m2); against
``nmch_tpu``'s sharded_moments on the 8-device CPU mesh of
tests/conftest.py, the tolerance of the port's single-run tests against
``nmch_tpu`` (rel 1e-5, ``test_torch_fe.py``, ``test_torch_em.py``,
``test_torch_xorwow.py``; QMC m2 2e-4, ``test_torch_qmc.py``).
"""

import functools
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.parallel import mesh as jmesh
from nmch_tpu_torch import prewarm
from nmch_tpu_torch.ops.em import FAST_POISSON_CUT, em_moments_scan
from nmch_tpu_torch.ops.em_cuda import em_moments_cuda
from nmch_tpu_torch.ops.fe import fe_moments_rot_scan, fe_moments_scan, \
    path_index_grid
from nmch_tpu_torch.ops.fe_cuda import fe_moments_cuda
from nmch_tpu_torch.ops.fe_qmc import fe_moments_qmc
from nmch_tpu_torch.params import HestonParams
from nmch_tpu_torch.parallel.mesh import combine_moments, make_mesh, \
    rank_moments, sharded_moments
from nmch_tpu_torch.rng.philox import split_seed

torch.set_num_threads(2)

P = HestonParams()
PV = P.as_tensor("cpu")
K01 = split_seed(1234)
SINGLE_REL = 1e-12
JAX_REL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_sharded(sigma=None, **kw):
    """nmch_tpu's sharded_moments on the conftest's 8-device CPU mesh, as
    floats (each case runs once per test process)."""
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    p = JHestonParams() if sigma is None else JHestonParams(sigma=sigma)
    m, m2 = jmesh.sharded_moments(jmesh.make_mesh(jax.devices()[:8]),
                                  p.as_array(), seed=1234,
                                  epoch=kw.pop("epoch", 0), **kw)
    return float(m), float(m2)


def _port(world, pv=PV, epoch=0, **kw):
    parts = [rank_moments(r, world, pv, 1234, epoch, device="cpu", **kw)
             for r in range(world)]
    m, m2 = combine_moments(parts, engine=kw.get("engine", "cuda"),
                            n_paths=kw["n_paths"])
    return m.item(), m2.item()


def _close(got, want, rel):
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * abs(w), (got, want)


def _single_scan(method, n_paths, N, pv=PV, **kw):
    pidx = path_index_grid(n_paths)
    fn = fe_moments_scan if method == "fe" else em_moments_scan
    return tuple(x.item() for x in fn(pv, N, pidx, 0, *K01, **kw))


@pytest.mark.parametrize("method", ["fe", "em"])
def test_sharded_matches_single_device(method):
    n_paths, N = 8192, 20
    kw = dict(poisson_cut=FAST_POISSON_CUT) if method == "em" else {}
    got = _port(8, N=N, n_paths=n_paths, method=method, engine="scan")
    _close(got, _single_scan(method, n_paths, N, **kw), SINGLE_REL)
    _close(got, _jax_sharded(N=N, n_paths=n_paths, method=method,
                             engine="scan"), JAX_REL)


def test_sharded_n_paths_validation():
    with pytest.raises(ValueError, match="multiple of 128"):
        rank_moments(0, 8, PV, 1, 0, N=4, n_paths=128 * 3, method="fe",
                     engine="scan", device="cpu")


def test_two_device_mesh():
    got = _port(2, N=20, n_paths=8192, method="fe", engine="scan")
    _close(got, _single_scan("fe", 8192, 20), SINGLE_REL)
    _close(got, _jax_sharded(N=20, n_paths=8192, method="fe",
                             engine="scan"), JAX_REL)


def test_sharded_fe_cuda_engine_plain_on_cpu():
    """FE + engine='cuda' (K1 on a card; its plain version here): each
    rank launches at its base_path."""
    got = _port(8, N=16, n_paths=4096, method="fe", engine="cuda")
    single = fe_moments_cuda(PV, K01, 0, 0, N=16, n_paths=4096,
                             device="cpu")
    _close(got, [x.item() for x in single], SINGLE_REL)
    _close(got, _jax_sharded(N=16, n_paths=4096, method="fe",
                             engine="scan"), JAX_REL)


@pytest.mark.parametrize("kw,match", [
    (dict(method="em", engine="scan", rng="threefry"), "philox"),
    (dict(method="fe", engine="scan", rng="tpu"), "device"),
    (dict(method="fe", engine="cuda", rng="tpu"), "device"),
    (dict(method="fe", engine="scan", rng="device"), "cuda"),
    (dict(method="fe", engine="cuda", rng="xorwow"), "engine='scan' only"),
    (dict(method="fe", engine="scan", rng="mrg32k3a", rot=4),
     "no rot variants"),
    (dict(method="fe", engine="scan", rng="xorwow", n_paths=1 << 31),
     "n_paths < 2"),
    (dict(method="fe", engine="scan", rng="xorwow", epoch=1 << 27),
     "epochs per"),
    (dict(method="fe", engine="cuda", scramble="owen"),
     "engine='qmc' only"),
    (dict(method="fe", engine="pallas"), "unknown engine"),
    (dict(method="fe", engine="cuda", rot=4, conditional=True),
     "conditional is EM-only"),
    (dict(method="em", engine="cuda", rot=4), "rot is FE-only"),
    (dict(method="fe", engine="cuda", poisson_cut=128.0), "EM-only"),
    (dict(method="fe", engine="cuda", n_paths=1 << 33), "2\\^32"),
    (dict(method="xx", engine="cuda"), "unknown method"),
])
def test_sharded_rejects_bad_combos(kw, match):
    """Every check of nmch_tpu's sharded_moments (mesh.py:68-123), in its
    words with the port's names, at world 8; also base_path + paths per
    rank within 2^32 and the method's name."""
    kw = dict(N=4, n_paths=1024, **kw) if "n_paths" not in kw \
        else dict(N=4, **kw)
    epoch = kw.pop("epoch", 0)
    with pytest.raises(ValueError, match=match):
        rank_moments(0, 8, PV, 1, epoch, device="cpu", **kw)
    if "rng" in kw and kw["rng"] in ("threefry", "tpu") \
            and kw["engine"] == "scan":
        # nmch_tpu refuses the same combination (its words name pallas)
        with pytest.raises(ValueError):
            jmesh.sharded_moments(jmesh.make_mesh(jax.devices()[:8]),
                                  JHestonParams().as_array(), seed=1,
                                  epoch=0, **kw)


def test_sharded_scan_threefry_respects_rng():
    got = _port(8, N=16, n_paths=4096, method="fe", engine="scan",
                rng="threefry")
    _close(got, _single_scan("fe", 4096, 16, rng="threefry"), SINGLE_REL)
    _close(got, _jax_sharded(N=16, n_paths=4096, method="fe",
                             engine="scan", rng="threefry"), JAX_REL)
    ph = _port(8, N=16, n_paths=4096, method="fe", engine="scan")
    assert got[0] != ph[0]


def test_sharded_em_cuda_engine_plain_on_cpu():
    """EM + engine='cuda' runs the EM kernel's plain version per rank
    (not the FE one, not the scan)."""
    got = _port(8, N=8, n_paths=2048, method="em", engine="cuda")
    single = em_moments_cuda(PV, K01, 0, 0, N=8, n_paths=2048, device="cpu",
                             poisson_cut=FAST_POISSON_CUT)
    _close(got, [x.item() for x in single], SINGLE_REL)
    _close(got, _jax_sharded(N=8, n_paths=2048, method="em",
                             engine="scan"), JAX_REL)


def test_sharded_rot4_matches_single():
    single = tuple(x.item() for x in fe_moments_rot_scan(
        PV, 16, path_index_grid(4096), 0, *K01, rng="philox", rot=4))
    want = _jax_sharded(N=16, n_paths=4096, method="fe", engine="scan",
                        rot=4)
    for engine in ("scan", "cuda"):
        got = _port(8, N=16, n_paths=4096, method="fe", engine=engine,
                    rot=4)
        _close(got, single, SINGLE_REL)
        _close(got, want, JAX_REL)


def test_sharded_em_conditional_matches_single():
    got = _port(8, N=8, n_paths=2048, method="em", engine="cuda",
                conditional=True)
    single = em_moments_cuda(PV, K01, 0, 0, N=8, n_paths=2048, device="cpu",
                             conditional=True, poisson_cut=FAST_POISSON_CUT)
    _close(got, [x.item() for x in single], SINGLE_REL)
    _close(got, _jax_sharded(N=8, n_paths=2048, method="em", engine="scan",
                             conditional=True), JAX_REL)


def test_sharded_qmc_matches_single():
    """Point-index ranges of the QMC engine: rank r takes points [r count,
    (r + 1) count) of every replicate, slices of the single run's set."""
    got = _port(8, epoch=3, N=16, n_paths=8 * 4096, engine="qmc")
    m1, m21 = (x.item() for x in fe_moments_qmc(PV, 3, *K01, N=16,
                                                n_paths=8 * 4096,
                                                device="cpu"))
    assert got[0] == pytest.approx(m1, rel=2e-6)
    assert got[1] == pytest.approx(m21, rel=2e-4)
    jm, jm2 = _jax_sharded(epoch=3, N=16, n_paths=8 * 4096, engine="qmc",
                           interpret=True)
    assert got[0] == pytest.approx(jm, rel=JAX_REL)
    assert got[1] == pytest.approx(jm2, rel=2e-4)


def test_sharded_qmc_validation():
    kw = dict(N=8, n_paths=8 * 16 * 8, device="cpu")
    with pytest.raises(ValueError, match="qmc"):
        rank_moments(0, 8, PV, 1, 0, method="em", engine="qmc", **kw)
    with pytest.raises(ValueError, match="rot"):
        rank_moments(0, 8, PV, 1, 0, engine="qmc", rot=4, **kw)


@pytest.mark.parametrize("rng", ["mrg32k3a", "xorwow"])
def test_sharded_stateful_family_matches_single(rng):
    """The stateful families shard by skip-ahead on the scan engine."""
    if rng == "mrg32k3a":
        from nmch_tpu_torch.ops.fe_mrg import fe_moments_mrg as single_fn
    else:
        from nmch_tpu_torch.ops.fe_xorwow import fe_moments_xorwow \
            as single_fn
    n_paths, N = 2048, 10
    got = _port(8, N=N, n_paths=n_paths, method="fe", engine="scan",
                rng=rng)
    single = single_fn(PV, N, path_index_grid(n_paths), 0, 1234)
    _close(got, [x.item() for x in single], SINGLE_REL)
    _close(got, _jax_sharded(N=N, n_paths=n_paths, method="fe",
                             engine="scan", rng=rng), JAX_REL)


def test_sharded_stateful_family_rejects_bad_combos():
    # method="em" with engine="scan" is allowed; the kernel engine (K5
    # under sharding: a lever, not taken) and rot variants are not
    for bad in ({"engine": "cuda"}, {"rot": 4}):
        kw = dict(N=4, n_paths=1024, method="fe", engine="scan",
                  rng="mrg32k3a")
        kw.update(bad)
        with pytest.raises(ValueError):
            rank_moments(0, 8, PV, 1, 0, device="cpu", **kw)
    got = _port(8, N=4, n_paths=1024, method="em", engine="scan",
                rng="xorwow")
    single = em_moments_scan(PV, 4, path_index_grid(1024), 0, *K01,
                             rng="xorwow", poisson_cut=FAST_POISSON_CUT,
                             seed=1234)
    _close(got, [x.item() for x in single], SINGLE_REL)


def test_sharded_em_default_poisson_cut_matches_method_layer():
    """The default cut is NMCH_EM's FAST_POISSON_CUT, not the ops layer's
    4000 (sigma=0.05 puts lambda between the two at N=8)."""
    p = HestonParams(sigma=0.05)
    pv = p.as_tensor("cpu")
    n_paths, N = 2048, 8
    got = _port(8, pv=pv, N=N, n_paths=n_paths, method="em", engine="scan")
    fast = _single_scan("em", n_paths, N, pv=pv,
                        poisson_cut=FAST_POISSON_CUT)
    curand = _single_scan("em", n_paths, N, pv=pv, poisson_cut=None)
    _close(got, fast, SINGLE_REL)
    assert fast[0] != curand[0]          # the regimes do differ
    _close(got, _jax_sharded(sigma=0.05, N=N, n_paths=n_paths, method="em",
                             engine="scan"), JAX_REL)
    with pytest.raises(ValueError, match="EM-only"):
        rank_moments(0, 8, pv, 1, 0, N=4, n_paths=1024, method="fe",
                     engine="scan", poisson_cut=128.0, device="cpu")


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    got = sharded_moments(mesh, PV, 1234, 0, N=16, n_paths=4096)
    single = fe_moments_cuda(PV, K01, 0, 0, N=16, n_paths=4096,
                             device="cpu")
    assert [x.item() for x in got] == [x.item() for x in single]
    assert all(x.dtype == torch.float64 and x.dim() == 0 for x in got)
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(group=object(), device="cpu")


def test_mesh_of_world_eight_refuses_a_bad_rank_and_qmc_needs_paths():
    with pytest.raises(ValueError, match="rank=8"):
        rank_moments(8, 8, PV, 1, 0, N=4, n_paths=1024, device="cpu")
    with pytest.raises(ValueError, match="n_paths"):
        combine_moments([torch.zeros(8, dtype=torch.float64)],
                        engine="qmc")


@pytest.mark.parametrize("engine", ["cuda", "qmc"])
def test_prewarm_on_the_cpu(engine):
    """prewarm(device="cpu") runs the family's plain versions (no build);
    block=False returns the thread, which ends."""
    assert prewarm(engine=engine, device="cpu") is None
    t = prewarm(engine=engine, device="cpu", block=False)
    t.join(timeout=120)
    assert not t.is_alive()
    with pytest.raises(ValueError, match="unknown engine"):
        prewarm(engine="pallas", device="cpu")


def test_scale_out_modules_import_without_jax():
    """The slice's modules import neither jax nor nmch_tpu (a fresh
    interpreter, so this file's own imports do not count)."""
    mods = ("nmch_tpu_torch.parallel.mesh, nmch_tpu_torch.utils.prewarm, "
            "nmch_tpu_torch.native, nmch_tpu_torch.examples.multichip, "
            "nmch_tpu_torch.examples.multihost, "
            "nmch_tpu_torch.examples.quickstart")
    code = (f"import sys, {mods}; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'nmch_tpu' not in sys.modules, 'nmch_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
