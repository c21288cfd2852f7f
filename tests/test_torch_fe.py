"""FE golden and kernel wrapper of the PyTorch port against nmch_tpu.

Per path, the torch golden and nmch_tpu's jitted scan do not agree
bitwise (XLA compiles the loop and rounds differently: max rel 6.3e-5 on
S_T at N=100), but the moments do, at rel 1e-5 (measured worst 2e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmch_tpu.ops import fe as jfe
from nmch_tpu.ops.fe_pallas import fe_moments_pallas
from nmch_tpu.params import HestonParams as JHestonParams
from nmch_tpu.rng.philox import split_seed
from nmch_tpu_torch.ops import fe as tfe
from nmch_tpu_torch.ops.fe_cuda import fe_moments_cuda

torch.set_num_threads(2)

REL = 1e-5
PARAMS = [JHestonParams(), JHestonParams(k=2.0, theta=0.05, sigma=0.6,
                                         rho=0.3, r=0.05, v_0=0.2, T=0.5)]


@functools.lru_cache(maxsize=None)
def _jax_scan():
    return jax.jit(jfe.fe_moments_scan, static_argnums=(1, 6))


def _pv(p: JHestonParams) -> torch.Tensor:
    return torch.from_numpy(np.array(p.as_array()))


def _rel(a, b) -> float:
    return max(abs(float(x) - float(y)) / abs(float(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("N,n_paths,epoch,base,pi", [
    (100, 1024, 0, 0, 0),
    (100, 1024, 3, 4096, 1),
    (101, 2048, 0, 0, 0),
    (101, 2048, 5, 1 << 20, 1),
])
def test_moments_match_nmch_tpu_scan(N, n_paths, epoch, base, pi):
    p = PARAMS[pi]
    k0, k1 = split_seed(1234 + pi)
    want = _jax_scan()(p.as_array(), N, jfe.path_index_grid(n_paths, base),
                       jnp.uint32(epoch), k0, k1)
    got = tfe.fe_moments_scan(_pv(p), N, tfe.path_index_grid(n_paths, base),
                              epoch, k0, k1)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("N,epoch,base,pi", [
    (100, 0, 0, 0),
    (101, 5, 1 << 20, 1),
])
def test_threefry4_moments_match_nmch_tpu_scan(N, epoch, base, pi):
    p = PARAMS[pi]
    k0, k1 = split_seed(99 + pi)
    want = _jax_scan()(p.as_array(), N, jfe.path_index_grid(1024, base),
                       jnp.uint32(epoch), k0, k1, "threefry4")
    got = tfe.fe_moments_scan(_pv(p), N, tfe.path_index_grid(1024, base),
                              epoch, k0, k1, rng="threefry4")
    assert _rel(got, want) <= REL
    philox = tfe.fe_moments_scan(_pv(p), N, tfe.path_index_grid(1024, base),
                                 epoch, k0, k1)
    assert not torch.equal(got[0], philox[0])   # another stream


@pytest.mark.parametrize("N", [11, 12])
def test_moments_match_nmch_tpu_pallas_interpret(N):
    p = PARAMS[0]
    k0, k1 = split_seed(7)
    want = fe_moments_pallas(p.as_array(), jnp.stack([k0, k1]),
                             jnp.uint32(2), jnp.uint32(256), N=N,
                             n_paths=256, interpret=True)
    got = tfe.fe_moments_scan(_pv(p), N, tfe.path_index_grid(256, 256), 2,
                              k0, k1)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("pi", [0, 1])
def test_fe_consts_bitwise_f32(pi):
    """fe_consts (and the dt/sqrt inputs) round exactly as JAX's float32
    scalars do — the constants the CUDA kernel also builds in f32."""
    pv = _pv(PARAMS[pi])
    T, S_0, v_0, r, k, rho, theta, sigma = pv.unbind()
    dt = T / 100
    sqrt_dt = torch.sqrt(dt.double()).float()
    sqrt_rho_c = torch.sqrt((1.0 - rho * rho).double()).float()
    got = tfe.fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)

    f = np.float32
    jv = [f(x) for x in PARAMS[pi].as_array()]
    jdt = jnp.float32(jv[0]) / jnp.float32(100)
    jsq = jnp.sqrt(jdt)
    jrc = jnp.sqrt(jnp.float32(1.0) - jnp.float32(jv[5]) * jnp.float32(jv[5]))
    want = jfe.fe_consts(*(jnp.float32(jv[i]) for i in (3, 4, 6, 7, 5)),
                         jrc, jdt, jsq)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.float32(g.item()).view(np.uint32) == \
            np.asarray(w, np.float32).view(np.uint32)


def test_path_index_grid_matches_and_wraps():
    for base in (0, 4096, 2**32 - 100):
        want = np.asarray(jfe.path_index_grid(256, base)).astype(np.int64)
        np.testing.assert_array_equal(
            tfe.path_index_grid(256, base).numpy(), want)
    with pytest.raises(ValueError):
        tfe.path_index_grid(100)


def test_make_draw4_refuses_other_rngs():
    with pytest.raises(ValueError, match="unknown counter rng 'xorwow'"):
        tfe.make_draw4("xorwow", None, None, 0, 0, 0)
    with pytest.raises(ValueError, match="use rng='device'"):
        tfe.make_draw4("tpu", None, None, 0, 0, 0)
    with pytest.raises(ValueError, match="unknown counter rng"):
        tfe.make_draw4("bogus", None, None, 0, 0, 0)


@pytest.mark.parametrize("N,base", [(9, 0), (10, 384)])
def test_wrapper_on_cpu_is_the_plain_version_bitwise(N, base):
    _wrapper_is_plain(N, base, "philox")


def test_threefry4_wrapper_on_cpu_is_the_plain_version_bitwise():
    _wrapper_is_plain(9, 384, "threefry4")


@pytest.mark.parametrize("kw", [
    {"rng": "threefry", "antithetic": True},
    {"rng": "device", "rot": 8, "box": "hc16f", "fast_sqrt": True},
    {"rng": "philox", "rot": 4, "box": "turns"}])
def test_variant_wrapper_on_cpu_is_the_kernel_plain_bitwise(kw):
    """fe_moments_cuda on CPU tensors is fe_moments_kernel_plain, with
    antithetic resolved to rot 2, and launches nothing."""
    pv = _pv(PARAMS[1])
    before = (fe_moments_cuda.launches,
              dict(fe_moments_cuda.variant_launches))
    got = fe_moments_cuda(pv, (5, 6), 1, 128, N=9, n_paths=256,
                          device="cpu", **kw)
    plain_kw = dict(kw, rot=kw.get("rot", 2))
    plain_kw.pop("antithetic", None)
    want = tfe.fe_moments_kernel_plain(pv, (5, 6), 1, 128, N=9,
                                       n_paths=256, **plain_kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert before == (fe_moments_cuda.launches,
                      fe_moments_cuda.variant_launches)


def _wrapper_is_plain(N, base, rng):
    pv = _pv(PARAMS[0])
    key = split_seed(42)
    before = fe_moments_cuda.launches
    variants = dict(fe_moments_cuda.variant_launches)
    got = fe_moments_cuda(pv, key, 3, base, N=N, n_paths=512, device="cpu",
                          rng=rng)
    want = tfe.fe_moments_scan(pv, N, tfe.path_index_grid(512, base), 3,
                               *key, rng=rng)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.float64
    assert fe_moments_cuda.launches == before   # no kernel was launched
    assert fe_moments_cuda.variant_launches == variants


@pytest.mark.parametrize("kwargs,match", [
    ({"params": torch.zeros(8, dtype=torch.float64)}, "float32"),
    ({"params": torch.zeros(7)}, "shape"),
    ({"N": 0}, "N="),
    ({"n_paths": 200}, "multiple of 128"),
    ({"epoch": 2**32}, "uint32"),
    ({"base_path": -1}, "uint32"),
    ({"seed_words": (2**32, 0)}, "uint32"),
    ({"device": "meta"}, "neither cpu nor cuda"),
    ({"rng": "tpu"}, "use rng='device'"),
    ({"rng": "threefry", "box": "hc16"}, "only applies to rng='device'"),
    ({"rng": "bogus"}, "unknown rng 'bogus'"),
    ({"rng": "xorwow"}, "unknown rng 'xorwow'"),
    ({"rng": "threefry4", "fast_sqrt": True}, "fast_sqrt=True"),
    ({"box": "hc16f"}, "packed 16-bit phases"),
    ({"box": "polar"}, "unknown box"),
    ({"rot": 3}, "rot must be 1, 2, 4 or 8"),
    ({"rot": 1, "antithetic": True}, "contradicts rot=1"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    args = dict(params=_pv(PARAMS[0]), seed_words=(1, 2), epoch=0,
                base_path=0, N=4, n_paths=128, device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        fe_moments_cuda(args.pop("params"), args.pop("seed_words"),
                        args.pop("epoch"), args.pop("base_path"), **args)
