"""Forward-Euler Heston scheme: the step math and the plain PyTorch goldens.

The counterpart of ``nmch_tpu/ops/fe.py``: the counter generators
philox, threefry and threefry4, rotation sampling (rot 1, 2, 4, 8), and
``fe_moments_kernel_plain``, the plain version of the kernel
``csrc/fe.cu`` in the form of ``nmch_tpu/ops/fe_pallas.py::_fe_kernel``
(every box, ``fast_sqrt`` and the card's device generator).
Per time step, with correlated standard normals (G1, G2)
(reference README.md:30-40, ``src/NMCH/methods/NMCH_FE.cu:41-48``):

    S <- S + r S dt + sqrt(v) S sqrt(dt) (rho G1 + sqrt(1-rho^2) G2)
    v <- | v + k (theta - v) dt + sigma sqrt(v) sqrt(dt) G1 |

RNG consumption contract (shared with the CUDA kernels ``csrc/fe.cu``
and ``csrc/sweep.cu``): counter block ``j`` of each path's stream
yields 4 u32 words -> 4 normals (3 words with the device generator's
packed boxes hc16/hc16f); normals (0, 1) drive step ``2j`` and (2, 3)
drive step ``2j+1``.  For odd N the final half-block is skipped.  With
rot > 1 each stream drives a group of rot coupled paths, copy t on
``rotation_images(g0, g1, rot)[t]``, and the sample is the group mean.

Layout: paths live in (n_paths/128, 128) tensors, path index =
row * 128 + lane, as in the JAX package.  Every float operation is a
separate float32 PyTorch op in the JAX code's order, so this is the
plain version the kernel is held against; the moments are summed in
float64, as the kernel's reduction is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rng.device import device_call, packed_blocks
from ..rng.normal import normal4_from_bits, normal4_from_bits3, sqrt_f32
from ..rng.philox import MASK32, philox4x32
from ..rng.threefry import draw4_threefry
from ..rng.threefry4 import draw4_threefry4

LANES = 128
# the normal constructions (csrc/fe_path.cuh::NormalBox order): 4 words a
# counter block, or 3 for the device stream's packed hc16/hc16f
BOXES = ("hc", "turns", "hc16", "hc16f")
DEVICE_NOT_TPU = ("rng='tpu' is the TPU's hardware generator, which has "
                  "no counterpart on the card; use rng='device', the "
                  "card's own deterministic stream (rng/device.py)")


def path_index_grid(n_paths: int, base: int = 0, device="cpu"):
    """(n_paths/128, 128) u32 path indices (int64), offset by ``base``."""
    if n_paths % LANES:
        raise ValueError(f"n_paths={n_paths} must be a multiple of {LANES}")
    idx = torch.arange(n_paths, dtype=torch.int64, device=device)
    return ((idx + int(base)) & MASK32).reshape(n_paths // LANES, LANES)


def fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt):
    """Loop-invariant constants of ``fe_step``:

        S <- S * (one_rdt + sqrt(v) * (rho_sd g1 + rhoc_sd g2))
        v <- | B v + A + sqrt(v) * (C g1) |

    Returns (A, B, C, rho_sd, rhoc_sd, one_rdt), each a float32 value
    rounded as ``nmch_tpu.ops.fe.fe_consts`` rounds it."""
    return (k * theta * dt,              # A
            1.0 - k * dt,                # B
            sigma * sqrt_dt,             # C
            rho * sqrt_dt,               # rho_sd
            sqrt_rho_c * sqrt_dt,        # rhoc_sd
            1.0 + r * dt)                # one_rdt


def fe_params_consts(params_vec, N: int):
    """(S_0, v_0, fe_consts) of a parameter vector at N steps: dt = T/N,
    sqrt_dt = sqrt(dt), in the JAX code's float32 order."""
    T, S_0, v_0, r, k, rho, theta, sigma = params_vec.unbind()
    dt = T / N
    sqrt_dt = sqrt_f32(dt)
    sqrt_rho_c = sqrt_f32(1.0 - rho * rho)
    return S_0, v_0, fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt,
                               sqrt_dt)


def fe_step(S, v, g1, g2, cst):
    """One Euler step: 8 float32 ops and one sqrt per path."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    sqv = sqrt_f32(v)
    zc = rho_sd * g1 + rhoc_sd * g2
    S = S * (one_rdt + sqv * zc)
    v = torch.abs(B * v + A + sqv * (C * g1))
    return S, v


def make_draw4(rng: str, path_lo, path_hi, epoch, k0, k1):
    """Block index -> 4 u32 words of each path's stream: philox and
    threefry4 at counter (block, epoch, path_lo, path_hi), threefry
    (``rng/threefry.py``) at (block, path_lo) under epoch-derived keys,
    and the card's device stream (``rng/device.py``), whose path_hi
    word is its tag."""
    if rng == "philox":
        return lambda j: philox4x32(j, epoch, path_lo, path_hi, k0, k1)
    if rng == "threefry4":
        return lambda j: draw4_threefry4(j, epoch, path_lo, k0, k1,
                                         path_hi=path_hi)
    if rng == "threefry":
        return lambda j: draw4_threefry(j, epoch, path_lo, k0, k1)
    if rng == "device":
        return lambda j: device_call(j, epoch, path_lo, k0, k1)
    if rng == "tpu":
        raise ValueError(DEVICE_NOT_TPU)
    raise ValueError(f"unknown counter rng {rng!r} (expected 'philox', "
                     f"'threefry', 'threefry4' or 'device')")


def fe_terminal(params_vec, N: int, path_idx, epoch, k0, k1,
                rng: str = "philox"):
    """Simulate all paths to maturity; returns (S_T, v_T) in the layout of
    ``path_idx``.  params_vec: f32[8] = (T, S_0, v_0, r, k, rho, theta,
    sigma) on the device of ``path_idx``.

    The parameters and ``epoch`` may also carry leading point axes that
    broadcast against ``path_idx`` (``ops/sweep.py``: params (8, P, 1,
    1), epoch (P, 1, 1), path_idx (R, 128)); every float operation is
    then the single-point one, elementwise."""
    draw = make_draw4(rng, path_idx, torch.zeros_like(path_idx), epoch,
                      k0, k1)
    return euler_paths(params_vec, N, path_idx,
                       lambda j: normal4_from_bits(*draw(j)))


def euler_paths(params_vec, N: int, like: torch.Tensor, normals4):
    """(S_T, v_T) of paths laid out like ``like`` (its shape and device):
    ``normals4(j)`` gives the 4 normals of counter block j, for steps 2j
    and 2j+1, and is called for j = 0, 1, ... in order."""
    Ss, vs = euler_rot_paths(params_vec, N, like, normals4, rot=1)
    return Ss[0], vs[0]


def moments_f64(payoff: torch.Tensor):
    """(E[X], E[X^2]) as float64 0-dim tensors: payoff and payoff^2 in
    float32, summed in float64, as the kernels' reduction is."""
    n = payoff.numel()
    return (payoff.double().sum() / n,
            (payoff * payoff).double().sum() / n)


def mean_f32(x: torch.Tensor) -> torch.Tensor:
    """sum(x) / x.numel() in float32, a true division (torch on a card
    multiplies by the reciprocal of a Python divisor)."""
    return x.sum() / torch.tensor(float(x.numel()), device=x.device)


def fe_moments_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                    rng: str = "philox"):
    """Golden engine: (E[X], E[X^2]) with X = (S_T - K)^+, K = S_0, as
    float64 0-dim tensors (``moments_f64``)."""
    S_T, _ = fe_terminal(params_vec, N, path_idx, epoch, k0, k1, rng=rng)
    return moments_f64(torch.clamp_min(S_T - params_vec[1], 0.0))


# --- rotation sampling (nmch_tpu/ops/fe.py:176-375) -----------------------

def _f32(x) -> float:
    return float(np.float32(x))


_SIXTH = _f32(1.0 / 6.0)
_M24TH = _f32(-1.0 / 24.0)
_TAYLOR_MAX = _f32(0.01)       # 1 - e^-t by its Taylor polynomial below
_ASYMPTOTE_MIN = _f32(10.0)    # -ln(1 - e^-t) by e^-t above
_T_FLOOR = _f32(1e-35)
_LOG_FLOOR = _f32(1e-38)
_RSQRT_FLOOR = _f32(1e-35)


def radius_antithetic_scale(a, b):
    """s such that (s a, s b) is the radius-antithetic image of the
    isotropic normal pair (a, b): with t = (a^2 + b^2)/2 the radius
    uniform is u = e^-t, and s = sqrt(-ln(1 - e^-t) / t) maps u to 1 - u
    at the same angle.  For t < 0.01, 1 - e^-t is its Taylor polynomial;
    for t > 10, -ln(1 - e^-t) is e^-t (``nmch_tpu.ops.fe``'s f32 care).
    exp and log are torch's: libdevice's expf/logf on the card, as in
    the kernel; on the CPU not XLA's (within 2 ulp of ``nmch_tpu``)."""
    t = torch.clamp_min((a * a + b * b) * 0.5, _T_FLOOR)
    emt = torch.exp(-t)
    poly = t * (1.0 + t * (-0.5 + t * (_SIXTH + t * _M24TH)))
    em = torch.where(t < _TAYLOR_MAX, poly, 1.0 - emt)
    lg = torch.where(t > _ASYMPTOTE_MIN, emt,
                     -torch.log(torch.clamp_min(em, _LOG_FLOOR)))
    return sqrt_f32(lg / t)


def rotation_images(a, b, rot: int):
    """The ``rot`` distribution-preserving images of an iid normal pair:
    (a, b), (-a, -b) (rot 2, antithetic), (b, -a), (-b, a) (rot 4,
    quarter turns), then the quarter turns of the radius-antithetic
    image (s a, s b) (rot 8)."""
    imgs = [(a, b), (-a, -b), (b, -a), (-b, a)]
    if rot > 4:
        s = radius_antithetic_scale(a, b)
        c = s * a
        d = s * b
        imgs += [(c, d), (-c, -d), (d, -c), (-d, c)]
    return imgs[:rot]


def fe_rot_group_step(Ss, vs, a, b, cst, rot: int, fast_sqrt: bool = False,
                      scale=None):
    """One Euler step of ``rot`` coupled copies: copy t on
    ``rotation_images(a, b, rot)[t]``, with the two draw-dependent
    quantities of a step (zc = rho_sd g1 + rhoc_sd g2 and C g1) computed
    once per pair as za, zs, ca, cb and signed per copy (rot 8 scales
    them by s, the radius-antithetic scale, or ``scale`` where the normal
    construction supplies it).  At rot=1 this is ``fe_step``, operation
    for operation.  fast_sqrt takes sqrt(v) as v * rsqrt(max(v, 1e-35))
    (torch's rsqrt: libdevice's rsqrtf on the card)."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    za = rho_sd * a + rhoc_sd * b
    ca = C * a
    specs = [(za, ca, True), (za, ca, False)]
    if rot > 2:
        zs = rho_sd * b - rhoc_sd * a
        cb = C * b
        specs += [(zs, cb, True), (zs, cb, False)]
    if rot > 4:
        s_ = radius_antithetic_scale(a, b) if scale is None else scale
        sza, sca, szs, scb = s_ * za, s_ * ca, s_ * zs, s_ * cb
        specs += [(sza, sca, True), (sza, sca, False),
                  (szs, scb, True), (szs, scb, False)]
    outS, outv = [], []
    for t in range(rot):
        zc, cg, pos = specs[t]
        v = vs[t]
        if fast_sqrt:
            sqv = v * torch.rsqrt(torch.clamp_min(v, _RSQRT_FLOOR))
        else:
            sqv = sqrt_f32(v)
        if pos:
            outS.append(Ss[t] * (one_rdt + sqv * zc))
            outv.append(torch.abs(B * v + A + sqv * cg))
        else:
            outS.append(Ss[t] * (one_rdt - sqv * zc))
            outv.append(torch.abs(B * v + A - sqv * cg))
    return outS, outv


def rot_two_steps(Ss, vs, normals, j: int, cst, N: int, rot: int,
                  fast_sqrt: bool = False):
    """Steps 2j and 2j+1 of all copies from counter block j's normals
    (g0, g1, g2, g3), or (g0, g1, g2, g3, scale0, scale1) from the
    with_scale construction; the second step is skipped when 2j+1 >= N
    (the odd-N tail, for every copy)."""
    g0, g1, g2, g3 = normals[:4]
    sc0, sc1 = normals[4:] if len(normals) == 6 else (None, None)
    Ss, vs = fe_rot_group_step(Ss, vs, g0, g1, cst, rot, fast_sqrt, sc0)
    if 2 * j + 1 < N:
        Ss, vs = fe_rot_group_step(Ss, vs, g2, g3, cst, rot, fast_sqrt, sc1)
    return Ss, vs


def fe_rot_block_body(j: int, Ss, vs, path_lo, path_hi, epoch, k0, k1,
                      cst, N: int, rot: int, rng: str = "philox"):
    """Advance the ``rot`` copies through steps 2j and 2j+1 from counter
    block j of the stream (the same draws as rot=1)."""
    bits = make_draw4(rng, path_lo, path_hi, epoch, k0, k1)(j)
    return rot_two_steps(Ss, vs, normal4_from_bits(*bits), j, cst, N, rot)


def _start(params_vec, N: int, like: torch.Tensor, rot: int):
    """The rot copies' (S, v) at t = 0, and the step constants."""
    S_0, v_0, cst = fe_params_consts(params_vec, N)
    ones = torch.full(like.shape, 1.0, device=like.device)
    return [ones * S_0] * rot, [ones * v_0] * rot, cst


def euler_rot_paths(params_vec, N: int, like: torch.Tensor, normals,
                    rot: int, fast_sqrt: bool = False):
    """(S_T, v_T) of each of the ``rot`` copies of path groups laid out
    like ``like``, as two lists: ``normals(j)`` gives counter block j's
    normals (``rot_two_steps``), called for j = 0, 1, ... in order."""
    Ss, vs, cst = _start(params_vec, N, like, rot)
    for j in range((N + 1) // 2):
        Ss, vs = rot_two_steps(Ss, vs, normals(j), j, cst, N, rot, fast_sqrt)
    return Ss, vs


def group_payoff(Ss, K, rot: int):
    """The group mean payoff: max(S_0 - K, 0) + ... + max(S_{rot-1} - K,
    0), added in copy order, times float32(1/rot)."""
    y = torch.clamp_min(Ss[0] - K, 0.0)
    for S in Ss[1:]:
        y = y + torch.clamp_min(S - K, 0.0)
    return y * _f32(1.0 / rot) if rot > 1 else y


def fe_moments_rot_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                        rng: str = "philox", rot: int = 2):
    """Rotation-sampling golden: (E[Y], E[Y^2]) over the group means Y of
    ``rot`` coupled copies per stream, as float64 0-dim tensors
    (``moments_f64``); n is the number of groups."""
    if rot not in (2, 4, 8):
        raise ValueError(f"rot must be 2, 4 or 8, got {rot}")
    Ss, vs, cst = _start(params_vec, N, path_idx, rot)
    path_hi = torch.zeros_like(path_idx)
    for j in range((N + 1) // 2):
        Ss, vs = fe_rot_block_body(j, Ss, vs, path_idx, path_hi, epoch, k0,
                                   k1, cst, N, rot, rng=rng)
    return moments_f64(group_payoff(Ss, params_vec[1], rot))


def fe_moments_antithetic_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                               rng: str = "philox"):
    """Antithetic variates: rotation sampling with rot=2."""
    return fe_moments_rot_scan(params_vec, N, path_idx, epoch, k0, k1,
                               rng=rng, rot=2)


def fe_moments_kernel_plain(params, seed_words, epoch, base_path, *, N: int,
                            n_paths: int, rng: str = "philox", rot: int = 1,
                            box: str = "hc", fast_sqrt: bool = False):
    """(E[Y], E[Y^2]) over n_paths path groups as float64 0-dim tensors:
    the plain version of the kernel ``csrc/fe.cu``, in the form of
    ``nmch_tpu/ops/fe_pallas.py::_fe_kernel`` (its ``draw_iter`` and
    ``block_steps``), on the device of ``params``.

    params: float32 (8,); seed_words: the (k0, k1) u32 key; group p
    draws from path base_path + p of the stream at ``epoch``.  rng:
    philox, threefry, threefry4 or device; box: hc or turns (4 words a
    block), or, with rng="device", the packed hc16 / hc16f (3 words a
    block, hc16f with the fast polynomials), which at rot > 4 also give
    each pair's radius-antithetic scale (``with_scale``); the other
    rot-8 groups take ``radius_antithetic_scale`` of the pair.  The
    caller validates the combination (``ops/fe_cuda.py::check_variant``).
    For the counter generators with box hc this equals
    ``fe_moments_rot_scan`` (rot > 1) and ``fe_moments_scan`` (rot=1)
    bitwise."""
    k0, k1 = (int(w) for w in seed_words)
    path = path_index_grid(n_paths, base_path, params.device)
    if rng == "device" and box in ("hc16", "hc16f"):
        block = packed_blocks(epoch, path, k0, k1)
        fast, with_scale = box == "hc16f", rot > 4

        def normals(j):
            return normal4_from_bits3(*block(j), fast=fast,
                                      with_scale=with_scale)
    else:
        draw = make_draw4(rng, path, torch.zeros_like(path), epoch, k0, k1)

        def normals(j):
            return normal4_from_bits(*draw(j), box=box)
    Ss, _ = euler_rot_paths(params, N, path, normals, rot, fast_sqrt)
    return moments_f64(group_payoff(Ss, params[1], rot))
