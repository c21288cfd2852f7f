"""Quasi-Monte Carlo FE engine: scrambled Sobol' + Brownian bridge.

The counterpart of ``nmch_tpu/ops/fe_qmc.py``: integration error ~n^-0.8
instead of plain Monte Carlo's n^-0.5.  The point set is a function of
(seed, epoch, N, n_paths, scramble) alone and is bitwise ``nmch_tpu``'s
up to the normals:

1. **Dimension ordering.**  ``bb_plan`` orders the bridge nodes coarse to
   fine (node 0 drives W_T, node 1 the midpoint, ...); factor f of node k
   is Sobol' dimension 2k + f.
2. **Points.**  ``rng/sobol.py``: Joe–Kuo directions, hi/lo generation,
   randomized by ``scramble``: "lms-shift" (one linear matrix scramble
   shared by the replicates, a digital shift per replicate), "shift"
   (shifts only) or "owen" (an independent hash-based Owen scramble per
   replicate).
3. **Normals.**  The symmetric map ``pm_sign_from_words`` keeps all 30
   bits in both tails, then ``rng/normal.py::ndtri_fast_pm`` (or
   ``torch.special.ndtri`` with ndtri_mode="precise").
4. **Bridge.**  ``bb_increment_matrix`` is the bridge as a linear map,
   applied as one float32 matrix product per factor (a plain product
   that ``nmch_tpu`` leaves to XLA, here ``torch.matmul`` with TF32 off:
   TF32 keeps about three decimal digits, which biases the price);
   ``qmc_increments`` (the scatter construction) and
   ``qmc_increments_dyadic`` (O(N log N) refinement) are the
   cross-checks.
5. **Simulation.**  sim="cuda": the kernel K6 (``ops/fe_qmc_cuda.py`` ->
   ``csrc/qmc.cu``) on a card tensor, its plain version
   ``qmc_payoff_sums_plain`` on a CPU tensor; both build the FE constants
   at sqrt_dt = 1 and step on dW directly, as the TPU kernel does.
   sim="scan": ``_sim_payoff``, the scan form of ``nmch_tpu`` (dW /
   sqrt_dt into ``fe_step``), which differs from the kernel form in the
   last bits of each step.
6. **CI.**  ``n_shifts`` independently randomized replicates;
   ``rqmc_moments_from_means`` synthesizes (m, m2) so that
   ``SimResult(m, m2, n_paths).ci_error`` is the Student-t CI of the
   replicate means.

The fused bridge + simulator of ``benchmarks/qmc_fused_probe.py`` (TPU
kernels K9 and K10) has its plain version here too,
``qmc_payoff_sums_fused_plain``: the increments made from the normals
chunk by chunk, in the kernel's summation order, at the precision
"HIGHEST" (float32), "HIGH" (three bf16 hi/lo products) or "DEFAULT"
(one bf16 product); its kernel is ``ops/qmc_fused_cuda.py``.

Sums are float64 here (the payoffs are float32), where ``nmch_tpu`` sums
in float32; the chunk schedule, the 2^29-element cap per factor and the
compensated sum over chunks are ``nmch_tpu``'s.

Deliberate difference: ``nmch_tpu`` takes its scan engine on a TPU when
n_paths / n_shifts is not a multiple of 1024 (the Pallas kernel's tile);
K6 here runs at every n, so where ``nmch_tpu`` would price with the scan
form the port prices with the kernel form, a rounding-level difference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rng.normal import ndtri_fast_pm, sqrt_f32
from ..rng.philox import MASK32
from ..rng.sobol import (
    as_words, digital_shifts, direction_numbers, gray_codes,
    lms_scramble_directions, owen_scramble, owen_seeds, pm_sign_from_words,
    sobol_dims_u32, sobol_dims_u32_hilo, u01_from_words,
)
from ..utils.timing import span
from .fe import fe_consts, fe_step

# replicates of the randomized-QMC CI (the method layer's default)
DEFAULT_N_SHIFTS = 8
SCRAMBLES = ("lms-shift", "shift", "owen")
SIMS = ("cuda", "scan")
_MAX_FACTOR = 1 << 29     # elements per factor and chunk (~2 GB of float32)


def largest_divisor_leq(m: int, cap: int) -> int:
    """Largest divisor of m that is <= cap (cap >= 1)."""
    best = 1
    d = 1
    while d * d <= m:
        if m % d == 0:
            for c in (d, m // d):
                if best < c <= cap:
                    best = c
        d += 1
    return best


@functools.lru_cache(maxsize=8)
def bb_plan(N: int):
    """Brownian-bridge plan for N steps (host, cached): a list of levels,
    each a dict of numpy arrays {m, a, b, wl, wr, sig, dims}; node m is
    wl W_a + wr W_b + sig sqrt(dt) z_dims, sig in units of sqrt(dt).
    Level 0 is the terminal node, W_N = sqrt(N) z_0."""
    levels = [dict(m=np.array([N]), a=np.array([0]), b=np.array([0]),
                   wl=np.array([[0.0]], np.float32),
                   wr=np.array([[0.0]], np.float32),
                   sig=np.array([[np.sqrt(N)]], np.float32),
                   dims=np.array([0]))]
    k = 1
    segs = [(0, N)]
    while segs:
        nxt, m_, a_, b_, wl_, wr_, sg_, dm_ = [], [], [], [], [], [], [], []
        for a, b in segs:
            if b - a <= 1:
                continue
            m = (a + b) // 2
            m_.append(m)
            a_.append(a)
            b_.append(b)
            wl_.append((b - m) / (b - a))
            wr_.append((m - a) / (b - a))
            sg_.append(np.sqrt((m - a) * (b - m) / (b - a)))
            dm_.append(k)
            k += 1
            nxt += [(a, m), (m, b)]
        if m_:
            levels.append(dict(m=np.array(m_), a=np.array(a_),
                               b=np.array(b_),
                               wl=np.array(wl_, np.float32)[:, None],
                               wr=np.array(wr_, np.float32)[:, None],
                               sig=np.array(sg_, np.float32)[:, None],
                               dims=np.array(dm_)))
        segs = nxt
    assert k == N, (k, N)
    return levels


@functools.lru_cache(maxsize=8)
def bb_increment_matrix(N: int) -> np.ndarray:
    """(N, N) float32 A with dW = sqrt(dt) (A @ z): ``bb_plan``'s
    recursion run on the identity (column k is the path's response to
    z_k = 1), in units of sqrt(dt)."""
    W = np.zeros((N + 1, N), np.float64)
    for lev in bb_plan(N):
        for i in range(len(lev["m"])):
            m, a, b = int(lev["m"][i]), int(lev["a"][i]), int(lev["b"][i])
            W[m] = lev["wl"][i] * W[a] + lev["wr"][i] * W[b]
            W[m, int(lev["dims"][i])] += float(lev["sig"][i].squeeze())
    return np.ascontiguousarray((W[1:] - W[:-1]).astype(np.float32))


def _f32(T, device) -> torch.Tensor:
    return torch.as_tensor(T, dtype=torch.float32, device=device)


def _matmul_f32(A: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """A @ z in true float32: TF32 is switched off for this product (and
    the caller's setting restored)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(A, z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bridge_factor(levels, V, gray, shifts, sqrt_dt, n, N, factor):
    """W (N+1, n) of one Brownian factor from its Sobol' dimensions, node
    by node (the scatter construction; W is updated in place)."""
    dev = gray.device
    W = torch.zeros(N + 1, n, dtype=torch.float32, device=dev)
    for lev in levels:
        dims = torch.from_numpy(2 * lev["dims"] + factor).to(dev)
        x = sobol_dims_u32(gray, V[dims]) ^ shifts[dims][:, None]
        z = torch.special.ndtri(u01_from_words(x))
        wl, wr, sig = (torch.from_numpy(lev[k]).to(dev)
                       for k in ("wl", "wr", "sig"))
        a = torch.from_numpy(lev["a"]).to(dev)
        b = torch.from_numpy(lev["b"]).to(dev)
        W[torch.from_numpy(lev["m"]).to(dev)] = \
            wl * W[a] + wr * W[b] + (sig * sqrt_dt) * z
    return W


def qmc_increments(N: int, n: int, epoch, k0, k1, T, v_np=None, *,
                   device):
    """(N, n) increments (dW1, dW2) by Sobol' + the scatter bridge, one
    digital shift per dimension (the reference construction; the engine
    uses ``qmc_increments_mxu``, which has the same law)."""
    V = as_words(direction_numbers(2 * N) if v_np is None else v_np, device)
    gray = gray_codes(n, device=device)
    shifts = digital_shifts(torch.arange(2 * N, device=device), epoch,
                            k0, k1)
    sqrt_dt = sqrt_f32(_f32(T, device) / N)
    levels = bb_plan(N)
    dws = []
    for f in (0, 1):
        W = _bridge_factor(levels, V, gray, shifts, sqrt_dt, n, N, f)
        dws.append(W[1:] - W[:-1])
    return dws[0], dws[1]


def qmc_normals_mxu(D: int, n: int, epoch, k0, k1, v_np=None,
                    n_shifts: int = 1, scramble: str = "lms-shift",
                    base: int = 0, ndtri_mode: str = "fast", *, device):
    """(z1, z2): the (D, n_shifts * n) bridge-ordered unit normals of D
    bridge nodes per factor (Sobol' dimensions 2k + f) at points
    base..base+n-1 of each replicate, replicate-major along the point
    axis (replicate r's randomization key is epoch * n_shifts + r): what
    ``qmc_increments_mxu`` multiplies by the bridge matrix (D = N) and
    ``qmc_increments_dyadic`` refines (D = Npad).  The span
    ``prepare.points`` covers the directions, the words, the scrambles and
    the normals."""
    if scramble not in SCRAMBLES:
        raise ValueError(f"unknown scramble {scramble!r}")
    if ndtri_mode not in ("fast", "precise"):
        raise ValueError(f"unknown ndtri_mode {ndtri_mode!r}")
    with span("prepare.points"):
        V = as_words(direction_numbers(2 * D) if v_np is None else v_np,
                     device)
        if scramble == "lms-shift":
            # one linear scramble shared by the replicates, each then
            # digitally shifted (the shifts alone unbias each replicate)
            V = lms_scramble_directions(V, epoch, k0, k1)
        reps = ((int(epoch) * n_shifts)
                + torch.arange(n_shifts, device=device)) & MASK32
        dim_idx = torch.arange(2 * D, device=device)[:, None]
        if scramble == "owen":
            keys = owen_seeds(dim_idx, reps[None, :], k0, k1)       # (2D, R)
        else:
            shifts = digital_shifts(dim_idx, reps[None, :], k0, k1)  # (2D, R)
        zs = []
        for f in (0, 1):
            dims = torch.arange(D, device=device) * 2 + f
            x = sobol_dims_u32_hilo(n, V[dims], base=base)           # (D, n)
            if scramble == "owen":
                xs = owen_scramble(x[:, None, :], keys[dims][:, :, None])
            else:
                xs = x[:, None, :] ^ shifts[dims][:, :, None]      # (D,R,n)
            del x
            pm, neg = pm_sign_from_words(xs.reshape(D, n_shifts * n))
            del xs
            g = ndtri_fast_pm(pm) if ndtri_mode == "fast" \
                else -torch.special.ndtri(pm)
            zs.append(torch.where(neg, -g, g))
        return zs[0], zs[1]


def qmc_increments_mxu(N: int, n: int, epoch, k0, k1, T, v_np=None,
                       n_shifts: int = 1, scramble: str = "lms-shift",
                       base: int = 0, ndtri_mode: str = "fast", *, device):
    """(N, n_shifts * n) increments (dW1, dW2) = sqrt(dt) A z of Sobol'
    points base..base+n-1 of each replicate: ``qmc_normals_mxu`` and one
    float32 product per factor with ``bb_increment_matrix``.  The span
    ``prepare.bridge`` covers the matrix's upload, the two products and
    the sqrt(dt) scaling."""
    z1, z2 = qmc_normals_mxu(N, n, epoch, k0, k1, v_np=v_np,
                             n_shifts=n_shifts, scramble=scramble,
                             base=base, ndtri_mode=ndtri_mode, device=device)
    with span("prepare.bridge"):
        A = torch.from_numpy(bb_increment_matrix(N)).to(device)
        sqrt_dt = sqrt_f32(_f32(T, device) / N)
        return sqrt_dt * _matmul_f32(A, z1), sqrt_dt * _matmul_f32(A, z2)


def _dyadic_refine(z_f: torch.Tensor, T_total, levels: int) -> torch.Tensor:
    """Bridge-ordered unit normals (2^levels, m) -> Brownian increments
    by dyadic refinement: an increment D over duration tau splits into
    D/2 +- sqrt(tau)/2 z; each level interleaves (left, right)."""
    T_total = _f32(T_total, z_f.device)
    D = sqrt_f32(T_total) * z_f[0:1]
    for lev in range(levels):
        c = 0.5 * sqrt_f32(T_total / float(1 << lev))
        zs = z_f[1 << lev:2 << lev]
        half = D * 0.5
        D = torch.stack([half + c * zs, half - c * zs], dim=1) \
            .reshape(2 << lev, D.shape[1])
    return D


def qmc_increments_dyadic(N: int, n: int, epoch, k0, k1, T, v_np=None,
                          n_shifts: int = 1, scramble: str = "lms-shift",
                          base: int = 0, ndtri_mode: str = "fast", *,
                          device):
    """(N, n_shifts * n) increments by the dyadic refinement over Npad =
    2^ceil(log2 N) leaves of the same dt (the first N kept): the same
    randomizations as ``qmc_increments_mxu`` over 2 Npad dimensions, not
    bitwise comparable with it."""
    levels = max((N - 1).bit_length(), 0)
    Npad = 1 << levels
    zs = qmc_normals_mxu(Npad, n, epoch, k0, k1, v_np=v_np,
                         n_shifts=n_shifts, scramble=scramble, base=base,
                         ndtri_mode=ndtri_mode, device=device)
    T_total = _f32(T, device) * float(Npad) / float(N)
    d1, d2 = (_dyadic_refine(z, T_total, levels)[:N] for z in zs)
    return d1, d2


def _sim_payoff(params_vec, N: int, dW1, dW2) -> torch.Tensor:
    """Per-path payoffs max(S_T - S_0, 0) of paths driven by Brownian
    increments: the scan form, dW / sqrt_dt into ``fe_step``."""
    T, S_0, v_0, r, k, rho, theta, sigma = \
        params_vec.to(dW1.device).unbind()
    dt = T / N
    sqrt_dt = sqrt_f32(dt)
    sqrt_rho_c = sqrt_f32(1.0 - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)
    ones = torch.ones(dW1.shape[1], dtype=torch.float32, device=dW1.device)
    S, v = ones * S_0, ones * v_0
    g1, g2 = dW1 / sqrt_dt, dW2 / sqrt_dt
    for t in range(N):
        S, v = fe_step(S, v, g1[t], g2[t], cst)
    return torch.clamp_min(S - S_0, 0.0)


def _kernel_form_start(params, N: int, M: int, device):
    """(S, v, constants, S_0) of M paths of the kernel form: the FE
    constants at sqrt_dt = 1, so each step takes dW directly."""
    T, S_0, v_0, r, k, rho, theta, sigma = params.to(device).unbind()
    dt = T / N
    sqrt_rho_c = sqrt_f32(1.0 - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, 1.0)
    ones = torch.ones(M, dtype=torch.float32, device=device)
    return ones * S_0, ones * v_0, cst, S_0


def _replicate_sums(S, S_0, n_shifts: int):
    """Per-replicate (sum payoff, sum payoff^2), float64 (R,): payoff and
    payoff^2 in float32, summed in float64."""
    pay = torch.clamp_min(S - S_0, 0.0).reshape(n_shifts, -1)
    return pay.double().sum(1), (pay * pay).double().sum(1)


def qmc_payoff_sums_plain(params, dW1, dW2, n_shifts: int):
    """Plain K6: per-replicate (sum payoff, sum payoff^2), float64 (R,),
    of the paths of (N, M) increments laid out replicate-major, in the
    kernel's form."""
    N, M = dW1.shape
    S, v, cst, S_0 = _kernel_form_start(params, N, M, dW1.device)
    for t in range(N):
        S, v = fe_step(S, v, dW1[t], dW2[t], cst)
    return _replicate_sums(S, S_0, n_shifts)


# the fused bridge + simulator (benchmarks/qmc_fused_probe.py, kernels K9
# and K10): the precision of its bridge product
PRECISIONS = ("HIGHEST", "HIGH", "DEFAULT")


def pick_time_chunk(N: int) -> int:
    """Largest divisor of N <= 125: the time steps of one chunk of the
    fused simulator (``nmch_tpu``'s ``_pick_time_chunk``)."""
    return largest_divisor_leq(N, 125)


def hilo_split(x: torch.Tensor):
    """(hi, lo) bf16 with hi + lo ~ x: hi = x rounded to bf16, lo = the
    residual rounded to bf16 (qmc_fused_probe.py:355-358)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def check_fused(params, z1, z2, A_scaled, n_shifts: int, precision: str):
    """Validate the fused simulator's arguments; returns (N, M)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (expected one "
                         f"of {', '.join(PRECISIONS)})")
    if not isinstance(params, torch.Tensor) or params.dtype != torch.float32 \
            or params.shape != (8,) or params.device.type != "cpu":
        raise ValueError("params must be a float32 tensor of shape (8,) on "
                         "the CPU")
    for name, z in (("z1", z1), ("z2", z2)):
        if not isinstance(z, torch.Tensor) or z.dtype != torch.float32 \
                or z.dim() != 2 or not z.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"of shape (N, M)")
    if z1.shape != z2.shape or z1.device != z2.device:
        raise ValueError(f"z1 {tuple(z1.shape)} on {z1.device} and z2 "
                         f"{tuple(z2.shape)} on {z2.device} differ")
    N, M = z1.shape
    if not isinstance(A_scaled, torch.Tensor) \
            or A_scaled.dtype != torch.float32 \
            or A_scaled.shape != (N, N) or A_scaled.device != z1.device \
            or not A_scaled.is_contiguous():
        raise ValueError(f"A_scaled must be a contiguous float32 tensor of "
                         f"shape ({N}, {N}) on {z1.device}")
    if not 1 <= int(n_shifts) <= 65535:
        raise ValueError(f"n_shifts={n_shifts} must be in [1, 65535]")
    if M % (1024 * n_shifts):
        raise ValueError(f"M={M} must be a multiple of 1024*n_shifts")
    return N, M


def fused_operands(A_scaled: torch.Tensor, precision: str):
    """The bridge matrix's operands of each product, as float32: HIGHEST
    (A,), HIGH (A_hi, A_lo), DEFAULT (A_hi,), the bf16 parts widened
    (exactly) to float32."""
    if precision == "HIGHEST":
        return (A_scaled,)
    hi, lo = hilo_split(A_scaled)
    return (hi.float(), lo.float()) if precision == "HIGH" else (hi.float(),)


def _fused_increments(a_ops, z, rows: slice, precision: str):
    """The increments of time steps ``rows`` from the normals z (N, M),
    each element a sequential float32 multiply-then-add over the bridge
    nodes j = 0..N-1: HIGHEST sum(A z); HIGH (hh + hl) + lh of the three
    bf16 products Ahi zhi, Ahi zlo, Alo zhi, each accumulated on its own
    (qmc_fused_probe.py:314-322); DEFAULT Ahi zhi."""
    if precision == "HIGHEST":
        terms = [(a_ops[0], z)]
    else:
        zh, zl = hilo_split(z)
        terms = [(a_ops[0], zh)]
        if precision == "HIGH":
            terms += [(a_ops[0], zl), (a_ops[1], zh)]
    parts = []
    for a, zz in terms:
        a = a[rows]
        acc = torch.zeros(a.shape[0], z.shape[1], dtype=torch.float32,
                          device=z.device)
        for j in range(z.shape[0]):
            acc += a[:, j:j + 1] * zz[j].float()
        parts.append(acc)
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]) + parts[2]


def qmc_payoff_sums_fused_plain(params, z1, z2, A_scaled, n_shifts: int, *,
                                precision: str = "HIGHEST"):
    """Plain K9/K10: per-replicate (sum payoff, sum payoff^2), float64
    (n_shifts,), of FE paths driven by the bridge product of the normals.

    z1, z2: float32 (N, M) bridge-ordered unit normals
    (``qmc_normals_mxu``), M a multiple of 1024 * n_shifts; A_scaled:
    float32 (N, N), sqrt(dt) * ``bb_increment_matrix(N)``.  The kernel's
    order: per chunk of ``pick_time_chunk(N)`` time steps, the chunk's
    increments (``_fused_increments``), then its FE steps in the kernel
    form.  The sums are float64 in a fixed order, as K6's are (the TPU
    kernel sums in float32)."""
    N, M = check_fused(params, z1, z2, A_scaled, n_shifts, precision)
    S, v, cst, S_0 = _kernel_form_start(params, N, M, z1.device)
    a_ops = fused_operands(A_scaled, precision)
    nc = pick_time_chunk(N)
    for c0 in range(0, N, nc):
        rows = slice(c0, c0 + nc)
        dW1 = _fused_increments(a_ops, z1, rows, precision)
        dW2 = _fused_increments(a_ops, z2, rows, precision)
        for t in range(nc):
            S, v = fe_step(S, v, dW1[t], dW2[t], cst)
    return _replicate_sums(S, S_0, n_shifts)


def qmc_replicate_payoff_sums(params_vec, epoch, k0, k1, *, N: int,
                              count: int, n_shifts: int = DEFAULT_N_SHIFTS,
                              sim: str = "cuda",
                              scramble: str = "lms-shift", base: int = 0,
                              ndtri_mode: str = "fast", bridge: str = "mxu",
                              device):
    """Per-replicate payoff sums, float64 (n_shifts,), over Sobol' points
    [base, base + count) of each replicate.

    params_vec: float32 (8,) on the CPU; bridge: "mxu" (the dense bridge
    product) or "dyadic"."""
    T = params_vec[0]
    kw = dict(n_shifts=n_shifts, scramble=scramble, base=base,
              ndtri_mode=ndtri_mode, device=device)
    if bridge == "mxu":
        dW1, dW2 = qmc_increments_mxu(N, count, epoch, k0, k1, T, **kw)
    elif bridge == "dyadic":
        dW1, dW2 = qmc_increments_dyadic(N, count, epoch, k0, k1, T, **kw)
    else:
        raise ValueError(f"unknown bridge {bridge!r} (expected 'mxu' or "
                         f"'dyadic')")
    if sim == "cuda":
        from .fe_qmc_cuda import qmc_payoff_sums_cuda
        return qmc_payoff_sums_cuda(params_vec, dW1, dW2, n_shifts)[0]
    pay = _sim_payoff(params_vec, N, dW1, dW2)
    return pay.double().reshape(n_shifts, count).sum(1)


def rqmc_moments_from_means(means: torch.Tensor, n_paths: int,
                            n_shifts: int):
    """(m, m2) synthesized so that SimResult(m, m2, n_paths).ci_error is
    the RQMC 95% CI: var(replicate means) / (R - 1) (population variance)
    times (t_{R-1} / z)^2, the Student-t quantile folded into the 1.96
    formula.  Only ``ci_error`` is meaningful for these moments."""
    from scipy.stats import t as _t
    m = means.mean()
    t_over_z = float(_t.ppf(0.975, n_shifts - 1)) / 1.959963984540054
    var_of_mean = means.var(correction=0) * (t_over_z ** 2 / (n_shifts - 1))
    return m, m * m + var_of_mean * n_paths


def qmc_chunk(n: int, N: int, n_shifts: int, max_chunk: int | None) -> int:
    """Points per replicate and chunk: ``max_chunk`` (or n), halved while
    a chunk's factor exceeds 2^29 elements, then rounded down to a
    divisor of n (``nmch_tpu``'s schedule for its scan engine)."""
    chunk = n if max_chunk is None else min(n, max_chunk)
    while chunk * n_shifts * N > _MAX_FACTOR:
        if chunk % 2:
            break
        chunk //= 2
    if n % chunk:
        chunk = largest_divisor_leq(n, chunk)
    return chunk


def qmc_range_sums(params_vec, epoch, k0, k1, *, N: int, count: int,
                   base: int = 0, n_shifts: int = DEFAULT_N_SHIFTS,
                   sim: str = "cuda", scramble: str = "lms-shift",
                   max_chunk: int | None = None, ndtri_mode: str = "fast",
                   bridge: str = "mxu", device):
    """Per-replicate payoff sums, float64 (n_shifts,), over Sobol' points
    [base, base + count) of each replicate, in chunks of ``qmc_chunk``
    points whose sums are added with a compensated (Kahan) sum: the whole
    point set for ``fe_moments_qmc``, one rank's range for
    ``parallel/mesh.py``."""
    params = params_vec.detach().to("cpu", torch.float32)
    epoch = int(epoch) & MASK32
    k0, k1 = int(k0), int(k1)
    chunk = qmc_chunk(count, N, n_shifts, max_chunk)
    kw = dict(N=N, count=chunk, n_shifts=n_shifts, sim=sim,
              scramble=scramble, ndtri_mode=ndtri_mode, bridge=bridge,
              device=device)
    acc = comp = None
    for c in range(count // chunk):
        s = qmc_replicate_payoff_sums(params, epoch, k0, k1,
                                      base=base + c * chunk, **kw)
        if acc is None:
            acc, comp = s, torch.zeros_like(s)
            continue
        y = s - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def fe_moments_qmc(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                   n_shifts: int = DEFAULT_N_SHIFTS, sim: str = "cuda",
                   scramble: str = "lms-shift",
                   max_chunk: int | None = None, ndtri_mode: str = "fast",
                   bridge: str = "mxu", device):
    """(m, m2), float64 0-dim tensors on ``device``, of the QMC engine;
    SimResult(m, m2, n_paths) gives the randomized-QMC CI.

    n_paths points are n_shifts independently randomized replicates of
    n_paths / n_shifts Sobol' points.  The point axis runs in chunks
    (``qmc_chunk``), each a disjoint index range of the same randomized
    set, so chunking changes the schedule and not the estimate; the
    chunks' sums are added with a compensated (Kahan) sum.

    params_vec: float32 (8,) (T, S_0, v_0, r, k, rho, theta, sigma);
    epoch, k0, k1: u32; sim: "cuda" (K6 on a card, its plain version on
    the CPU) or "scan" (the scan form)."""
    if sim not in SIMS:
        raise ValueError(f"unknown sim {sim!r} (expected 'cuda' or 'scan')")
    if n_shifts < 2:
        raise ValueError(f"n_shifts={n_shifts} must be >= 2: the RQMC CI "
                         f"is the spread of independent shift replicates "
                         f"(one replicate has no spread)")
    if n_paths % n_shifts:
        raise ValueError(f"n_paths={n_paths} must be divisible by "
                         f"n_shifts={n_shifts}")
    n = n_paths // n_shifts
    acc = qmc_range_sums(params_vec, epoch, k0, k1, N=N, count=n,
                         n_shifts=n_shifts, sim=sim, scramble=scramble,
                         max_chunk=max_chunk, ndtri_mode=ndtri_mode,
                         bridge=bridge, device=device)
    return rqmc_moments_from_means(acc / n, n_paths, n_shifts)
