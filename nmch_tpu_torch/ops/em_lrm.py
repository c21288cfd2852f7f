"""Score-function (likelihood-ratio) EM sensitivities: the golden.

The counterpart of ``nmch_tpu/ops/em_lrm.py`` (its module docstring holds
the derivation and the measured variance trade-off against CRN-FD).  The
parameters eta in (T, v_0, k, theta, sigma) enter the exact scheme only
through the variance chain's transition law; scoring the joint density of
each step's Poisson index n and next variance v',

    p(n, v' | v) = Pois(n; lam_c v) * Gamma(v'; alpha = d + n, scale = vfac),

gives d/d_eta E[H] = E[d_eta H + (H - b) * sum_t d_eta log p_t] with the
realized path held fixed, b the mean (a control variate) and H the
conditional payoff.  Per step, with J = d(lam_c, d, vfac)/d_eta:

    d log Pois  = (n / max(lam, 1e-37) - 1) (v_t J_lamc + [t = 0] lam_c e_v0)
    d log Gamma = J_d (log max(g, 1e-37) - digamma(alpha))
                  + J_vfac (g - alpha) / vfac,      g = v' / vfac.

The floors are ``nmch_tpu``'s: a Gamma draw that underflows to 0 (shapes d
<< 1) makes the next lam 0, and an unfloored n / lam would be NaN.  The
trapezoid's first summand is v_0 itself, so the explicit term keeps
dvI/dv_0 = dt/2 (vI = (vI_rest + v_0) dt/2).

``lrm_scores_plain`` is the score loop, the plain version of kernel
K2-LRM (``csrc/em_lrm.cu``), one float32 op per kernel operation; on a card
``em_greeks_lrm`` launches the kernel (``ops/em_lrm_cuda.py``), on the CPU
it runs the loop.  The explicit term (autograd vjp) and the control
variate are a torch epilogue on the per-path outputs in both.

``digamma`` is the kernel's: a recurrence that lifts z to at least 6, then
the asymptotic series (``nmch_tpu`` calls ``jax.scipy.special.digamma``);
within 1e-6 of ``scipy.special.digamma`` over [0.05, 100] on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rng.normal import sqrt_f32
from .em import EmConsts, conditional_payoff_of_strike, em_consts, exp_f32
from .em_greeks import check_counter_rng
from .fe import mean_f32, path_index_grid
from .sampling import gamma_ms_from_stream, poisson_from_stream

LRM_PARAMS = ("T", "v_0", "k", "theta", "sigma")
# positions of the LRM parameters inside the flat float32 (8,) params
_P8 = {"T": 0, "v_0": 2, "k": 4, "theta": 6, "sigma": 7}
_F32 = np.float32
_FLOOR = float(_F32(1e-37))
_DG_SHIFT, _DG_STEPS = 6.0, 6
# 1/12, 1/120, 1/252, 1/240, 1/132 as float32 (csrc/em_lrm.cu's kDg*)
_DG = tuple(float(_F32(1.0 / q)) for q in (12, 120, 252, 240, 132))


def digamma(z: torch.Tensor) -> torch.Tensor:
    """psi(z) for float32 z > 0: psi(z) = psi(z + m) - sum_{i<m} 1/(z + i)
    with z + m >= 6 (at most 6 steps), and psi(w) = ln w - 1/(2w) -
    1/(12w^2) + 1/(120w^4) - 1/(252w^6) + 1/(240w^8) - 1/(132w^10)."""
    one = torch.ones((), device=z.device)
    acc = torch.zeros_like(z)
    for _ in range(_DG_STEPS):
        lift = z < _DG_SHIFT
        acc = torch.where(lift, acc + torch.div(one, z), acc)
        z = torch.where(lift, z + 1.0, z)
    zi = torch.div(one, z)
    zi2 = zi * zi
    c12, c120, c252, c240, c132 = _DG
    series = zi2 * (c12 - zi2 * (c120 - zi2 * (c252 - zi2 * (
        c240 - zi2 * c132))))
    return torch.log(z) - 0.5 * zi - series - acc


def _transition_consts(p5, N: int):
    """(lam_c, d, vfac) from (T, v_0, k, theta, sigma), differentiable
    (``torch.func.jacfwd`` gives J)."""
    T, v_0, k, theta, sigma = p5.unbind()
    dt = T / N
    e = exp_f32(-k * dt)
    sig2 = sigma * sigma
    one_m = 1.0 - e
    lam_c = 2.0 * k * e / (sig2 * one_m)
    d = 2.0 * k * theta / sig2
    vfac = sig2 * one_m / (2.0 * k)
    return torch.stack([lam_c, d, vfac])


def lrm_jacobian(params, N: int) -> torch.Tensor:
    """float32 (3, 5) on the CPU: d(lam_c, d, vfac) / d(T, v_0, k, theta,
    sigma) by forward-mode autograd; cached per (params, N)."""
    p = params.detach().to("cpu", torch.float32).tolist()
    return _lrm_jacobian(tuple(p[_P8[n]] for n in LRM_PARAMS),
                         int(N)).clone()


@functools.lru_cache(maxsize=256)
def _lrm_jacobian(p5: tuple, N: int) -> torch.Tensor:
    return torch.func.jacfwd(lambda q: _transition_consts(q, N))(
        torch.tensor(p5, dtype=torch.float32))


def lrm_scores_plain(c: EmConsts, J, N: int, path_idx, epoch, k0, k1,
                     rng: str = "philox"):
    """The score loop on the device of ``path_idx`` ((R, 128) u32 path
    indices): float32 (7, R, 128), rows v_T, vI_rest (the trapezoid's sum
    less v_0) and the five scores.  c: the loop constants (``em_consts``;
    lam_const, d, vfac, v_0 and poisson_cut are read); J: the float32 (3,
    5) Jacobian (``lrm_jacobian``)."""
    dev = path_idx.device
    Jd = [[J[i, q].to(dev) for q in range(5)] for i in range(3)]
    vfac = torch.tensor(c.vfac, device=dev)
    path_hi = torch.zeros_like(path_idx)
    Vt = torch.zeros(path_idx.shape, device=dev) + c.v_0
    vI = torch.zeros_like(Vt)
    sc = [torch.zeros_like(Vt) for _ in range(5)]
    ctr = torch.zeros(Vt.shape, dtype=torch.int64, device=dev)
    for i in range(N):
        lam = c.lam_const * Vt
        n, ctr = poisson_from_stream(lam, ctr, epoch, path_idx, path_hi,
                                     k0, k1, rng=rng,
                                     large_cut=c.poisson_cut)
        alpha = c.d + n
        g, ctr = gamma_ms_from_stream(alpha, ctr, epoch, path_idx, path_hi,
                                      k0, k1, rng=rng)
        v_next = c.vfac * g
        pois_fac = n / torch.clamp_min(lam, _FLOOR) - 1.0
        gam_d = torch.log(torch.clamp_min(g, _FLOOR)) - digamma(alpha)
        gam_v = (g - alpha) / vfac
        for q in range(5):
            s = pois_fac * (Vt * Jd[0][q])
            if q == 1 and i == 0:
                # v_0: the first transition's rate is lam_c * v_0
                s = s + pois_fac * c.lam_const
            s = s + Jd[1][q] * gam_d + Jd[2][q] * gam_v
            sc[q] = sc[q] + s
        vI = vI + (Vt + v_next)   # K2's order (em_path.cuh)
        Vt = v_next
    return torch.stack([Vt, vI - c.v_0, *sc])


class LrmSteps:
    """K2-LRM's per-step report (``csrc/em_lrm.cu::LrmReport``) on flat
    lanes, for ``ops/em_schedule.py::emulate``: each step's scores, as
    ``lrm_scores_plain`` forms them, added where a lane's step settles, in
    whatever order the schedule runs the lanes.  After the run ``out()``
    is float32 (7, n): v_T, vI_rest and the five scores."""

    def __init__(self, c: EmConsts, J, n: int):
        self.c = c
        self.Jd = [[J[i, q] for q in range(5)] for i in range(3)]
        self.vfac = torch.tensor(c.vfac)
        self.sc = [torch.zeros(n) for _ in range(5)]
        self.v_T = self.vI_rest = None

    def step(self, mask, i, Vt, lam, n, alpha, g):
        Jd, c = self.Jd, self.c
        pois_fac = n / torch.clamp_min(lam, _FLOOR) - 1.0
        gam_d = torch.log(torch.clamp_min(g, _FLOOR)) - digamma(alpha)
        gam_v = (g - alpha) / self.vfac
        for q in range(5):
            s = pois_fac * (Vt * Jd[0][q])
            if q == 1:
                s = torch.where(i == 0, s + pois_fac * c.lam_const, s)
            s = s + Jd[1][q] * gam_d + Jd[2][q] * gam_v
            self.sc[q] = torch.where(mask, self.sc[q] + s, self.sc[q])

    def end(self, Vt, vI):
        self.v_T, self.vI_rest = Vt, vI - self.c.v_0

    def out(self) -> torch.Tensor:
        return torch.stack([self.v_T, self.vI_rest, *self.sc])


def lrm_from_scores(params, N: int, v_T, vI_rest, scores):
    """(price, greeks over LRM_PARAMS), float32 0-dim tensors: the explicit
    derivative of the conditional payoff (autograd vjp with the sampled
    path held fixed) plus the mean-centred payoff times each score."""
    pv = params.detach().to(v_T.device, torch.float32)
    S_0, r, rho = pv[1], pv[3], pv[5]
    p5 = torch.stack([pv[_P8[n]] for n in LRM_PARAMS]).requires_grad_(True)
    n_f = torch.tensor(float(v_T.numel()), device=v_T.device)
    with torch.enable_grad():
        T, v_0, k, theta, sigma = p5.unbind()
        dt = T / torch.tensor(float(N), device=v_T.device)
        vI = (vI_rest + v_0) * (dt * 0.5)
        m = (torch.log(S_0) + r * T - 0.5 * vI
             + (rho / sigma) * (v_T - v_0 - k * theta * T + k * vI))
        sig_eff = sqrt_f32((1.0 - rho * rho) * vI)
        H = conditional_payoff_of_strike(m, sig_eff, S_0)
        (explicit,) = torch.autograd.grad(H, p5, torch.ones_like(H) / n_f)
    H = H.detach()
    price = mean_f32(H)
    Hc = H - price
    g = explicit + torch.stack([(Hc * s).sum() / n_f for s in scores])
    return price, dict(zip(LRM_PARAMS, g.unbind()))


def em_greeks_lrm(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                  rng: str = "philox", poisson_cut: float | None = None,
                  device="cuda"):
    """(price, greeks) with greeks a dict over LRM_PARAMS, float32 0-dim
    tensors on ``device``: the score-function estimator.  poisson_cut None
    means 4000 (curand's switch): the scored density must be the sampled
    law, which the fast cut's normal approximation is not quite.  On a card
    the score loop is kernel K2-LRM."""
    from .em_lrm_cuda import em_lrm_scores_cuda
    check_counter_rng(rng)
    out = em_lrm_scores_cuda(params_vec.to("cpu"), (k0, k1), epoch, 0, N=N,
                             n_paths=n_paths, device=device, rng=rng,
                             poisson_cut=poisson_cut)
    return lrm_from_scores(params_vec, N, out[0], out[1], out[2:])


def lrm_plain(params, seed_words, epoch, base_path, *, N: int, n_paths: int,
              rng: str = "philox", poisson_cut: float | None = None,
              device="cpu"):
    """``lrm_scores_plain`` from the wrapper's arguments (K2-LRM's plain
    version): float32 (7, n_paths/128, 128) on ``device``."""
    k0, k1 = (int(w) for w in seed_words)
    return lrm_scores_plain(em_consts(params, N, poisson_cut),
                            lrm_jacobian(params, N), N,
                            path_index_grid(n_paths, base_path, device),
                            epoch, k0, k1, rng)
