"""The EM kernels' two schedules of the same draws (``csrc/em_path.cuh``,
K2 and K4), emulated in plain torch: a model of how a warp spends its
block draws, for the tests and for the active-lane share.

A path's lane carries its stage (Knuth, PTRS, the normal branch, a
Marsaglia-Tsang round, the terminal), round and the stage's constants;
each iteration some lanes draw one counter block each and hand it to
their stage, and a lane that ends a stage runs the next stage's set-up in
the same iteration.  The round schedule (``em_path_rounds``) lets the
phase that holds more of the warp's lanes draw: the Gamma phase (MT
rounds) or the step phase (Poisson rounds and the terminal).  The step
schedule (``em_path_steps``, the samplers' own loops) lets the lanes
furthest behind draw, one sampler branch at a time: within a step the
warp runs each Poisson regime's rounds present among its lanes (Knuth,
the normal branch, PTRS), then its MT rounds.

Every path's final counter and payoff are those of ``ops/em.py::
em_payoffs`` on either schedule (``tests/test_torch_em_rounds.py`` holds
them bitwise).  A per-step report (K2-LRM's scores, ``ops/em_lrm.py::
LrmSteps``) sees each lane's steps in order on either schedule, as the
kernels' ``Report::step`` does.  A warp's iterations are the block draws
it executes, so the active-lane share, blocks drawn / (32 x the warps'
iterations), is the share of lane-slots of those draws that do work.

    python -m nmch_tpu_torch.ops.em_schedule [--paths 4096] [--sweep-paths 128]

prints one JSON line per case (K2 at default parameters, N = 1000, cut
128 and 4000, each variant; K4 over explore's 200 points at N = 1000, cut
128, each variant; seed 1234 and epoch 1, as chip_smoke.py's timed runs):
the share on each schedule, computed on the CPU (a few minutes).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .em import EmConsts, em_conditional_payoff, em_consts_table
from .sampling import make_stream_draw4, ptrs_constants, \
    ptrs_log_accept_rhs
from ..rng.normal import sincos_2pi, sqrt_f32, uniform_halfopen01, \
    uniform_open01

# em_path.cuh's EmStage
KNUTH, PTRS, NORMAL, GAMMA, TERMINAL, DONE = range(6)
WARP = 32
POISSON_ROUNDS, GAMMA_ROUNDS = 64, 32
THIRD = float(np.float32(1.0 / 3.0))
LOG_FLOOR = float(np.float32(1e-37))
# the step loops' order within a step: each Poisson branch, then MT
_STEP_KEY = {KNUTH: 0, NORMAL: 1, PTRS: 2, GAMMA: 3, TERMINAL: 0, DONE: 0}


class _Words:
    """Each lane's counter blocks, drawn ``AHEAD`` counters at a time from
    the lane's counter at the time (one stream call for many iterations:
    a lane's counter rises by at most one an iteration)."""
    AHEAD = 64

    def __init__(self, draw4s, n: int, device):
        self.draw4s, self.lane = draw4s, torch.arange(n, device=device)
        self.base = torch.full((n,), -self.AHEAD - 1, dtype=torch.int64,
                               device=device)
        self.tab = None

    def at(self, ctr):
        """The 4 words at each lane's counter ``ctr``."""
        off = ctr - self.base
        if bool((off >= self.AHEAD).any()):
            self.base = ctr.clone()
            k = torch.arange(self.AHEAD, device=ctr.device).unsqueeze(1)
            self.tab = torch.stack(self.draw4s(ctr + k)[:4])
            off = ctr - self.base
        return self.tab[:, off, self.lane].unbind(0)


def emulate(c: EmConsts, N: int, path, epoch, k0: int, k1: int, rng: str,
            conditional: bool, rounds=True, report=None):
    """The kernel's loop for the flat int64 path ids ``path`` (a multiple
    of 32 of them, each 32 consecutive ones a warp).  ``c`` holds the loop
    constants (floats, or (n,) tensors: one point per warp), ``epoch`` an
    int or an (n,) tensor, ``rounds`` the schedule (em_path_rounds when
    true, em_path_steps when false; a bool or an (n,) bool tensor, one
    value per warp).  ``report``: None, or an object whose ``step(mask, i,
    v_t, lam, n, alpha, g)`` is called where a lane's Gamma draw settles
    (the lanes in ``mask``; the step, v_t, lam_const v_t, the Poisson
    index, d + n and the draw) and whose ``end(v_T, vI_sum)`` is called
    once at the end (em_path.cuh's per-step report).  Returns (payoff
    float32, final counter int64, each warp's iterations, each lane's
    iterations spent waiting), on ``path``'s device (on a card, its
    float32 functions are the kernels')."""
    n, dev = path.numel(), path.device
    words = _Words(make_stream_draw4(rng, epoch, path,
                                     torch.zeros_like(path), k0, k1), n,
                   dev)
    zf = torch.zeros(n, device=dev)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    rounds = torch.as_tensor(rounds, dtype=torch.bool,
                             device=dev).expand(n)
    rounds_warp = rounds.view(-1, WARP)[:, 0].repeat_interleave(WARP)
    step_key = torch.tensor([_STEP_KEY[j] for j in range(DONE + 1)],
                            device=dev)
    s = dict(Vt=zf + c.v_0, vI=zf.clone(), ctr=zi.clone(), i=zi.clone(),
             stage=zi.clone(), rnd=zi.clone(), payoff=zf.clone(),
             **{f"q{j}": zf.clone() for j in range(6)})

    def put(mask, **kw):
        for name, v in kw.items():
            s[name] = torch.where(mask, v, s[name])

    def begin_step(mask):
        if not bool(mask.any()):
            return
        put(mask, rnd=zi)
        going = mask & (s["i"] < N)
        lam = c.lam_const * s["Vt"]
        sqrt_lam = sqrt_f32(lam)
        b, a, invalpha, vr = ptrs_constants(sqrt_lam)
        small = lam < 10.0
        large = (lam >= c.poisson_cut) & ~small
        put(going, q0=lam,
            stage=torch.where(small, KNUTH, torch.where(large, NORMAL,
                                                        PTRS)),
            q1=torch.where(small, torch.exp(-lam),
                           torch.where(large, sqrt_lam, b)),
            q2=torch.where(small, 1.0, a),
            q3=torch.where(small, 0.0, invalpha), q4=vr, q5=torch.log(lam))
        ending = mask & (s["i"] >= N)
        if not bool(ending.any()):
            return
        vI = s["vI"] * c.half_dt
        m = (c.m0 - 0.5 * vI
             + c.rho_s * (s["Vt"] - c.v_0 - c.ktT + c.k * vI))
        sig_eff = sqrt_f32(c.one_m_rho2 * vI)
        if conditional:
            put(ending, stage=DONE,
                payoff=em_conditional_payoff(m, sig_eff, c.S_0, c.log_S0))
        else:
            put(ending, stage=TERMINAL, q0=m, q1=sig_eff)

    def gamma_fallback():
        return (s["q0"] + torch.where(s["q0"] < 1.0, 1.0, 0.0)) * s["q3"]

    begin_step(torch.ones(n, dtype=torch.bool, device=dev))
    waits = zi.clone()
    warp_iters = torch.zeros(n // WARP, dtype=torch.int64, device=dev)
    while True:
        warp_active = (s["stage"] != DONE).view(-1, WARP).any(1)
        if not bool(warp_active.any()):
            break
        warp_iters += warp_active
        stage = s["stage"]
        active = stage != DONE
        # em_path_rounds: the phase with more lanes draws (ties: the step)
        gamma = stage == GAMMA
        n_gamma = gamma.view(-1, WARP).sum(1)
        n_step = (active & ~gamma).view(-1, WARP).sum(1)
        pick = (n_gamma > n_step).repeat_interleave(WARP)
        by_phase = active & (gamma == pick)
        # em_path_steps: the lowest (step, branch) among the active lanes
        key = torch.where(active, 4 * s["i"] + step_key[stage], 1 << 40)
        by_step = active & (key == key.view(-1, WARP).min(1).values
                            .repeat_interleave(WARP))
        drawing = torch.where(rounds_warp, by_phase, by_step)
        waits += active & ~drawing
        # one block per drawing lane
        w0, w1, w2, w3 = words.at(s["ctr"])
        put(drawing, ctr=s["ctr"] + 1)
        q0, q1, q2, q3, q4, q5 = (s[f"q{j}"] for j in range(6))
        U = uniform_halfopen01(w0) - 0.5
        V = uniform_halfopen01(w1)
        us = 0.5 - torch.abs(U)
        kf = torch.floor((2.0 * q2 / us + q1) * U + q0 + 0.43)
        ptrs = drawing & (stage == PTRS)
        # one log: PTRS's ratio, else the Box-Muller radius's uniform
        lg = torch.log(torch.where(ptrs, V * q3 / (q2 / (us * us) + q1),
                                   uniform_open01(w0)))
        g = sqrt_f32(-2.0 * lg) * sincos_2pi(uniform_open01(w1))[0]
        pdone = torch.zeros(n, dtype=torch.bool, device=dev)
        gdone = pdone.clone()
        val = zf.clone()
        kn = drawing & (stage == KNUTH)
        if bool((kn | ptrs).any()):
            # Knuth
            t, cnt = q2, q3
            for w in (w0, w1, w2, w3):
                still = t >= q1
                t = torch.where(still, t * uniform_open01(w), t)
                cnt = cnt + torch.where(still, 1.0, 0.0)
            put(kn, q2=t, q3=cnt)
            hit = kn & (t < q1)
            pdone |= hit
            val = torch.where(hit, torch.clamp_min(cnt - 1.0, 0.0), val)
            # PTRS
            rej = (kf < 0.0) | ((us < 0.013) & (V > us))
            ok = ((us >= 0.07) & (V <= q4)) | (
                ~rej & (lg <= ptrs_log_accept_rhs(kf, q0, q5)))
            hit = ptrs & ok
            pdone |= hit
            val = torch.where(hit, torch.clamp_min(kf, 0.0), val)
            miss = (kn | ptrs) & ~pdone
            put(miss, rnd=s["rnd"] + 1)
            capped = miss & (s["rnd"] == POISSON_ROUNDS)
            pdone |= capped
            val = torch.where(capped, torch.floor(q0 + 0.5), val)
        # the normal approximation
        hit = drawing & (stage == NORMAL)
        pdone |= hit
        val = torch.where(hit, torch.clamp_min(torch.floor(q0 + q1 * g
                                                           + 0.5), 0.0),
                          val)
        # a Marsaglia-Tsang round
        mt = drawing & (stage == GAMMA)
        v1 = 1.0 + q2 * g
        v = v1 * v1 * v1
        u = uniform_open01(w2)
        x2 = g * g
        boost = mt & (s["rnd"] == 0) & (q0 < 1.0)
        if bool(boost.any()):
            put(boost, q3=torch.exp(torch.log(uniform_open01(w3)) / q0))
        logv = torch.log(torch.clamp_min(v, LOG_FLOOR))
        ok = (v > 0.0) & ((u < 1.0 - 0.0331 * x2 * x2) | (
            torch.log(u) < 0.5 * x2 + q1 * (1.0 - v + logv)))
        hit = mt & ok
        gdone |= hit
        val = torch.where(hit, q1 * v * s["q3"], val)
        miss = mt & ~ok
        put(miss, rnd=s["rnd"] + 1)
        capped = miss & (s["rnd"] == GAMMA_ROUNDS)
        gdone |= capped
        val = torch.where(capped, gamma_fallback(), val)
        # the terminal draw
        term = drawing & (stage == TERMINAL)
        if bool(term.any()):
            put(term, stage=DONE, payoff=torch.clamp_min(
                torch.exp(q0 + q1 * g) - c.S_0, 0.0))
        # the next stage's set-up
        alpha0 = c.d + val
        alpha = alpha0 + torch.where(alpha0 < 1.0, 1.0, 0.0)
        d = alpha - THIRD
        put(pdone, q0=alpha0, q1=d, q2=torch.rsqrt(9.0 * d), q3=zf + 1.0,
            stage=GAMMA, rnd=zi)
        if report is not None:
            # the Poisson index waits in q4 for the step's report
            put(pdone, q4=val)
            if bool(gdone.any()):
                report.step(gdone, s["i"], s["Vt"], c.lam_const * s["Vt"],
                            s["q4"], s["q0"], val)
        v_next = c.vfac * val
        put(gdone, vI=s["vI"] + (s["Vt"] + v_next), Vt=v_next,
            i=s["i"] + 1)
        begin_step(gdone)
    if report is not None:
        report.end(s["Vt"], s["vI"])
    return s["payoff"], s["ctr"], warp_iters, waits


def active_lane_share(ctr: torch.Tensor, warp_iters: torch.Tensor) -> float:
    """Blocks drawn (the paths' final counters) over 32 x the block draws
    the warps executed (their iterations)."""
    return (ctr.double().sum() / (WARP * warp_iters.double().sum())).item()


def sweep_consts(params_matrix, N: int, poisson_cut: float,
                 paths_per_point: int):
    """K4's emulation inputs: the points' ``EmConsts`` as one (n,) tensor
    each (point p's constants on its paths_per_point lanes, point major),
    path ids 0..paths_per_point-1 for each point and each lane's epoch
    offset p."""
    table = em_consts_table(params_matrix, N, poisson_cut)
    point = torch.arange(table.shape[0]).repeat_interleave(paths_per_point)
    c = EmConsts(*table[point].unbind(1))
    path = torch.arange(paths_per_point).repeat(table.shape[0])
    return c, path, point


def shares(c, N: int, path, epoch, k0: int, k1: int, rng: str,
           conditional: bool) -> dict:
    """The active-lane share of each schedule over the lanes ``path``
    (``emulate``'s arguments; both schedules in one run, the lanes
    twice)."""
    n = path.numel()
    two = (lambda x: x.repeat(2)) if isinstance(epoch, torch.Tensor) \
        else (lambda x: x)
    c2 = EmConsts(*(two(v) for v in c))
    _, ctr, iters, _ = emulate(c2, N, path.repeat(2), two(epoch), k0, k1,
                               rng, conditional, torch.arange(2 * n) < n)
    ctr, iters = ctr.view(2, -1), iters.view(2, -1)
    return {"share_rounds": active_lane_share(ctr[0], iters[0]),
            "share_steps": active_lane_share(ctr[1], iters[1])}


def main(argv=None) -> int:
    from .. import HestonParams
    from ..explore import grid_params, grid_points
    from ..rng.philox import split_seed
    from .em import em_consts

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=1 << 12,
                    help="K2's paths (a multiple of 32)")
    ap.add_argument("--sweep-paths", type=int, default=128,
                    help="K4's paths per point (a multiple of 32)")
    args = ap.parse_args(argv)
    k0, k1 = split_seed(1234)
    N = 1000
    variants = [(r, cond) for r in ("philox", "threefry4")
                for cond in (False, True)]
    for cut in (128.0, 4000.0):
        c = em_consts(HestonParams().as_tensor("cpu"), N, cut)
        for r, cond in variants:
            print(json.dumps({
                "kernel": "em_paths", "rng": r, "conditional": cond,
                "poisson_cut": cut, "N": N, "paths": args.paths, "epoch": 1,
                **shares(c, N, torch.arange(args.paths), 1, k0, k1, r,
                         cond)}), flush=True)
    pm = grid_params(grid_points())
    c, path, point = sweep_consts(pm, N, 128.0, args.sweep_paths)
    for r, cond in variants:
        print(json.dumps({
            "kernel": "em_sweep_paths", "rng": r, "conditional": cond,
            "poisson_cut": 128.0, "N": N, "points": pm.shape[0],
            "paths_per_point": args.sweep_paths, "epoch0": 1,
            **shares(c, N, path, 1 + point, k0, k1, r, cond)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
