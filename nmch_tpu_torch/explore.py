"""Parameter-space exploration sweep of the PyTorch port (the reference's
``exploration``).

The counterpart of ``nmch_tpu/explore.py``, which reproduces
``src/NMCH/test/exploration.cu``: sweep kappa in [0.1, 10], theta in
[0.01, 0.5], sigma in [0.1, 1] in 5 steps each, skip infeasible
``20*k*theta < sigma^2`` combos (exploration.cu:76,105), do one warm-up
compute() per method first ("the first run is always slow", :65-67; here
it builds the kernels), reuse the same RNG streams across every point
via the setters (:14-17), and print the identical CSV:
``method, k, theta, sigma, execution_time, err``.

Reference geometry: NTPB=512, NB=10 (5,120 paths), N=1000.  Loop mode
prices one point per compute() (one launch of ``csrc/fe.cu`` or
``csrc/em.cu`` each); ``--batched`` prices the whole grid in one launch
per method (``csrc/sweep.cu``, point p at epoch p).  The same flags and
CSV as ``nmch_tpu.explore``, except:

* ``--engine cuda|scan`` (default cuda: the hand-written kernels) and
  ``--device`` (default cuda; never falls back to the CPU).

``--rng xorwow|mrg32k3a`` (the reference's exploration defaults to XORWOW
for both methods, exploration.cu:24-25,54-55) runs in loop mode only: FE
launches ``csrc/fe_stateful.cu`` once per point, each pricer's states
carried from point to point; EM needs ``--engine scan``.

Run: ``python -m nmch_tpu_torch.explore [--batched] [--NB 10]
[--out sweep.csv]``, then ``python -m nmch_tpu_torch.analysis.heatmap
sweep.csv``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .methods.base import host_values, resolve_device
from .methods.em import NMCH_EM
from .methods.fe import NMCH_FE
from .ops.sweep import em_sweep_plain, fe_sweep_plain
from .ops.sweep_cuda import em_sweep_cuda, fe_sweep_cuda
from .params import HestonParams, SimConfig
from .results import SimResult
from .rng.philox import split_seed
from .utils.timing import span

K_MIN, K_MAX = 0.1, 10.0
THETA_MIN, THETA_MAX = 0.01, 0.5
SIGMA_MIN, SIGMA_MAX = 0.1, 1.0
STEPS = 5
BATCHED_EM_POISSON_CUT = 128.0   # nmch_tpu/explore.py:141,146


def _grid(lo: float, hi: float, steps: int = STEPS):
    """The reference's inclusive stepped loop
    (for(x=lo; x<=hi; x+=(hi-lo)/steps))."""
    step = (hi - lo) / steps
    out = []
    x = lo
    # float-accumulation loop like the reference; bound the count
    for _ in range(steps + 2):
        if x > hi + 1e-9:
            break
        out.append(x)
        x += step
    return out


def feasible(k: float, theta: float, sigma: float) -> bool:
    """The reference's sweep filter: skip when 20*k*theta < sigma^2
    ('the variance of the FE is too small otherwise',
    exploration.cu:76)."""
    return 20.0 * k * theta >= sigma * sigma


def sweep(method_obj, name: str, out=sys.stdout, timed_reps: int = 1):
    """Warm up, then sweep the feasible grid with stream reuse.

    timed_reps > 1: each point's time is the average over that many
    ``_moments`` calls queued back to back and synchronised once (each
    consumes its own stream epoch, so the stream-continuation contract
    is unchanged); the price is the last call's."""
    method_obj.compute()  # warm-up, discarded (exploration.cu:65-67)
    for k, theta, sigma in grid_points():
        method_obj.set_theta(theta)
        method_obj.set_sigma(sigma)
        method_obj.set_k(k)
        if timed_reps > 1:
            epochs = [method_obj.streams.next_epoch()
                      for _ in range(timed_reps)]
            _sync(method_obj.device)
            t0 = time.perf_counter()
            outs = [method_obj._moments(e) for e in epochs]
            m, m2 = host_values(outs[-1])[:2]   # waits for all
            per_ms = (time.perf_counter() - t0) * 1e3 / timed_reps
            res = SimResult(m, m2, method_obj.cfg.n_paths,
                            exec_time_ms=per_ms)
        else:
            res = method_obj.compute()
        print(f"{name}, {k:f}, {theta:f}, {sigma:f}, "
              f"{res.exec_time_ms:f}, {res.err:f}",
              file=out, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grid_points():
    """The reference's feasible (k, theta, sigma) grid, in its loop
    order (sigma outer, theta, k inner — exploration.cu:71-81)."""
    pts = []
    for sigma in _grid(SIGMA_MIN, SIGMA_MAX):
        for theta in _grid(THETA_MIN, THETA_MAX):
            for k in _grid(K_MIN, K_MAX):
                if feasible(k, theta, sigma):
                    pts.append((k, theta, sigma))
    return pts


def grid_params(pts=None) -> torch.Tensor:
    """float32 (P, 8) parameter rows of the grid points (default: all of
    ``grid_points()``) over the default HestonParams."""
    pts = grid_points() if pts is None else pts
    b = HestonParams()
    return torch.tensor([[b.T, b.S_0, b.v_0, b.r, k, b.rho, theta, sigma]
                         for (k, theta, sigma) in pts], dtype=torch.float32)


def batched_moments(cfg: SimConfig, seed: int, method: str, engine: str,
                    rng: str, conditional: bool, device):
    """(E[X], E[X^2]) of every grid point in one sweep (point p at epoch
    p): float64 (P,) tensors on ``device``.  Spans: ``prepare`` the call
    (the kernels are queued, not waited for), ``prepare.grid`` the
    parameter rows and the key."""
    with span("prepare"):
        with span("prepare.grid"):
            pm = grid_params()
            key = split_seed(seed)
        kw = dict(N=cfg.N, n_paths=cfg.n_paths, rng=rng, device=device)
        if method == "fe":
            fn = fe_sweep_cuda if engine == "cuda" else fe_sweep_plain
            return fn(pm, key, 0, **kw)
        fn = em_sweep_cuda if engine == "cuda" else em_sweep_plain
        return fn(pm, key, 0, conditional=conditional,
                  poisson_cut=BATCHED_EM_POISSON_CUT, **kw)


def sweep_batched(cfg: SimConfig, seed: int, out=sys.stdout,
                  engine: str = "cuda", method: str = "fe",
                  rng: str = "philox", conditional: bool = False,
                  device="cuda"):
    """FE/EM sweep as ONE kernel launch over the whole parameter grid —
    same CSV, amortized per-point time.  Each point prices at its own
    stream epoch."""
    device = resolve_device(device)
    pts = grid_points()

    def run_all():
        return batched_moments(cfg, seed, method, engine, rng, conditional,
                               device)

    torch.stack(run_all()).tolist()     # kernel build + warm-up
    _sync(device)
    t0 = time.perf_counter()
    ms, m2s = torch.stack(run_all()).tolist()   # one device->host copy
    per_point_ms = (time.perf_counter() - t0) * 1e3 / len(pts)

    for (k, theta, sigma), m, m2 in zip(pts, ms, m2s):
        err = SimResult(m, m2, cfg.n_paths).err
        print(f"{method}, {k:f}, {theta:f}, {sigma:f}, {per_point_ms:f}, "
              f"{err:f}", file=out, flush=True)


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="exploration",
        description="(k, theta, sigma) sweep; CSV on stdout")
    p.add_argument("--NTPB", type=int, default=512)
    p.add_argument("--NB", type=int, default=10)       # exploration.cu:25
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--engine", choices=["cuda", "scan"], default="cuda",
                   help="cuda = the hand-written kernels (default); scan "
                        "= the plain PyTorch versions")
    p.add_argument("--device", default="cuda",
                   help="torch device for the paths (default: cuda)")
    p.add_argument("--methods", default="fe,em",
                   help="comma-separated subset of fe,em")
    p.add_argument("--rng", choices=["philox", "threefry4", "xorwow",
                                     "mrg32k3a"],
                   default="philox",
                   help="philox or threefry4; the stateful families "
                        "xorwow/mrg32k3a in loop mode only (EM with "
                        "--engine scan)")
    p.add_argument("--conditional", action="store_true",
                   help="batched EM: closed-form conditional payoff "
                        "(CI ~1.9x smaller at the same cost)")
    p.add_argument("--batched", action="store_true",
                   help="price the whole grid in ONE kernel launch per "
                        "method")
    p.add_argument("--timed-reps", type=int, default=1,
                   help="loop mode: per-point time = average over this "
                        "many queued dispatches (incompatible with "
                        "--batched)")
    p.add_argument("--out", default=None, help="write CSV here (default "
                   "stdout, like the reference)")
    args = p.parse_args(argv)

    cfg = SimConfig(NTPB=args.NTPB, NB=args.NB, N=args.N, seed=args.seed)
    params = HestonParams()
    # validate BEFORE touching --out: opening truncates, and a typo'd
    # --methods must not destroy an existing sweep file
    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    unknown = [m for m in methods if m not in ("fe", "em")]
    if unknown:
        p.error(f"unknown method(s) {unknown}; valid: fe, em")
    if args.batched and args.timed_reps > 1:
        p.error("--timed-reps applies to loop mode only (the batched "
                "grid runs as one launch; its per-point time is the "
                "amortized total)")
    if args.timed_reps < 1:
        p.error("--timed-reps must be >= 1")
    if args.rng in ("xorwow", "mrg32k3a"):
        if args.batched:
            p.error(f"--rng {args.rng} needs loop mode (the batched "
                    f"sweep kernels use counter streams)")
        if args.engine != "scan" and "em" in methods:
            p.error(f"--rng {args.rng} with EM needs --engine scan (the "
                    f"samplers' state carry has no kernel; FE-only sweeps "
                    f"run csrc/fe_stateful.cu)")
    try:
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        p.error(str(e))
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        print("method, k, theta, sigma, execution_time, err", file=out,
              flush=True)
        for name in methods:
            if args.batched:
                sweep_batched(cfg, args.seed, out, engine=args.engine,
                              rng=args.rng, conditional=args.conditional,
                              method=name, device=device)
                continue
            cls = NMCH_FE if name == "fe" else NMCH_EM
            m = cls(cfg, params, engine=args.engine, rng=args.rng,
                    device=device)
            m.init(args.seed)
            sweep(m, name, out, timed_reps=args.timed_reps)
            m.finalize()
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
