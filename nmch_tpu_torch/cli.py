"""``nmch`` CLI of the PyTorch port — the reference's single-run executable.

Same flags and defaults as ``nmch_tpu/cli.py`` (the reference's
``src/NMCH/test/nmch.cu:67-113`` surface with its actual defaults:
NTPB=512, NB=512, N=1000, seed=1234), except:

* ``--engine cuda|scan|qmc`` (default: cuda, the hand-written kernels,
  except for EM with a stateful family, which only the scan engine runs,
  as ``nmch_tpu``'s default resolves to scan there; qmc is FE only) and
  ``--device`` (default cuda; never falls back to the CPU);
* ``--rng device``, the card's own stream (``rng/device.py``), in place
  of ``--rng tpu`` (the TPU's hardware generator): tpu stays a choice, as
  in ``nmch_tpu``, and exits 2 with a message that names device.

``--greeks`` adds the sensitivities after the timed run, as in
``nmch_tpu``: FE with a counter rng (philox/threefry/threefry4) the
pathwise Greeks of all 8 parameters (kernel G1 on the card), EM the
pathwise (S_0, r, rho) and the CRN central differences of the other five
(K2's law build and ten conditional launches); other FE rngs print a note
and skip them.  The stats line keeps ``nmch_tpu``'s labels, "Pathwise
Greeks (jax.grad)" included, so that the two CLIs print the same text:
the port computes those values by forward-mode tangents (G1) on the card
and by torch.autograd on the CPU, and runs no JAX.

Run: ``python -m nmch_tpu_torch.cli`` (the FE main path on the card) or
``python -m nmch_tpu_torch.cli --method em`` (the exact scheme, with
``--conditional`` and ``--poisson-cut``); both methods take
``--rng philox|threefry4|xorwow|mrg32k3a`` (FE with xorwow or mrg32k3a
runs the stateful kernel ``csrc/fe_stateful.cu``), FE also ``--rng
threefry|device`` and rotation sampling (``--rot 2|4|8``,
``--antithetic``); ``--engine qmc [--scramble auto|lms-shift|shift|owen]``
prices FE by randomized QMC (kernel ``csrc/qmc.cu``) and adds the RQMC
CI to the stats block.
"""

from __future__ import annotations

import argparse
import json
import sys

from .methods.em import NMCH_EM
from .methods.fe import NMCH_FE
from .oracle import heston_call_undiscounted
from .params import HestonParams, SimConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nmch",
        description="Heston Monte Carlo pricer (NMCH rebuild), PyTorch/CUDA")
    p.add_argument("--NTPB", type=int, default=512,
                   help="paths per block-equivalent (default: 512)")
    p.add_argument("--NB", type=int, default=512,
                   help="number of blocks-equivalent (default: 512)")
    p.add_argument("--T", type=float, default=1.0, help="maturity")
    p.add_argument("--S_0", type=float, default=1.0, help="spot (=strike)")
    p.add_argument("--v_0", type=float, default=0.1, help="initial variance")
    p.add_argument("--r", type=float, default=0.0, help="risk-free rate")
    p.add_argument("--k", type=float, default=0.5, help="mean reversion")
    p.add_argument("--rho", type=float, default=-0.7, help="correlation")
    p.add_argument("--theta", type=float, default=0.1,
                   help="long-term variance")
    p.add_argument("--sigma", type=float, default=0.3, help="vol of vol")
    p.add_argument("--N", type=int, default=1000, help="time steps")
    p.add_argument("--seed", type=int, default=1234, help="RNG seed")
    p.add_argument("--method", choices=["fe", "em"], default="fe",
                   help="fe = Forward Euler (default); em = Broadie-Kaya "
                        "exact simulation")
    p.add_argument("--engine", choices=["cuda", "scan", "qmc"],
                   default=None,
                   help="cuda = the hand-written kernel (the default, "
                        "except EM with xorwow/mrg32k3a: scan); scan = "
                        "the plain PyTorch golden; qmc = scrambled Sobol' "
                        "+ Brownian bridge (FE only; error ~ n^-0.8)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the paths (default: cuda)")
    p.add_argument("--rng", choices=["philox", "threefry", "threefry4",
                                     "tpu", "device", "mrg32k3a", "xorwow"],
                   default="philox",
                   help="mrg32k3a / xorwow = the reference's two stateful "
                        "curand families (FE prices them on either "
                        "engine, EM needs --engine scan); device = the "
                        "card's own stream (FE, --engine cuda), in place "
                        "of tpu, the TPU's hardware generator")
    p.add_argument("--poisson-cut", type=float, default=None,
                   help="EM only: lambda at and above which the Poisson "
                        "mixture index uses the one-round normal "
                        "approximation (default 128; 4000 = curand's "
                        "switch)")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic-variates variance reduction (FE only; "
                        "each path becomes a +/-G pair, CI typically "
                        "shrinks ~2x at the same path count; == --rot 2)")
    p.add_argument("--rot", type=int, choices=[1, 2, 4, 8], default=None,
                   help="rotation-coupled copies per path group (FE only): "
                        "2=antithetic, 4=+quarter-turn angle "
                        "stratification, 8=+radius-antithetic pairs")
    p.add_argument("--conditional", action="store_true",
                   help="EM only: price with the exact conditional "
                        "expectation of the payoff given the variance path")
    p.add_argument("--scramble", choices=["auto", "lms-shift", "shift",
                                          "owen"],
                   default="auto",
                   help="QMC randomization (--engine qmc only): auto "
                        "(default; lms-shift below 2^21 points, owen "
                        "from there), lms-shift, shift, or owen "
                        "(hash-based Owen scrambles, independent per "
                        "replicate)")
    p.add_argument("--oracle", action="store_true",
                   help="also print the semi-analytic Heston price")
    p.add_argument("--greeks", action="store_true",
                   help="also compute sensitivities: FE pathwise Greeks "
                        "(counter rngs), EM pathwise S_0/r/rho + CRN-FD "
                        "for T/v_0/k/theta/sigma")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the untimed warm-up run (timing will include "
                        "the kernel build, like the reference's first run)")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line instead of "
                        "the human stats block")
    return p


def run(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.engine is None:
        # resolve the default, never downgrade: EM's stateful families
        # run on the scan engine only (nmch_tpu/cli.py:113-121)
        args.engine = ("scan" if args.method == "em"
                       and args.rng in ("mrg32k3a", "xorwow") else "cuda")
    if args.method == "em" and args.engine == "qmc":
        parser.error("--engine qmc is FE-only (the Sobol'/Brownian-"
                     "bridge construction has no EM analogue)")
    if args.scramble != "auto" and (args.method != "fe"
                                    or args.engine != "qmc"):
        print("note: --scramble applies to --method fe --engine qmc "
              "only; ignoring", file=sys.stderr)
        args.scramble = "auto"
    params = HestonParams(T=args.T, S_0=args.S_0, v_0=args.v_0, r=args.r,
                          k=args.k, rho=args.rho, theta=args.theta,
                          sigma=args.sigma)
    cfg = SimConfig(NTPB=args.NTPB, NB=args.NB, N=args.N, seed=args.seed)
    if args.method == "fe":
        if args.conditional:
            print("note: --conditional is EM-only; ignoring",
                  file=sys.stderr)
        if args.poisson_cut is not None:
            print("note: --poisson-cut is EM-only; ignoring",
                  file=sys.stderr)
        cls = NMCH_FE
        kwargs = {"antithetic": args.antithetic, "rot": args.rot,
                  "scramble": args.scramble}
    else:
        if args.rng in ("threefry", "tpu", "device"):
            parser.error(f"--method em does not support --rng {args.rng} "
                         f"(choose philox/threefry4/mrg32k3a/xorwow)")
        if args.antithetic or args.rot:
            print("note: --antithetic/--rot are FE-only; ignoring",
                  file=sys.stderr)
        cls = NMCH_EM
        kwargs = {"conditional": args.conditional,
                  "poisson_cut": args.poisson_cut}
    try:
        m = cls(cfg, params, engine=args.engine, rng=args.rng,
                device=args.device, **kwargs)
    except (ValueError, RuntimeError) as e:
        # invalid combinations (e.g. --method em --rng xorwow --engine
        # cuda), unported options and a missing card are parser errors
        parser.error(str(e))
    m.init(args.seed)
    if not args.no_warmup:
        # discard the first run (kernel build), like exploration.cu:65-67;
        # the warm-up draws its own epoch, so the timed run is fresh
        m.compute()
    res = m.compute()
    greeks = None
    if args.greeks:
        if args.method == "fe" and args.rng in ("philox", "threefry",
                                                "threefry4"):
            greeks = m.greeks()
        elif args.method == "em":
            # pathwise (S_0, r, rho) + CRN-FD (T, v_0, k, theta, sigma);
            # a stateful rng raises greeks()'s ValueError, as in nmch_tpu
            greeks = m.greeks(fd=True)
        else:
            print("note: --greeks needs a counter rng; ignoring",
                  file=sys.stderr)
    if args.json:
        rec = {
            "method": args.method, "engine": args.engine,
            "n_paths": cfg.n_paths, "N": cfg.N, "seed": args.seed,
            "price": res.price, "price_squared": res.price_squared,
            # null for the QMC engine: the reference err formula has no
            # meaning for its synthesized moments
            "err": None if res.synthesized_moments else res.err,
            "ci_error": res.ci_error,
            "exec_time_ms": res.exec_time_ms,
            "init_time_ms": m.init_time_ms,
        }
        if greeks is not None:
            rec["greeks"] = {k: v for k, v in greeks.items()
                             if k != "price"}
        if args.oracle:
            rec["heston_oracle"] = heston_call_undiscounted(params)
        print(json.dumps(rec))
    else:
        m.print_stats()
        if args.engine == "qmc":
            # the honest accuracy of the QMC engine: the t-quantile CI
            # over the randomized replicates
            print(f"RQMC 95% CI (shift-replicate spread): "
                  f"{res.ci_error:e}")
        if greeks is not None:
            gl = ", ".join(f"d/d{k}={v:+.5f}" for k, v in greeks.items()
                           if k != "price")
            # nmch_tpu's labels, kept for output parity (module docstring)
            label = ("Pathwise Greeks (jax.grad)" if args.method == "fe"
                     else "EM sensitivities (pathwise S_0/r/rho, CRN-FD "
                          "rest)")
            print(f"{label}: {gl}")
        if args.oracle:
            print(f"Semi-analytic Heston price (undiscounted): "
                  f"{heston_call_undiscounted(params):f}")
    m.finalize()
    return 0


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
