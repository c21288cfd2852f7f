"""LRM (score-function) against CRN-FD spread for the five non-pathwise EM
sensitivities: the counterpart of ``benchmarks/lrm_vs_fd.py``.

The score variance of ``ops/em_lrm.py`` grows ~ N * lam, so LRM should win
at coarse grids and lose to CRN-FD (``ops/em_greeks.py::em_greeks_fd``) as
N grows.  For each N of the ladder both estimators run over E epochs at
the same n_paths; the table gives each parameter's mean +- std and the
semi-analytic oracle's central difference.  On the card the estimators
run kernels K2-LRM and K2 (conditional); ``--device cpu`` runs their plain
versions.  Hardware speed does not enter the table, only the estimators'
spread.

Run: ``python -m nmch_tpu_torch.benchmarks.lrm_vs_fd [--n-paths 16384
--epochs 8 --Ns 8,16,32,64,128] [--device cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from ..methods.base import resolve_device
from ..ops.em_greeks import em_greeks_fd
from ..ops.em_lrm import LRM_PARAMS, em_greeks_lrm
from ..oracle import heston_call_undiscounted
from ..params import HestonParams
from ..rng.philox import split_seed


def oracle_fd(P: HestonParams, rel: float = 1e-3) -> dict:
    """The oracle's central difference of each LRM parameter, h = rel *
    max(|x|, 0.05)."""
    truth = {}
    for name in LRM_PARAMS:
        x = getattr(P, name)
        h = rel * max(abs(x), 0.05)
        up = dataclasses.replace(P, **{name: x + h})
        dn = dataclasses.replace(P, **{name: x - h})
        truth[name] = (heston_call_undiscounted(up)
                       - heston_call_undiscounted(dn)) / (2 * h)
    return truth


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-paths", type=int, default=1 << 14)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--Ns", type=str, default="8,16,32,64,128")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    P = HestonParams()
    k0, k1 = (int(w) for w in split_seed(0))
    pv = P.as_tensor("cpu")
    truth = oracle_fd(P)

    print(f"n_paths={args.n_paths} epochs={args.epochs}")
    print(f"{'N':>5s} {'param':>6s} {'oracle':>9s} "
          f"{'LRM mean+-std':>20s} {'CRN-FD mean+-std':>20s} {'winner':>7s}")
    for N in (int(s) for s in args.Ns.split(",")):
        acc = {name: ([], []) for name in LRM_PARAMS}
        for e in range(args.epochs):
            _, gl = em_greeks_lrm(pv, e, k0, k1, N=N, n_paths=args.n_paths,
                                  device=device)
            gf = em_greeks_fd(pv, e, k0, k1, N=N, n_paths=args.n_paths,
                              device=device)
            for name in LRM_PARAMS:
                acc[name][0].append(float(gl[name]))
                acc[name][1].append(float(gf[name]))
        for name in LRM_PARAMS:
            lm, ls = np.mean(acc[name][0]), np.std(acc[name][0])
            fm, fs = np.mean(acc[name][1]), np.std(acc[name][1])
            win = "LRM" if ls < fs else "FD"
            print(f"{N:5d} {name:>6s} {truth[name]:9.4f} "
                  f"{lm:10.4f}+-{ls:8.4f} {fm:10.4f}+-{fs:8.4f} {win:>7s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
