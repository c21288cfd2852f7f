"""Probe: the QMC bridge product fused into the path simulator, on the card:
the counterpart of ``benchmarks/qmc_fused_probe.py``.

The production QMC pipeline (``ops/fe_qmc.py::fe_moments_qmc``) runs
three device stages with device-memory temporaries between them:

    Sobol' + ndtri  ->  z (N, M)  ->  sqrt(dt) A @ z (float32 products)
    ->  dW (N, M)  ->  K6 (csrc/qmc.cu)

At 2^19 points x N=1000, dW alone is 4.2 GB written and read again.  The
fused kernel (K9, and K10 with ``--hilo``: ``ops/qmc_fused_cuda.py`` ->
``csrc/qmc_fused.cu``) consumes the normals directly: each point's
thread makes its increments from its own column of z and steps them at
once, so no dW reaches device memory.  The script holds the fused sums
to production's (the same Brownian law in two schedules: AGREE within
5e-4 rel) and times both routes, plus the normals alone, the two
float32 bridge products alone and the fused kernel alone, so that each
stage's share shows.

``--precision`` HIGHEST|HIGH|DEFAULT selects the fused product (float32,
three bf16 hi/lo products, one bf16 product); ``--hilo`` is HIGH.
``--cpu`` runs both routes' plain versions on the CPU, a correctness
check only (use a small ``--n``/``--N``).

Run: python -m nmch_tpu_torch.benchmarks.qmc_fused_probe [--n 524288
--N 1000 --n-shifts 8] [--hilo]   (on the card)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..methods.base import resolve_device
from ..ops import fe_qmc
from ..ops.fe_qmc_cuda import qmc_payoff_sums_cuda
from ..ops.qmc_fused_cuda import qmc_payoff_sums_fused_cuda
from ..params import HestonParams
from ..rng.philox import split_seed
from ..utils.timing import card_name_and_power_limit, timed_blocked

AGREE_REL = 5e-4          # qmc_fused_probe.py:259
REPS = 3                  # qmc_fused_probe.py:194


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--N", type=int, default=1000)
    ap.add_argument("--n-shifts", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU: a correctness check "
                         "only")
    ap.add_argument("--precision", type=str, default="HIGHEST",
                    choices=fe_qmc.PRECISIONS)
    ap.add_argument("--hilo", action="store_true",
                    help="3-pass bf16 hi/lo fused kernel (f32-grade); "
                         "the same as --precision HIGH")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu") if args.cpu else resolve_device("cuda")
    precision = "HIGH" if args.hilo else args.precision
    params = HestonParams().as_tensor("cpu")
    T = HestonParams().T
    k0, k1 = (int(w) for w in split_seed(1234))
    n = args.n // args.n_shifts
    N = args.N
    R = args.n_shifts
    if not args.cpu:
        print(card_name_and_power_limit(), flush=True)

    A = fe_qmc.bb_increment_matrix(N)
    sqrt_dt = np.sqrt(T / N).astype(np.float32)
    A_scaled = torch.from_numpy(sqrt_dt * A).to(device)

    def normals(ep):
        return fe_qmc.qmc_normals_mxu(N, n, ep, k0, k1, n_shifts=R,
                                      device=device)

    def prod(ep):
        dW1, dW2 = fe_qmc.qmc_increments_mxu(N, n, ep, k0, k1, params[0],
                                             n_shifts=R, device=device)
        return qmc_payoff_sums_cuda(params, dW1, dW2, R)

    def fused(ep):
        z1, z2 = normals(ep)
        return qmc_payoff_sums_fused_cuda(params, z1, z2, A_scaled, R,
                                          precision=precision)

    ep = 3
    sp = prod(ep)[0].cpu().numpy()
    sf = fused(ep)[0].cpu().numpy()
    rel = float(np.max(np.abs(sf - sp) / np.maximum(np.abs(sp), 1e-30)))
    print(f"replicate sums prod vs fused: max rel diff {rel:.3e}")
    print("  prod :", np.array2string(sp, precision=2))
    print("  fused:", np.array2string(sf, precision=2))
    # two schedules of the same Brownian law: agreement to ~1e-5 rel on
    # ~1e5-path sums means the fused product is right
    ok = rel < AGREE_REL
    print("AGREE" if ok else "MISMATCH", flush=True)
    rec = {"precision": precision, "n_paths": args.n, "N": N,
           "n_shifts": R, "max_rel_diff": rel, "agree": ok,
           "prod_sums": sp.tolist(), "fused_sums": sf.tolist()}
    if args.cpu:
        print(json.dumps(rec))
        return 0 if ok else 1

    _, t_p = timed_blocked(lambda: prod(ep), device, REPS)
    _, t_f = timed_blocked(lambda: fused(ep), device, REPS)
    z1, z2 = normals(ep)
    _, t_z = timed_blocked(lambda: normals(ep), device, REPS)
    _, t_b = timed_blocked(lambda: (fe_qmc._matmul_f32(A_scaled, z1),
                                    fe_qmc._matmul_f32(A_scaled, z2)),
                           device, REPS)
    _, t_k = timed_blocked(lambda: qmc_payoff_sums_fused_cuda(
        params, z1, z2, A_scaled, R, precision=precision), device, REPS)
    del z1, z2
    g_p = args.n * N / t_p / 1e6
    g_f = args.n * N / t_f / 1e6
    print(f"production (3-stage): {t_p:7.1f} ms  {g_p:6.2f} G")
    print(f"fused (z -> kernel):  {t_f:7.1f} ms  {g_f:6.2f} G")
    print(f"speedup: {t_p / t_f:.3f}x")
    print(f"  of which normals (both routes): {t_z:7.1f} ms; "
          f"bridge products (production, 2 x f32): {t_b:7.1f} ms; "
          f"fused kernel: {t_k:7.1f} ms")
    rec.update(prod_ms=t_p, fused_ms=t_f, speedup=t_p / t_f,
               normals_ms=t_z, bridge_ms=t_b, kernel_ms=t_k,
               prod_gpath_steps=g_p,
               fused_gpath_steps=g_f)
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
