"""Quickstart: price an ATM European call under Heston on the card.

The counterpart of ``examples/quickstart.py``, with the port's engines.
The 5-step lifecycle (same shape as the reference's README example):

    declare -> init(seed) -> compute() -> print_stats() -> finalize()

Run: ``python -m nmch_tpu_torch.examples.quickstart`` (a card;
``main(device="cpu", cfg=...)`` runs the plain versions on the CPU).
"""

from __future__ import annotations

from ..methods.em import NMCH_EM
from ..methods.fe import NMCH_FE
from ..oracle import heston_call_undiscounted
from ..params import HestonParams, SimConfig

DEFAULT_CFG = SimConfig(NTPB=512, NB=128, N=1000)    # 65,536 paths
EM_GREEKS_CFG = SimConfig(NTPB=512, NB=32, N=250)


def main(device="cuda", cfg: SimConfig | None = None) -> None:
    """Run the tour on ``device`` at ``cfg`` (default 65,536 paths x
    N=1000; the EM sensitivities at 16,384 x 250 unless ``cfg`` is
    given)."""
    params = HestonParams(k=0.5, rho=-0.7, theta=0.1, sigma=0.3)
    em_greeks_cfg = EM_GREEKS_CFG if cfg is None else cfg
    cfg = DEFAULT_CFG if cfg is None else cfg

    print(f"Semi-analytic Heston price: "
          f"{heston_call_undiscounted(params):.6f}\n")

    for cls in (NMCH_FE, NMCH_EM):
        m = cls(cfg, params, device=device)  # engine="cuda" by default
        m.init(seed=1234)
        m.compute()                     # warm-up (builds the kernels once)
        m.compute()                     # timed run on fresh draws
        m.print_stats()
        print()
        m.finalize()

    # parameter sweep with persistent RNG streams (no re-seeding):
    m = NMCH_FE(cfg, params, device=device)
    m.init(seed=1234)
    m.compute()
    for sigma in (0.2, 0.3, 0.4):
        m.set_sigma(sigma)
        res = m.compute()
        print(f"sigma={sigma}: price={res.price:.6f} +/- {res.err:.2e} "
              f"({res.exec_time_ms:.1f} ms)")
    m.finalize()

    # the fast/accurate variants beyond the reference (see README):
    print("\nvariance-reduced / QMC variants:")
    for label, kwargs in (
        ("FE rot=4 rotation sampling (headline)", dict(rot=4)),
        ("FE scrambled-Sobol + Brownian bridge", dict(engine="qmc")),
        ("FE QMC with full Owen scrambling", dict(engine="qmc",
                                                  scramble="owen")),
        ("FE MRG32k3a (curand's third family)", dict(rng="mrg32k3a")),
    ):
        m = NMCH_FE(cfg, params, device=device, **kwargs)
        m.init(seed=1234)
        m.compute()
        res = m.compute()
        print(f"  {label}: price={res.price:.6f} "
              f"ci={res.ci_error:.2e} ({res.exec_time_ms:.1f} ms)")
        m.finalize()
    m = NMCH_EM(cfg, params, rng="threefry4", conditional=True,
                device=device)
    m.init(seed=1234)
    m.compute()
    res = m.compute()
    print(f"  EM threefry4 + conditional MC: price={res.price:.6f} "
          f"ci={res.ci_error:.2e} ({res.exec_time_ms:.1f} ms)")
    m.finalize()

    # pathwise Greeks: forward-mode tangents on the card (kernel G1),
    # torch.autograd through the plain Euler steps on the CPU
    m = NMCH_FE(cfg, params, device=device)
    m.init(seed=1234)
    g = m.greeks()
    print("\npathwise Greeks (one epoch of draws): "
          + ", ".join(f"d/d{k}={v:+.4f}" for k, v in g.items()
                      if k != "price"))
    m.finalize()

    # EM sensitivities: exactly-pathwise (S_0, r, rho) through the
    # conditional payoff + CRN finite differences for the
    # rejection-sampled parameters (ops/em_greeks.py): K2's law build
    # and ten conditional launches on the card
    m = NMCH_EM(em_greeks_cfg, params, device=device)
    m.init(seed=1234)
    g = m.greeks(fd=True)
    print("EM sensitivities (pathwise S_0/r/rho, CRN-FD rest): "
          + ", ".join(f"d/d{k}={v:+.4f}" for k, v in g.items()
                      if k != "price"))
    m.finalize()


if __name__ == "__main__":
    main()
