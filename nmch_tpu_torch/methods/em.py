"""Broadie–Kaya exact-method pricer (reference L4: the NMCH_EM_* family).

Two engines, as in ``nmch_tpu/methods/em.py``:

    engine="cuda" (default) — the hand-written kernel
                              (ops/em_cuda.py -> csrc/em.cu);
    engine="scan"           — the plain PyTorch golden (ops/em.py),
                              the oracle the kernel is held against.

Both draw from the counter-based philox or threefry4 streams keyed by
(seed, path, epoch), bitwise the streams of ``nmch_tpu``.  The stateful
curand families and the sensitivities are later slices of the port
(ROADMAP.md Queue 1) and are refused by name until they land.
"""

from __future__ import annotations

from ..ops.em import FAST_POISSON_CUT, em_moments_scan
from ..ops.em_cuda import em_moments_cuda
from ..ops.fe import path_index_grid
from ..params import HestonParams, SimConfig
from .base import NMCH

_LATER_RNGS = {
    "mrg32k3a": "slice 5 (stateful curand families)",
    "xorwow": "slice 5 (stateful curand families)",
}


class NMCH_EM(NMCH):
    """Exact-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "EXACT-METHOD"  # NMCH_EM.cu:405

    def __init__(self, cfg: SimConfig, params: HestonParams,
                 engine: str = "cuda", rng: str = "philox",
                 conditional: bool = False,
                 poisson_cut: float | None = None, device="cuda"):
        """conditional=True prices each path with the exact Black–Scholes
        expectation of its payoff given the variance path (same mean,
        smaller CI, one fewer draw per path).

        poisson_cut: lambda at and above which the variance transition's
        Poisson index is drawn by the one-round normal approximation
        instead of PTRS rejection.  None means FAST_POISSON_CUT = 128, the
        method layer's default in ``nmch_tpu`` too; 4000.0 is curand's
        switch (NMCH_EM.cu:102).

        device: where the paths run.  "cuda" needs a card and never falls
        back to the CPU; engine="cuda" on device="cpu" runs the kernel
        wrapper's plain version."""
        if engine not in ("cuda", "scan"):
            raise ValueError(f"unknown engine {engine!r} (expected 'cuda' "
                             f"or 'scan')")
        if rng in _LATER_RNGS:
            raise ValueError(f"rng={rng!r} is not ported yet (ROADMAP.md "
                             f"Queue 1, {_LATER_RNGS[rng]})")
        if rng not in ("philox", "threefry4"):
            raise ValueError(f"unknown rng {rng!r} (NMCH_EM supports "
                             f"philox/threefry4)")
        super().__init__(cfg, params, device)
        self.engine = engine
        self.rng = rng
        self.conditional = bool(conditional)
        self.poisson_cut = (FAST_POISSON_CUT if poisson_cut is None
                            else float(poisson_cut))

    def _moments(self, epoch: int):
        k0, k1 = self.streams.key_words
        if self.engine == "cuda":
            return em_moments_cuda(
                self.params.as_tensor("cpu"), (k0, k1), epoch, 0,
                N=self.cfg.N, n_paths=self.cfg.n_paths, device=self.device,
                rng=self.rng, conditional=self.conditional,
                poisson_cut=self.poisson_cut)
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        return em_moments_scan(self.params.as_tensor(self.device),
                               self.cfg.N, pidx, epoch, k0, k1,
                               rng=self.rng, conditional=self.conditional,
                               poisson_cut=self.poisson_cut)

    def greeks(self, *args, **kwargs) -> dict:
        raise NotImplementedError("EM sensitivities are not ported yet "
                                  "(ROADMAP.md Queue 1, slice 7: "
                                  "sensitivities)")
