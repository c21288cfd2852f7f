"""Broadie–Kaya exact-method pricer (reference L4: the NMCH_EM_* family).

Two engines, as in ``nmch_tpu/methods/em.py``:

    engine="cuda" (default) — the hand-written kernel
                              (ops/em_cuda.py -> csrc/em.cu);
    engine="scan"           — the plain PyTorch golden (ops/em.py),
                              the oracle the kernel is held against.

Both draw from the counter-based philox or threefry4 streams keyed by
(seed, path, epoch), bitwise the streams of ``nmch_tpu``.  The stateful
curand families xorwow and mrg32k3a (the reference prices EM with XORWOW,
exploration.cu:54-55) run on the scan engine only, as in ``nmch_tpu``
(methods/em.py:61-67): each path's recurrence state starts at stream
(seed, path, epoch) and is carried through the sampler rounds.  The
sensitivities are a later slice of the port (ROADMAP.md Queue 1) and are
refused by name until they land.
"""

from __future__ import annotations

from ..ops.em import FAST_POISSON_CUT, em_moments_scan
from ..ops.em_cuda import em_moments_cuda
from ..ops.fe import path_index_grid
from ..ops.sampling import STATEFUL_RNGS
from ..params import HestonParams, SimConfig
from ..rng.streams import check_stateful_epoch, check_stateful_paths
from .base import NMCH


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
        if rng not in ("philox", "threefry4", *STATEFUL_RNGS):
            raise ValueError(f"unknown rng {rng!r} (NMCH_EM supports "
                             f"philox/threefry4/mrg32k3a/xorwow)")
        if rng in STATEFUL_RNGS:
            # the state carry through the rejection samplers has no kernel
            if engine != "scan":
                raise ValueError(f"rng={rng!r} requires engine='scan'")
            check_stateful_paths(rng, cfg.n_paths)
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
        seed = None
        if self.rng in STATEFUL_RNGS:
            check_stateful_epoch(self.rng, epoch)
            seed = self.streams.seed
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        return em_moments_scan(self.params.as_tensor(self.device),
                               self.cfg.N, pidx, epoch, k0, k1,
                               rng=self.rng, conditional=self.conditional,
                               poisson_cut=self.poisson_cut, seed=seed)

    def greeks(self, *args, **kwargs) -> dict:
        raise NotImplementedError("EM sensitivities are not ported yet "
                                  "(ROADMAP.md Queue 1, slice 7: "
                                  "sensitivities)")
