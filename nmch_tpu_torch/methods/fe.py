"""Forward-Euler pricing method (reference L4: the NMCH_FE_* family).

Two engines, as in ``nmch_tpu/methods/fe.py``:

    engine="cuda" (default) — the hand-written kernel
                              (ops/fe_cuda.py -> csrc/fe.cu);
    engine="scan"           — the plain PyTorch golden (ops/fe.py),
                              the oracle the kernel is held against.

Both draw from counter-based Philox4x32-10 or Threefry-4x32-12 streams
keyed by (seed, path, epoch), bitwise the streams of ``nmch_tpu``.  The
other RNG families, rotation sampling and the QMC engine are later
slices of the port (ROADMAP.md Queue 1) and are refused by name until
they land.
"""

from __future__ import annotations

from ..ops.fe import fe_moments_scan, path_index_grid
from ..ops.fe_cuda import fe_moments_cuda
from ..params import HestonParams, SimConfig
from .base import NMCH

_LATER_RNGS = {
    "threefry": "slice 3 (FE variants), item 10",
    "tpu": "slice 3 (FE variants), item 12: the device-PRNG kernel",
    "mrg32k3a": "slice 5 (stateful curand families)",
    "xorwow": "slice 5 (stateful curand families)",
}


class NMCH_FE(NMCH):
    """Euler-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "FORWARD-EULER"

    def __init__(self, cfg: SimConfig, params: HestonParams,
                 engine: str = "cuda", rng: str = "philox",
                 antithetic: bool = False, rot: int | None = None,
                 device="cuda"):
        """device: where the paths run.  "cuda" needs a card and never
        falls back to the CPU; engine="cuda" on device="cpu" runs the
        kernel wrapper's plain version."""
        if engine == "qmc":
            raise ValueError("engine='qmc' is not ported yet (ROADMAP.md "
                             "Queue 1, slice 6: QMC)")
        if engine not in ("cuda", "scan"):
            raise ValueError(f"unknown engine {engine!r} (expected 'cuda' "
                             f"or 'scan')")
        if rng in _LATER_RNGS:
            raise ValueError(f"rng={rng!r} is not ported yet (ROADMAP.md "
                             f"Queue 1, {_LATER_RNGS[rng]})")
        if rng not in ("philox", "threefry4"):
            raise ValueError(f"unknown rng {rng!r} (NMCH_FE supports "
                             f"philox/threefry4)")
        if rot not in (None, 1, 2, 4, 8):
            raise ValueError(f"rot must be 1, 2, 4 or 8, got {rot}")
        if antithetic or rot not in (None, 1):
            raise ValueError("rotation sampling (antithetic / rot 2, 4, 8) "
                             "is not ported yet (ROADMAP.md Queue 1, "
                             "slice 3: FE variants)")
        super().__init__(cfg, params, device)
        self.engine = engine
        self.rng = rng

    def _moments(self, epoch: int):
        k0, k1 = self.streams.key_words
        if self.engine == "cuda":
            return fe_moments_cuda(
                self.params.as_tensor("cpu"), (k0, k1), epoch, 0,
                N=self.cfg.N, n_paths=self.cfg.n_paths, device=self.device,
                rng=self.rng)
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        return fe_moments_scan(self.params.as_tensor(self.device),
                               self.cfg.N, pidx, epoch, k0, k1, rng=self.rng)
