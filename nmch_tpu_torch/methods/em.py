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
(seed, path, epoch) and is carried through the sampler rounds.
``greeks()`` gives the sensitivities (pathwise, CRN-FD or score function)
with the counter families.
"""

from __future__ import annotations

import torch

from ..ops.em import FAST_POISSON_CUT, em_moments_scan
from ..ops.em_cuda import em_moments_cuda
from ..ops.fe import path_index_grid
from ..ops.launch import BoundLaunch
from ..ops.sampling import STATEFUL_RNGS
from ..params import HestonParams, SimConfig
from ..rng.streams import check_stateful_epoch, check_stateful_paths
from .base import NMCH


class NMCH_EM(NMCH):
    """Exact-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "EXACT-METHOD"  # NMCH_EM.cu:405
    # K2's counts of a launch (engine "cuda" on a card; em_moments_cuda;
    # warp_iters on the round schedule only)
    count_names = ("k2.blocks", "k2.warp_iters")

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
        method layer's default in ``nmch_tpu`` too, a shortcut: at the
        CLI's parameters every step then takes the normal.  4000.0 is
        curand's own switch (NMCH_EM.cu:102), so it samples the
        reference's law: PTRS for 10 <= lambda < 4000.

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
        if engine == "cuda" and self.device.type == "cuda":
            self._launch = BoundLaunch()

    def _moments(self, epoch: int):
        k0, k1 = self.streams.key_words
        if self.engine == "cuda":
            return em_moments_cuda(
                self._kernel_params(), (k0, k1), epoch, 0,
                N=self.cfg.N, n_paths=self.cfg.n_paths, device=self.device,
                rng=self.rng, conditional=self.conditional,
                poisson_cut=self.poisson_cut, counts=True,
                launch=self._launch)
        seed = None
        if self.rng in STATEFUL_RNGS:
            check_stateful_epoch(self.rng, epoch)
            seed = self.streams.seed
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        return em_moments_scan(self.params.as_tensor(self.device),
                               self.cfg.N, pidx, epoch, k0, k1,
                               rng=self.rng, conditional=self.conditional,
                               poisson_cut=self.poisson_cut, seed=seed)

    def greeks(self, fix_strike: bool = False,
               fd: bool = False, lrm: bool = False) -> dict:
        """EM sensitivities (ops/em_greeks.py, ops/em_lrm.py).  Default:
        the exactly pathwise subset, dP/dS_0, dP/dr and dP/drho, by
        autograd through the conditional payoff with each path's variance
        path held fixed.  fd=True adds central differences with common
        random numbers for (T, v_0, k, theta, sigma), whose Poisson and
        Gamma rejection sampling breaks pathwise differentiation; lrm=True
        estimates the same five by the score function instead, at the
        strict Poisson cut 4000.  Consumes one epoch (two with fd or lrm).
        On a card the paths come from kernel K2: its law build, ten
        conditional launches (fd) or K2-LRM (lrm); on the CPU from the
        plain versions.  Returns {"price": float, "S_0": ..., ...}."""
        if fd and lrm:
            raise ValueError("pass fd=True or lrm=True, not both (they "
                             "estimate the same five parameters)")
        if self.streams is None:
            raise RuntimeError("call init(seed) before greeks()")
        if self.rng not in ("philox", "threefry4"):
            raise ValueError("greeks() needs a counter rng "
                             "(philox/threefry4)")
        from ..ops.em_greeks import em_greeks_fd, em_price_and_greeks
        from ..ops.em_lrm import em_greeks_lrm
        k0, k1 = self.streams.key_words
        pv = self.params.as_tensor("cpu")
        kw = dict(N=self.cfg.N, n_paths=self.cfg.n_paths, rng=self.rng,
                  device=self.device)
        price, grads = em_price_and_greeks(
            pv, self.streams.next_epoch(), k0, k1,
            poisson_cut=self.poisson_cut, fix_strike=fix_strike, **kw)
        extra = {}
        if fd:
            extra = em_greeks_fd(pv, self.streams.next_epoch(), k0, k1,
                                 poisson_cut=self.poisson_cut, **kw)
        elif lrm:
            # the strict cut (None -> 4000): the scored density must be the
            # sampled law (ops/em_lrm.py)
            _, extra = em_greeks_lrm(pv, self.streams.next_epoch(), k0, k1,
                                     **kw)
        # nmch_tpu's key order: each of its dicts comes back from jit
        # sorted by name
        out = {"price": price, **dict(sorted(grads.items())),
               **dict(sorted(extra.items()))}
        vals = torch.stack([v.to("cpu") for v in out.values()]).tolist()
        return dict(zip(out, vals))
