"""Forward-Euler pricing method (reference L4: the NMCH_FE_* family).

Three engines, as in ``nmch_tpu/methods/fe.py``:

    engine="cuda" (default) — the hand-written kernels (ops/fe_cuda.py ->
                              csrc/fe.cu; the stateful families
                              ops/fe_stateful_cuda.py -> csrc/fe_stateful.cu);
    engine="scan"           — the plain PyTorch goldens (ops/fe.py,
                              ops/fe_xorwow.py, ops/fe_mrg.py), the oracles
                              the kernels are held against;
    engine="qmc"            — scrambled Sobol' points and a Brownian bridge
                              (ops/fe_qmc.py), paths simulated by the kernel
                              ops/fe_qmc_cuda.py -> csrc/qmc.cu; its moments
                              are synthesized from the replicate spread, so
                              only ``ci_error`` is meaningful.

The counter families philox, threefry and threefry4 draw from streams
keyed by (seed, path, epoch); the stateful curand families xorwow (the
reference's default, random.cu:6-8) and mrg32k3a carry a 6-word state per
path, placed on the same (seed, path, epoch) layout by skip-ahead.  All
are bitwise the streams of ``nmch_tpu``.  rng="device" is the card's own
stream (rng/device.py), the counterpart of nmch_tpu's rng="tpu" (the
TPU's hardware generator, refused here by name), on engine="cuda" only.
Rotation sampling (``rot`` 2, 4, 8; ``antithetic`` is rot 2) prices the
mean of rot coupled copies per stream, with the counter families.
``greeks()`` gives the pathwise sensitivities (kernel G1 on a card).
"""

from __future__ import annotations

import torch

from ..ops.fe import DEVICE_NOT_TPU, fe_moments_rot_scan, fe_moments_scan, \
    path_index_grid
from ..ops.fe_cuda import fe_moments_cuda, resolve_rot
from ..ops.fe_qmc import SCRAMBLES, fe_moments_qmc
from ..ops.launch import RNGS, BoundLaunch
from ..ops.sampling import STATEFUL_RNGS
from ..params import HestonParams, SimConfig
from ..rng.streams import check_stateful_epoch, check_stateful_paths
from .base import NMCH

FE_RNGS = ("philox", "threefry", "threefry4", "device", *STATEFUL_RNGS)


class NMCH_FE(NMCH):
    """Euler-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "FORWARD-EULER"

    def __init__(self, cfg: SimConfig, params: HestonParams,
                 engine: str = "cuda", rng: str = "philox",
                 antithetic: bool = False, rot: int | None = None,
                 device="cuda", scramble: str = "auto"):
        """device: where the paths run.  "cuda" needs a card and never
        falls back to the CPU; engine="cuda" or "qmc" on device="cpu" runs
        the kernel wrapper's plain version.  rot in {1, 2, 4, 8}: coupled
        copies per path group (ops/fe.py::rotation_images); rot=2 is
        antithetic=True, and n_paths counts groups, each consuming one
        plain path's randomness.  scramble (engine="qmc"): "auto"
        (lms-shift below 2^21 paths, owen from there), "lms-shift",
        "shift" or "owen"."""
        if engine not in ("cuda", "scan", "qmc"):
            raise ValueError(f"unknown engine {engine!r} (expected 'cuda', "
                             f"'scan' or 'qmc')")
        if engine == "qmc":
            if rot not in (None, 1) or antithetic:
                raise ValueError("engine='qmc' has no rot/antithetic "
                                 "variants (the point set is already "
                                 "variance-optimal)")
            if rng != "philox":
                raise ValueError("engine='qmc' uses Sobol' points with "
                                 "Philox digital shifts; rng must stay "
                                 "'philox'")
            if scramble != "auto" and scramble not in SCRAMBLES:
                raise ValueError(f"unknown scramble {scramble!r}")
            if scramble == "auto":
                # nmch_tpu's measured crossover: the shared LMS scramble's
                # CI decay stalls beyond ~2^21 points, independent Owen
                # scrambles per replicate keep it going
                scramble = ("owen" if cfg.n_paths >= (1 << 21)
                            else "lms-shift")
        elif scramble not in ("auto", "lms-shift"):
            raise ValueError("scramble= applies to engine='qmc' only")
        else:
            scramble = "lms-shift"
        if rng == "tpu":
            raise ValueError(DEVICE_NOT_TPU)
        if rng not in FE_RNGS:
            raise ValueError(f"unknown rng {rng!r} (NMCH_FE supports "
                             f"{'/'.join(FE_RNGS)})")
        if rng == "device" and engine != "cuda":
            raise ValueError("rng='device' requires engine='cuda' (the "
                             "card's own stream; the scan engine runs the "
                             "reproducible generators)")
        if rng in STATEFUL_RNGS:
            if antithetic or rot not in (None, 1):
                raise ValueError(f"rng={rng!r} has no rot/antithetic "
                                 f"variants (parity family; use the "
                                 f"counter rngs for rotation sampling)")
            check_stateful_paths(rng, cfg.n_paths)
        rot = resolve_rot(rot, antithetic)
        super().__init__(cfg, params, device)
        self.engine = engine
        self.rng = rng
        self.rot = rot
        self.antithetic = rot >= 2
        self.scramble = scramble
        self.synthesized_moments = engine == "qmc"
        if engine == "cuda" and rng in RNGS and self.device.type == "cuda":
            self._launch = BoundLaunch()
        self._drop_state()

    def _drop_state(self) -> None:
        """Forget the carried per-path states (engine="cuda", stateful
        rng): they are reused only when seed, epoch and n_paths line up
        (``_stateful_moments``)."""
        self._state = None
        self._state_epoch = 0
        self._state_seed = None
        self._state_offset = 0

    def init(self, seed: int | None = None) -> None:
        super().init(seed)
        self._drop_state()

    def load_state(self, path: str) -> None:
        super().load_state(path)
        self._drop_state()

    def _moments(self, epoch: int):
        if self.rng in STATEFUL_RNGS:
            check_stateful_epoch(self.rng, epoch)
            if self.engine == "cuda":
                return self._stateful_moments(epoch)
            return self._stateful_scan(epoch)
        k0, k1 = self.streams.key_words
        if self.engine == "qmc":
            return fe_moments_qmc(
                self.params.as_tensor("cpu"), epoch, k0, k1, N=self.cfg.N,
                n_paths=self.cfg.n_paths, sim="cuda",
                scramble=self.scramble, device=self.device)
        if self.engine == "cuda":
            return fe_moments_cuda(
                self._kernel_params(), (k0, k1), epoch, 0,
                N=self.cfg.N, n_paths=self.cfg.n_paths, device=self.device,
                rng=self.rng, rot=self.rot, launch=self._launch)
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        pv = self.params.as_tensor(self.device)
        if self.rot > 1:
            return fe_moments_rot_scan(pv, self.cfg.N, pidx, epoch, k0, k1,
                                       rng=self.rng, rot=self.rot)
        return fe_moments_scan(pv, self.cfg.N, pidx, epoch, k0, k1,
                               rng=self.rng)

    def greeks(self, fix_strike: bool = False) -> dict:
        """Pathwise Greeks of the price: {"price": float, "S_0": dP/dS_0,
        "T": dP/dT, ...} over ops/greeks.py::PARAM_NAMES.  Consumes one
        epoch (the stream contract of compute()).  Needs a counter rng
        (philox/threefry/threefry4) and works on the plain Euler paths
        (rot 1, box hc) whatever this object's engine, rot or antithetic.
        On a card it launches kernel G1 (forward-mode tangents,
        ops/fe_greeks_cuda.py), on the CPU it runs the reverse-mode golden
        (ops/greeks.py).  fix_strike=True freezes K for the fixed-strike
        delta instead of the reference's K = S_0 coupling.  The Greeks come
        in nmch_tpu's order (by name)."""
        if self.streams is None:
            raise RuntimeError("call init(seed) before greeks()")
        if self.rng not in ("philox", "threefry", "threefry4"):
            raise ValueError("greeks() needs a counter rng "
                             "(philox/threefry/threefry4)")
        from ..ops.fe_greeks_cuda import fe_greeks_cuda
        from ..ops.greeks import PARAM_NAMES, fe_price_and_greeks
        epoch = self.streams.next_epoch()
        k0, k1 = self.streams.key_words
        pv = self.params.as_tensor("cpu")
        if self.device.type == "cuda":
            price, grads = fe_greeks_cuda(
                pv, (k0, k1), epoch, 0, N=self.cfg.N,
                n_paths=self.cfg.n_paths, device=self.device, rng=self.rng,
                fix_strike=fix_strike)
        else:
            price, g = fe_price_and_greeks(
                pv, epoch, k0, k1, N=self.cfg.N, n_paths=self.cfg.n_paths,
                rng=self.rng, fix_strike=fix_strike)
            grads = torch.stack([g[n] for n in PARAM_NAMES])
        vals = torch.cat([price.reshape(1).double(), grads.double()]).tolist()
        # nmch_tpu's key order: its Greeks come back from jit sorted by name
        return {"price": vals[0],
                **dict(sorted(zip(PARAM_NAMES, vals[1:])))}

    def _stateful_scan(self, epoch: int):
        if self.rng == "xorwow":
            from ..ops.fe_xorwow import fe_moments_xorwow as golden
        else:
            from ..ops.fe_mrg import fe_moments_mrg as golden
        pidx = path_index_grid(self.cfg.n_paths, device=self.device)
        return golden(self.params.as_tensor(self.device), self.cfg.N, pidx,
                      epoch, self.streams.seed)

    def _stateful_moments(self, epoch: int):
        """K5 with the scan engine's stream contract: epoch e's draws start
        at e * 2^40 within each path's block, so both engines price
        bitwise alike at every epoch and a (seed, epoch) checkpoint
        resumes identically on either.  The state the kernel wrote back
        (D = draws_per_compute(N) steps into epoch e-1) rides to epoch
        e's start by one jump when seed, epoch and n_paths line up;
        anything else (a fresh pricer, init, load_state, a seed change)
        rebuilds from (seed, epoch)."""
        from ..ops.fe_stateful import draws_per_compute, epoch_stride, \
            host_jump_table
        from ..ops.fe_stateful_cuda import advance_state_cuda, \
            fe_stateful_moments_cuda, fe_stateful_state_cuda
        D = draws_per_compute(self.cfg.N)
        stride = epoch_stride(self.rng)
        if D >= stride:
            # a run would draw past the next epoch's first step
            raise ValueError(f"N={self.cfg.N} draws {D} steps per path, "
                             f"not fewer than the {stride} between epochs")
        seed = self.streams.seed
        if (self._state is not None and self._state_epoch == epoch
                and self._state_seed == seed
                and self._state.shape[1] == self.cfg.n_paths):
            st = advance_state_cuda(self.rng, self._state,
                                    stride - self._state_offset)
        else:
            st = fe_stateful_state_cuda(self.rng, seed, self.cfg.n_paths,
                                        epoch, self.device)
            # the next run's boundary jump: its exact host matrix power
            # (a fraction of a second for XORWOW, cached) lands here, in
            # the run that also builds the states, not in the next one
            host_jump_table(self.rng, stride - D)
        m, m2, st_new = fe_stateful_moments_cuda(
            self.params.as_tensor("cpu"), st, N=self.cfg.N, rng=self.rng)
        self._state = st_new
        self._state_epoch = epoch + 1
        self._state_seed = seed
        self._state_offset = D
        return m, m2
