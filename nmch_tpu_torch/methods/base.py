"""Abstract pricing-method lifecycle — the reference's L5 layer.

Mirrors ``NMCH<rnd_state>`` (``include/NMCH/methods/NMCH.hpp:28-115``)
and ``nmch_tpu/methods/base.py``: the 5-step user API

    m = NMCH_FE(cfg, params)   # declare
    m.init(seed)               # seed the RNG streams
    m.compute()                # one Monte Carlo pricing run
    m.print_stats()            # human-readable stats block
    m.finalize()               # release resources

plus the parameter setters (``set_k/set_theta/set_sigma``, NMCH.hpp:76-80)
that continue the RNG streams across compute() calls
(exploration.cu:14-17).  ``save_state``/``load_state`` read and write the
JSON of ``nmch_tpu``'s checkpoints, and ``print_stats`` prints the same
bytes.
"""

from __future__ import annotations

import abc
import dataclasses
import json

import torch

from ..ops.launch import check_device
from ..oracle.black_scholes import reference_true_price
from ..params import HestonParams, SimConfig
from ..results import SimResult
from ..rng.streams import PathStreams
from ..utils.timing import Timer, span


def resolve_device(device) -> torch.device:
    """The torch device of a pricer: "cuda" needs a card and never falls
    back to the CPU."""
    device = check_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                           "is False; pass device='cpu' to price on "
                           "the CPU")
    return device


def host_values(moments) -> list[float]:
    """What ``NMCH._moments`` returned, on the host in one copy: [E[X],
    E[X^2]], then its counts if it returned them.  A vector is copied as
    it is; a pair of 0-dim tensors is stacked first, which queues one more
    operation on the device.  A pricer's bound launch brings its ``out``
    by ``BoundLaunch.fetch`` instead (``NMCH.compute``)."""
    if not torch.is_tensor(moments):
        moments = torch.stack(list(moments))
    return moments.tolist()


class NMCH(abc.ABC):
    """Base lifecycle + parameter container (reference NMCH.hpp:28-115)."""

    method_name = "?"
    # True where (E[X], E[X^2]) are synthesized to encode a replicate CI
    # (the QMC engine) rather than accumulated over the paths
    synthesized_moments = False
    # the names of the counts that ``_moments`` may return beside the
    # moments (NaN: not counted)
    count_names: tuple[str, ...] = ()

    def __init__(self, cfg: SimConfig, params: HestonParams, device):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.streams: PathStreams | None = None
        self.result: SimResult | None = None
        self.init_time_ms = float("nan")
        # the kernel launch a subclass binds on a card (ops/launch.py::
        # BoundLaunch), or None where its engine, rng or device takes none
        self._launch = None
        self._pv = torch.empty(8, dtype=torch.float32)
        self._pv_np = self._pv.numpy()

    @property
    def K(self) -> float:
        """ATM strike, always the current params' S_0 (NMCH.cu:7)."""
        return self.params.K

    # -- lifecycle -------------------------------------------------------
    def init(self, seed: int | None = None) -> None:
        """Create the per-path streams (reference init(seed),
        NMCH_FE.cu:368-386).  Counter-based RNG needs no state arrays, so
        this is O(1); the kernels' one-off build lands in the first
        compute() instead, which the CLI discards as a warm-up."""
        seed = self.cfg.seed if seed is None else seed
        with Timer() as t:
            self.streams = PathStreams(seed=seed, n_paths=self.cfg.n_paths)
        self.init_time_ms = t.ms

    def _kernel_params(self) -> torch.Tensor:
        """``params.as_tensor("cpu")`` as the kernel wrappers take it,
        written in each call into the pricer's own float32 (8,) buffer
        (the same rounding to float32): valid until the next call."""
        self._pv_np[:] = self.params.values()
        return self._pv

    @abc.abstractmethod
    def _moments(self, epoch: int):
        """(E[X], E[X^2]) of one pricing run at ``epoch``, as 0-dim
        tensors on ``self.device``; or one float64 vector on it, (E[X],
        E[X^2]), then the counts that ``count_names`` names, if any."""

    def compute(self) -> SimResult:
        """One Monte Carlo pricing run; each call draws a fresh epoch.

        On a card, a pricer whose engine and rng take a bound launch
        (``ops/launch.py::BoundLaunch``: ``NMCH_FE`` with engine "cuda"
        and a counter rng, ``NMCH_EM`` with engine "cuda") binds it in its
        first call and again where the static arguments changed (a new
        seed, cfg, device or variant; a setter of the Heston parameters
        does not).  The launch keeps the validated static arguments, the
        library's entry point, the device's index, the ``partials`` and
        ``out`` buffers, and a pinned host buffer from its first fetch.
        Each call then does its own work only: the epoch, the parameters
        as the kernel's arguments (EM's loop constants), the current
        stream, one foreign call, one copy of ``out`` into the pinned
        buffer, one wait on the stream, the floats.  Any other return of
        ``_moments`` is brought to the host by ``host_values``.
        ``exec_time_ms`` spans the call from a device synchronisation to
        the wait for its result.

        Spans (``utils/timing.py::span``): ``compute`` the whole call,
        ``prepare`` the host's work until the kernel is queued.  The
        ``compute`` record carries the counts of ``_moments``."""
        with span("compute") as record:
            if self.streams is None:
                raise RuntimeError("call init(seed) before compute()")
            epoch = self.streams.next_epoch()
            launch = self._launch
            with Timer(self.device) as t:
                with span("prepare"):
                    moments = self._moments(epoch)
                if launch is not None and moments is launch.out:
                    values = launch.fetch()
                    t.waited = True
                else:
                    values = host_values(moments)
            m, m2, *counts = values
            if record is not None:
                found = {name: int(v) for name, v in
                         zip(self.count_names, counts) if v == v}
                if found:
                    record.counts = found
            self.result = SimResult(
                price=m, price_squared=m2, n_paths=self.cfg.n_paths,
                exec_time_ms=t.ms, init_time_ms=self.init_time_ms,
                synthesized_moments=self.synthesized_moments)
            return self.result

    def finalize(self) -> None:
        """Release resources (the reference frees sum/states), the bound
        launch's buffers included."""
        self.streams = None
        if self._launch is not None:
            self._launch.release()

    # -- parameter setters (exploration sweep) ----------------------------
    def set_k(self, k: float) -> None:
        self.params = self.params.replace(k=k)

    def set_theta(self, theta: float) -> None:
        self.params = self.params.replace(theta=theta)

    def set_sigma(self, sigma: float) -> None:
        self.params = self.params.replace(sigma=sigma)

    # -- results accessors (reference getter names) ------------------------
    def get_strike_price(self) -> float:
        return self.result.price

    def get_price_squared(self) -> float:
        return self.result.price_squared

    def get_execution_time(self) -> float:
        return self.result.exec_time_ms

    def get_init_time(self) -> float:
        return self.init_time_ms

    def get_err(self) -> float:
        """Reference CI formula, verbatim (NMCH_FE.hpp:50-55)."""
        return self.result.err

    # -- checkpoint / resume ------------------------------------------------
    def save_state(self, path: str) -> None:
        """Persist the resumable state (RNG streams + params) as JSON."""
        if self.streams is None:
            raise RuntimeError("nothing to save: call init(seed) first")
        with open(path, "w") as f:
            json.dump({
                "streams": self.streams.state_dict(),
                "params": dataclasses.asdict(self.params),
                "cfg": dataclasses.asdict(self.cfg),
            }, f)

    def load_state(self, path: str) -> None:
        """Resume streams where a saved run (of either package) left off:
        the next compute() draws what the saved pricer would have."""
        with open(path) as f:
            d = json.load(f)
        self.streams = PathStreams.from_state_dict(d["streams"])
        self.params = HestonParams(**d["params"])
        self.cfg = SimConfig(**d["cfg"])
        if self.streams.n_paths != self.cfg.n_paths:
            raise ValueError("inconsistent checkpoint: n_paths mismatch")

    # -- output -----------------------------------------------------------
    def print_stats(self) -> None:
        """Stats block in the reference's exact format: base-parameter
        dump (NMCH.cu:13-28 — it prints "S_0,K" and dt but not rho)
        followed by the method part (NMCH_FE.cu:333-350); the QMC
        engine's synthesized moments print the RQMC CI instead of err."""
        p, cfg = self.params, self.cfg
        print("Base parameters:")
        print(f"NTPB    = {cfg.NTPB}")
        print(f"NB      = {cfg.NB}")
        print(f"T       = {p.T:f}")
        print(f"S_0,K   = {p.S_0:f}")
        print(f"v_0     = {p.v_0:f}")
        print(f"r       = {p.r:f}")
        print(f"k       = {p.k:f}")
        print(f"theta   = {p.theta:f}")
        print(f"sigma   = {p.sigma:f}")
        print(f"N       = {cfg.N}")
        print(f"dt      = {cfg.dt(p.T):f}")
        print(f"METHOD: {self.method_name}")
        r = self.result
        print(f"The estimated price E[X] is equal to {r.price:f}")
        print(f"The estimated E[X^2] is equal to {r.price_squared:f}")
        # parity line: the reference's BS-with-vol-of-vol "true price"
        print(f"The true price {reference_true_price(p.S_0, self.K, p.r, p.sigma):f}")
        if r.synthesized_moments:
            # the reference err formula has no meaning for synthesized
            # (QMC replicate-CI) moments; the honest number follows
            print("error associated to a confidence interval of 95% = "
                  f"n/a (RQMC replicate CI: {r.ci_error:e})")
        else:
            print("error associated to a confidence interval of 95% = "
                  f"{r.err:f}")
        print(f"Execution time {r.exec_time_ms:f} ms")
        print(f"Initialization time {self.init_time_ms:f} ms")
