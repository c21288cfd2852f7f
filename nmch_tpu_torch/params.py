"""Parameter containers for the PyTorch port.

Same fields, defaults and methods as ``nmch_tpu/params.py`` (the
reference's 12 knobs, ``include/NMCH/methods/NMCH.hpp:28-115``, with the
CLI defaults of ``src/NMCH/test/nmch.cu:52-64``).  ``as_array`` returns
numpy, so a vector packed by either package feeds the other;
``as_tensor`` places the same float32 values on a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HestonParams:
    """Heston model + option parameters.

    SDE (reference README.md:8-24):
        dS = r S dt + sqrt(v) S dZ
        dv = k (theta - v) dt + sigma sqrt(v) dW,   <dZ,dW> = rho dt
    Option: European call, strike K = S_0 (ATM), maturity T.
    """

    T: float = 1.0
    S_0: float = 1.0
    v_0: float = 0.1
    r: float = 0.0
    k: float = 0.5       # mean-reversion speed (kappa)
    rho: float = -0.7
    theta: float = 0.1   # long-term variance
    sigma: float = 0.3   # vol-of-vol

    @property
    def K(self) -> float:
        # ATM strike, fixed to S_0 as the reference ctor does (NMCH.cu:7)
        return self.S_0

    def feller_ratio(self) -> float:
        """2 k theta / sigma^2 (>1 means the variance never hits 0)."""
        return 2.0 * self.k * self.theta / (self.sigma * self.sigma)

    def replace(self, **kw: Any) -> "HestonParams":
        return dataclasses.replace(self, **kw)

    def values(self) -> tuple[float, ...]:
        """The 8 values in the kernel order (T, S_0, v_0, r, k, rho, theta,
        sigma)."""
        return (self.T, self.S_0, self.v_0, self.r, self.k, self.rho,
                self.theta, self.sigma)

    def as_array(self) -> np.ndarray:
        """f32[8] in the kernel order (T, S_0, v_0, r, k, rho, theta,
        sigma) — the layout ``nmch_tpu.HestonParams.as_array`` uses."""
        return np.array(self.values(), dtype=np.float32)

    def as_tensor(self, device) -> torch.Tensor:
        """``as_array()`` as a float32 tensor on ``device``."""
        return torch.from_numpy(self.as_array()).to(device)

    @staticmethod
    def from_array(a: np.ndarray) -> "HestonParams":
        t, s0, v0, r, k, rho, theta, sigma = (float(x) for x in a)
        return HestonParams(T=t, S_0=s0, v_0=v0, r=r, k=k, rho=rho,
                            theta=theta, sigma=sigma)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation geometry + RNG configuration.

    ``NTPB``/``NB`` follow the reference defaults (nmch.cu:52-53); the
    path count is their product (NMCH_FE.cu:317).
    """

    NTPB: int = 512
    NB: int = 512
    N: int = 1000            # number of time steps
    seed: int = 1234

    @property
    def n_paths(self) -> int:
        return self.NTPB * self.NB

    def dt(self, T: float) -> float:
        # dt = T/N, set once in the reference ctor (NMCH.cu:9)
        return T / self.N

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_n_paths(n_paths: int, N: int = 1000, seed: int = 1234,
                     NTPB: int = 512) -> "SimConfig":
        if n_paths % NTPB:
            raise ValueError(f"n_paths={n_paths} not divisible by NTPB={NTPB}")
        return SimConfig(NTPB=NTPB, NB=n_paths // NTPB, N=N, seed=seed)


DEFAULT_PARAMS = HestonParams()
DEFAULT_CONFIG = SimConfig()
