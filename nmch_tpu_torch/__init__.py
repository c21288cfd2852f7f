"""nmch_tpu_torch: the PyTorch / CUDA port of NMCH-TPU for NVIDIA Hopper.

Heston Monte Carlo pricing with the reference's 5-step lifecycle
(reference README.md:57-94), held against the JAX package ``nmch_tpu``
(bitwise Philox streams and normals, moments at rel 1e-5).  This package
imports torch, numpy and scipy, never jax.

    from nmch_tpu_torch import NMCH_FE, HestonParams, SimConfig
    m = NMCH_FE(SimConfig(), HestonParams())     # engine="cuda", device="cuda"
    m.init(seed=1234)
    m.compute()
    m.print_stats()
    m.finalize()

``NMCH_EM`` (the Broadie–Kaya exact scheme) has the same lifecycle, as
has ``NMCH_FE(..., engine="qmc")`` (randomized quasi-Monte Carlo).
The entry points are the modules ``cli`` (one pricing run) and
``explore`` (the (k, theta, sigma) sweep), each runnable with
``python -m``.
"""

from .params import HestonParams, SimConfig, DEFAULT_PARAMS, DEFAULT_CONFIG
from .results import SimResult, reference_err, correct_ci_error
from .methods.base import NMCH
from .methods.fe import NMCH_FE
from .methods.em import NMCH_EM

__version__ = "0.1.0"

__all__ = [
    "HestonParams", "SimConfig", "DEFAULT_PARAMS", "DEFAULT_CONFIG",
    "SimResult", "reference_err", "correct_ci_error",
    "NMCH", "NMCH_FE", "NMCH_EM", "__version__",
]
