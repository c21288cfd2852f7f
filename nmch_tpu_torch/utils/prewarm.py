"""One-time warm-up of the CUDA kernel library.

The counterpart of ``nmch_tpu/utils/prewarm.py``.  There the first
Mosaic compile of a kernel family is the cost to absorb; here it is the
nvcc build of ``csrc/`` (``_build.py``: ~10-12 s on a cold tree, reused
from ``build/nmch_tpu_torch/<hash>/`` after that).  Run it once before
starting ranks that share a checkout, so that they find the library
built instead of each compiling the same sources:

    import nmch_tpu_torch; nmch_tpu_torch.prewarm()     # builds once
    ... every rank's first launch loads the built library ...

``block=False`` runs the warm-up on a daemon thread so that it overlaps
application setup; the first real launch waits for nothing but the
library, which ``load_library`` builds once per process.
"""

from __future__ import annotations

import threading

import torch

ENGINES = ("cuda", "qmc")


def prewarm(rng: str = "philox", block: bool = True, engine: str = "cuda",
            device="cuda"):
    """Build the kernel library and launch one tiny kernel of the family,
    then synchronise.  engine="cuda" runs K1 (``fe_moments_cuda``) with
    ``rng`` at N=4 x 256 paths; engine="qmc" the QMC path (increments and
    K6) at 8 x 1024 points x N=4.  device="cuda" needs a card and never
    falls back to the CPU; device="cpu" runs the plain versions and builds
    nothing.  Returns the Thread when block=False, else None."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected 'cuda' or "
                         f"'qmc')")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to warm the plain "
                           "versions")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")

    def _go():
        from ..params import HestonParams
        from ..rng.philox import split_seed
        if device.type == "cuda":
            from .._build import load_library
            load_library()
        pv = HestonParams().as_tensor("cpu")
        k0, k1 = split_seed(0)
        if engine == "qmc":
            from ..ops.fe_qmc import fe_moments_qmc
            m, _ = fe_moments_qmc(pv, 0, k0, k1, N=4, n_paths=8 * 1024,
                                  sim="cuda", device=device)
        else:
            from ..ops.fe_cuda import fe_moments_cuda
            m, _ = fe_moments_cuda(pv, (k0, k1), 0, 0, N=4, n_paths=256,
                                   device=device, rng=rng)
        m.item()                     # waits for the launch

    if block:
        _go()
        return None
    t = threading.Thread(target=_go, daemon=True, name=f"prewarm-{rng}")
    t.start()
    return t
