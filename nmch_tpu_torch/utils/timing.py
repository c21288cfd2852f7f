"""Wall-clock timing that waits for the device.

The reference brackets every init()/compute() with cudaEvent timers
(``NMCH_FE.cu:370-385,395-411``).  PyTorch returns before a CUDA launch
finishes, so on a CUDA device the timer synchronises on entry and on
exit: the interval covers the device work, not just its enqueue.
"""

from __future__ import annotations

import time

import torch


class Timer:
    """``with Timer(device) as t: ...`` then ``t.ms``."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False
