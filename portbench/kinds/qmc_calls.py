"""Kind ``qmc_calls``: one ``NMCH_FE`` on the traffic file's ``engine``
("qmc"), made at set-up with ``init(seed)``; a step is one ``compute()``,
which draws a fresh epoch and so a fresh randomization of the point set,
as the CLI is called one run after another with ``--engine qmc``.  A step
records what the CLI prints: the price and the half-width of its 95% CI
(``SimResult.price``, ``.ci_error``).  The two are compared apart, as the
methods "qmc_price" and "qmc_ci", each with its own limit: the price is
held close, and a CI, the spread of 8 replicate means, moves far more
with rounding.  The reference is ``portbench/reference/qmc.py``.
Parameters: ``engine``, ``warmup_steps``, ``checked_steps``, ``limits``."""

import numpy as np
import torch

from portbench.reference import qmc
from portbench.reference.rng import key_words
from portbench.workloads import Workload, pricer

METHODS = ("qmc_price", "qmc_ci")


def _methods(answers: np.ndarray) -> dict:
    """{"qmc_price": (k, 1), "qmc_ci": (k, 1)} of (k, 2) (price, CI)."""
    return {m: answers[:, j:j + 1] for j, m in enumerate(METHODS)}


class QmcCalls(Workload):
    unit = "call"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.pricer = pricer(config, traffic, "fe", self.device)
        self.pricer.init(self.seed)
        self.warm = 0

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_steps"]):
            self.pricer.compute()
            self.warm += 1

    def step(self) -> int:
        r = self.pricer.compute()
        self.steps.append([(r.price, r.ci_error)])
        return 1

    def release(self) -> None:
        self.pricer = None

    def program(self, idx):
        return _methods(np.concatenate([self.answers(i) for i in idx]))

    def reference(self, idx, dtype=torch.float32):
        key = key_words(self.seed)
        ans = [qmc.price_and_ci(self.config, key, self.warm + i,
                                self.n_paths, self.device, dtype)
               for i in idx]
        return _methods(np.array(ans, dtype=np.float64)), \
            {m: {} for m in METHODS}


make = QmcCalls
