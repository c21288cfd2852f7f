"""Kind ``pricer_calls``: one pricer of the traffic file's ``method``, made
at set-up with ``init(seed)``; a step is one ``compute()``, which draws a
fresh epoch of every path's stream, as the CLI is called one run after
another.  Parameters: ``method``, ``engine``, ``warmup_steps``,
``checked_steps``, ``limits``."""

import numpy as np
import torch

from portbench.reference.rng import key_words
from portbench.workloads import Workload, param_rows, pricer


class PricerCalls(Workload):
    unit = "call"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.method = traffic["method"]
        self.pricer = pricer(config, traffic, self.method, self.device)
        self.pricer.init(self.seed)
        self.warm = 0

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_steps"]):
            self.pricer.compute()
            self.warm += 1

    def step(self) -> int:
        r = self.pricer.compute()
        self.steps.append([(r.price, r.price_squared)])
        return 1

    def release(self) -> None:
        self.pricer = None

    def program(self, idx):
        return {self.method: np.concatenate([self.answers(i) for i in idx])}

    def reference(self, idx, dtype=torch.float32):
        rows = param_rows([self.config["params"]] * len(idx))
        epochs = [self.warm + i for i in idx]
        ans, counts = self.reference_answers(
            self.method, rows, key_words(self.seed), epochs,
            dtype)
        return {self.method: ans}, {self.method: counts}


make = PricerCalls
