"""Kind ``sweep_loop``: the reference's loop mode.  One pricer a method,
made at set-up with ``init(seed)``; a step walks the configuration's grid
with ``set_theta``, ``set_sigma``, ``set_k`` and ``compute()`` for each
method in turn, the streams continued across points and steps.
Parameters: ``methods``, ``engine``, ``warmup_steps``, ``checked_steps``,
``limits``."""

import torch

from portbench.reference.rng import key_words
from portbench.workloads import Sweep, pricer


class SweepLoop(Sweep):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.pricers = {m: pricer(config, traffic, m, self.device)
                        for m in self.methods}
        for p in self.pricers.values():
            p.init(self.seed)
        self.warm = 0

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_steps"]):
            for p in self.pricers.values():
                p.compute()
            self.warm += 1

    def step(self) -> int:
        out = []
        for m in self.methods:
            p = self.pricers[m]
            for k, theta, sigma in self.points:
                p.set_theta(theta)
                p.set_sigma(sigma)
                p.set_k(k)
                r = p.compute()
                out.append((r.price, r.price_squared))
        self.steps.append(out)
        return len(self.points)

    def release(self) -> None:
        self.pricers = None

    def reference(self, idx, dtype=torch.float32):
        P = len(self.points)

        def key_epochs(idx):
            return [(key_words(self.seed),
                     [self.warm + i * P + p for p in range(P)])
                    for i in idx]
        return self.sweep_reference(idx, key_epochs, dtype)


make = SweepLoop
