"""Kind ``sweep_batched``: a step prices the configuration's grid with one
launch per method (``explore.batched_moments``, point p at epoch p, each
followed by one copy of the moments to the host), under the key of
``pass_seed(seed, index)``, a fresh key each pass.  Parameters:
``methods``, ``engine``, ``conditional``, ``warmup_steps``,
``checked_steps``, ``limits``."""

import torch

from portbench.reference.rng import key_words
from portbench.workloads import Sweep

PASS_BITS = 20


def pass_seed(seed: int, index: int) -> int:
    """The seed of batched pass ``index`` (warm-up passes first)."""
    if not 0 <= index < 1 << PASS_BITS:
        raise ValueError(f"pass {index} out of range")
    return (int(seed) << PASS_BITS) + index


class SweepBatched(Sweep):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from nmch_tpu_torch import explore
        from nmch_tpu_torch.params import SimConfig
        self._moments = explore.batched_moments
        self.cfg = SimConfig(NTPB=config["NTPB"], NB=config["NB"],
                             N=config["N"])
        self.passes = 0

    def _pass(self) -> list:
        s = pass_seed(self.seed, self.passes)
        self.passes += 1
        out = []
        for m in self.methods:
            mo = self._moments(self.cfg, s, m, self.traffic["engine"],
                               self.config["rng"],
                               self.traffic["conditional"], self.device)
            ms, m2s = torch.stack(mo).tolist()
            out += list(zip(ms, m2s))
        return out

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_steps"]):
            self._pass()

    def step(self) -> int:
        self.steps.append(self._pass())
        return len(self.points)

    def reference(self, idx, dtype=torch.float32):
        w = self.traffic["warmup_steps"]
        eps = list(range(len(self.points)))

        def key_epochs(idx):
            return [(key_words(pass_seed(self.seed, w + i)), eps)
                    for i in idx]
        return self.sweep_reference(idx, key_epochs, dtype)


make = SweepBatched
