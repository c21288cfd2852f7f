"""What a cell's window drives, found by name.

A traffic file (``traffic/<mix>.json``) is data: its ``kind`` names the
generator that reads it, ``kinds/<kind>.py``, and the rest of it are that
generator's parameters.  The configuration (``configs/<name>.json``) gives
the sizes, the model parameters, the generator family and the Poisson cut.
A new mix of a known kind is a data file; a new kind is a file of its own
beside the others.  Nothing here names a kind, a method or a kernel.

A kind's ``make(config, traffic, seed, device)`` returns a ``Workload``:

* ``unit``: what the end-to-end rate counts ("call" or "point");
* ``warm_up()``: the cell's own shapes, before the window;
* ``step()``: one unit of work of the window, which records its answers,
  (E[X], E[X^2]) per priced point, in ``steps`` and returns how many
  units it did;
* ``program(indices)`` and ``reference(indices, dtype)``: the answers of
  the chosen steps, ``{method: (M, 2)}``, as the program gave them and as
  ``portbench.reference`` works them out again from the seed and the
  inputs alone; ``reference`` also returns, per method, the reference's
  counts of the data-dependent work (``{method: {count: n}}``);
* ``release()``: drops the program's state before the reference runs.

The reference of a method is ``portbench/reference/<method>.py``'s
``payoffs``; the pricer of a method is ``nmch_tpu_torch.methods.<method>``'s
``NMCH_<METHOD>``.
"""

from __future__ import annotations

import importlib
import inspect

import numpy as np
import torch

from . import spec
from .reference.fe import moments, param_rows
from .reference.grid import grid_points

def make(config: dict, traffic: dict, seed: int, device, base=spec.HERE):
    """The workload of ``kinds/<traffic["kind"]>.py`` under ``base``."""
    return spec.load("kinds", traffic["kind"], base).make(
        config, traffic, seed, device)


class Workload:
    """The parts that every kind shares."""

    unit = "call"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.n_paths = config["NTPB"] * config["NB"]
        self.N = config["N"]
        self.points: list = []       # grid points a step prices, if any
        self.steps: list = []        # per step: its answers, (M, 2) floats

    def release(self) -> None:
        """Drop the program's state before the reference runs."""

    def answers(self, step: int) -> np.ndarray:
        return np.asarray(self.steps[step], dtype=np.float64)

    def reference_answers(self, method: str, rows, key, epochs, dtype):
        """(answers (P, 2), counts) of P points of ``method``."""
        ref = importlib.import_module(f"portbench.reference.{method}")
        pay, counts = ref.payoffs(self.config, rows, key, epochs,
                                  self.n_paths, self.device, dtype)
        m, m2 = moments(pay)
        return torch.stack([m, m2], 1).cpu().numpy(), counts


def pricer(config: dict, traffic: dict, method: str, device):
    """``NMCH_<METHOD>`` of the configuration's sizes and parameters.  It
    takes each keyword argument of its constructor that the configuration
    or the traffic file names (the traffic file's value where both do):
    ``rng`` and ``poisson_cut`` from the configuration, ``engine`` from the
    traffic file."""
    from nmch_tpu_torch.params import HestonParams, SimConfig
    mod = importlib.import_module(f"nmch_tpu_torch.methods.{method}")
    cls = getattr(mod, f"NMCH_{method.upper()}")
    cfg = SimConfig(NTPB=config["NTPB"], NB=config["NB"], N=config["N"])
    names = set(inspect.signature(cls).parameters) - {"cfg", "params",
                                                      "device"}
    opts = {k: v for src in (config, traffic) for k, v in src.items()
            if k in names}
    return cls(cfg, HestonParams(**config["params"]), device=device, **opts)


class Sweep(Workload):
    """A step prices every point of the configuration's grid with each of
    the traffic file's ``methods``; its answers are method by method."""

    unit = "point"

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.methods = traffic["methods"]
        self.points = grid_points(config["grid"])
        base = config["params"]
        self.rows = param_rows(
            [dict(base, k=k, theta=th, sigma=s) for k, th, s in self.points])

    def program(self, idx: list[int]):
        P = len(self.points)
        return {m: np.concatenate([self.answers(i)[j * P:(j + 1) * P]
                                   for i in idx])
                for j, m in enumerate(self.methods)}

    def sweep_reference(self, idx, key_epochs, dtype):
        """The reference of steps ``idx``, where ``key_epochs(idx)`` gives
        each step's (key, epoch of each point)."""
        out, counts = {}, {}
        for m in self.methods:
            parts = [self.reference_answers(m, self.rows, key, ep, dtype)
                     for key, ep in key_epochs(idx)]
            out[m] = np.concatenate([a for a, _ in parts])
            counts[m] = {n: sum(c.get(n, 0) for _, c in parts)
                         for n in parts[0][1]}
        return out, counts
