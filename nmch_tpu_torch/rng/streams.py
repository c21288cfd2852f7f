"""Persistent per-path RNG streams (the reference's curand-state contract).

A stream is (seed, path_idx, epoch) and the epoch is bumped after every
simulation call, so repeated ``compute()`` calls draw fresh,
non-overlapping randomness (``NMCH_FE.cu:81,303``,
``exploration.cu:14-17``).  The state is two integers, and its JSON
form is the one ``nmch_tpu/rng/streams.py`` writes, so a checkpoint
moves between the two packages.
"""

from __future__ import annotations

import dataclasses

from .philox import split_seed


@dataclasses.dataclass
class PathStreams:
    """Tracks the epoch so successive compute() calls continue the streams."""

    seed: int
    n_paths: int
    epoch: int = 0

    def init(self, seed: int) -> None:
        """Reference ``init(seed)``: restart all streams from scratch."""
        self.seed = int(seed)
        self.epoch = 0

    def next_epoch(self) -> int:
        """Claim an epoch for one simulation call and advance."""
        e = self.epoch
        self.epoch += 1
        return e

    @property
    def key_words(self):
        return split_seed(self.seed)

    def state_dict(self) -> dict:
        return {"seed": self.seed, "n_paths": self.n_paths,
                "epoch": self.epoch}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PathStreams":
        return cls(seed=int(d["seed"]), n_paths=int(d["n_paths"]),
                   epoch=int(d["epoch"]))
