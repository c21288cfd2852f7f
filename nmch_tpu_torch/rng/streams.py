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
    # (seed, its key words): key_words splits the seed again only when the
    # seed changed
    _words: tuple = dataclasses.field(default=(None, None), init=False,
                                      repr=False, compare=False)

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
        """``split_seed(seed)``: the (k0, k1) u32 key words."""
        seed, words = self._words
        if seed is None or seed != self.seed:
            words = split_seed(self.seed)
            self._words = (self.seed, words)
        return words

    def state_dict(self) -> dict:
        return {"seed": self.seed, "n_paths": self.n_paths,
                "epoch": self.epoch}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PathStreams":
        return cls(seed=int(d["seed"]), n_paths=int(d["n_paths"]),
                   epoch=int(d["epoch"]))


def stateful_max_epoch(rng: str) -> int:
    """Epochs per path block of a stateful family's stream layout
    (2^(PATH_LOG2 - EPOCH_LOG2), 2^27 for both): the method layer's
    bound, from the family's own constants."""
    if rng == "mrg32k3a":
        from .mrg32k3a import MAX_EPOCH
    elif rng == "xorwow":
        from .xorwow import MAX_EPOCH
    else:
        raise ValueError(f"{rng!r} is not a stateful family")
    return MAX_EPOCH


def check_stateful_paths(rng: str, n_paths: int) -> None:
    """Raise unless n_paths fits the stateful stream layout: the jump
    tables cover path-index bits 0..30, larger indices would alias onto
    lower streams."""
    if n_paths >= (1 << 31):
        raise ValueError(f"rng={rng!r} supports n_paths < 2^31 (stream "
                         f"layout, rng/{rng}.py docstring); got {n_paths}")


def check_stateful_epoch(rng: str, epoch: int) -> None:
    """Raise unless ``epoch`` lies inside ``rng``'s stream layout."""
    bound = stateful_max_epoch(rng)
    if int(epoch) >= bound:
        raise ValueError(f"epoch={int(epoch)} exceeds the {rng} stream "
                         f"layout's {bound} epochs per path block "
                         f"(rng/{rng}.py docstring)")
