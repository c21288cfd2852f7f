"""The benchmark measures the PyTorch port alone: no JAX in the process.

Modules are compared by their top-level name, the part before the first
dot, as a whole: ``nmch_tpu_torch`` is the port, ``nmch_tpu`` the JAX
package it was ported from.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nmch_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
