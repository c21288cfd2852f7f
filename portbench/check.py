"""The comparison that decides ``correct``.

For each method, the number compared is the widest relative gap between
an answer the program gave in the window and the reference's: the
largest |program - reference| / |reference| over the checked answers and
both moments, E[X] and E[X^2] (0 where the two are equal, also at 0).  Each number has its limit in the cell's
traffic file (``limits``); a number that is missing, not finite or over
its limit makes the run not correct.  Every answer of the window, checked
or not, has to be finite and non-negative; those that are not count as
failed.
"""

from __future__ import annotations

import numpy as np


def gaps(program: dict, reference: dict) -> dict:
    """{"<method>.rel_gap": widest relative gap} over the methods."""
    out = {}
    for method, ref in reference.items():
        got = np.asarray(program[method], dtype=np.float64)
        ref = np.asarray(ref, dtype=np.float64)
        if got.shape != ref.shape:
            raise ValueError(f"{method}: {got.shape} answers against "
                             f"{ref.shape} in the reference")
        diff = np.abs(got - ref)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(diff == 0.0, 0.0, diff / np.abs(ref))
        out[f"{method}.rel_gap"] = float(np.max(rel)) if np.all(
            np.isfinite(rel)) else float("nan")
    return out


def failed_answers(answers) -> int:
    a = np.asarray(answers, dtype=np.float64)
    return int(np.sum(~(np.isfinite(a) & (a >= 0.0)).all(axis=-1)))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}) over every limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and bool(np.isfinite(v)) and v <= limit
    return ok, checks
