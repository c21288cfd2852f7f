"""What ``BENCHMARK.json`` names, found by name under the benchmark's
folder: ``configs/<config>.json``, ``traffic/<traffic>.json``, the
generator ``kinds/<kind>.py`` that a traffic file names, and each
metric's reader ``metrics/<name>.py``.  Adding a cell, a mix, a kind or a
metric is adding files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(folder: str, name: str, base=HERE) -> dict:
    with open(pathlib.Path(base) / folder / f"{name}.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str, base=HERE) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration, its traffic mix)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(cells)})")
    w = cells[workload]
    return w, _json("configs", w["config"], base), \
        _json("traffic", w["traffic"], base)


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The end-to-end metrics (trace off) or the per-layer metrics (trace
    on) that the cell reports: those whose ``workloads`` list it, and the
    end-to-end metrics without a list (``setup_s``).  A per-layer metric
    has to list its cells."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if workload in m.get("workloads", (workload,))]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def load(folder: str, name: str, base=HERE):
    """The module ``<folder>/<name>.py`` under ``base``, loaded from its
    file (a name may hold dots)."""
    path = pathlib.Path(base) / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base=HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return load("metrics", name, base).read
