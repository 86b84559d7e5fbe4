"""Where the benchmark's files are, found by the names in ``BENCHMARK.json``.

Nothing here knows a configuration, traffic mix, metric or family by name:
a cell or a metric is added by adding its files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload: str) -> dict:
    return _json("checks", workload)


def stem(name: str) -> str:
    """A metric's quantity: its name up to the first dot. Names that split
    one quantity by the cells that report it (``fit_eval_pct.kgnn``,
    ``fit_eval_pct.schnet``) share it."""
    return name.split(".")[0]


def metric(name: str) -> ModuleType:
    """The reader of a per-layer metric, ``metrics/<name>.py``, or else
    the reader of its quantity, ``metrics/<stem>.py``: a function
    ``read(ctx)`` that returns a number, or None where it found nothing to
    read."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{stem(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str) -> ModuleType:
    """The plain reference of a model family, ``reference/<family>.py``."""
    return importlib.import_module(f"bench_port.reference.{family}")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, key: str):
    """The entries of ``bench[key]`` (end_to_end or per_layer) that this
    workload reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]
