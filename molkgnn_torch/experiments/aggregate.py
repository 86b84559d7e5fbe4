"""Result aggregation: experiment directories -> per-metric tables.

Copied from ``molkgnn_tpu/experiments/aggregate.py``: walk the experiment
directories, parse each ``logs/test_result.log`` (a section per checkpoint
tag, ``metric: value`` lines, as ``Trainer.test`` writes it), and emit one
table per metric with experiments as rows and checkpoint tags as columns.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


def parse_test_result(path: str) -> Dict[str, Dict[str, float]]:
    """Parse a test_result.log written by Trainer.test."""
    out: Dict[str, Dict[str, float]] = {}
    tag = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                tag = line[1:-1]
                out[tag] = {}
            elif tag is not None and ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[tag][k.strip()] = float(v)
                except ValueError:
                    pass
    return out


def collect(exp_root: str) -> Dict[str, Dict[str, Dict[str, float]]]:
    """experiment name -> tag -> metric -> value."""
    results = {}
    for name in sorted(os.listdir(exp_root)):
        path = os.path.join(exp_root, name, "logs", "test_result.log")
        if os.path.exists(path):
            results[name] = parse_test_result(path)
    return results


def aggregate_results(
    exp_root: str,
    out_dir: Optional[str] = None,
    metrics: Optional[List[str]] = None,
) -> Dict[str, List[List[str]]]:
    """Build one table per metric: rows = experiments, cols = ckpt tags.
    Writes ``all_test_result_df_{metric}.csv`` files when ``out_dir`` is
    given."""
    results = collect(exp_root)
    all_tags = sorted({t for r in results.values() for t in r})
    if metrics is None:
        metrics = sorted(
            {m for r in results.values() for t in r.values() for m in t}
        )
    tables: Dict[str, List[List[str]]] = {}
    for metric in metrics:
        rows = [["experiment"] + all_tags]
        for name, per_tag in results.items():
            row = [name]
            for tag in all_tags:
                v = per_tag.get(tag, {}).get(metric)
                row.append("" if v is None else f"{v:.6f}")
            rows.append(row)
        tables[metric] = rows
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(
                os.path.join(out_dir, f"all_test_result_df_{metric}.csv"),
                "w",
                newline="",
            ) as f:
                csv.writer(f).writerows(rows)
    return tables
