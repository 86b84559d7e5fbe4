"""Parallel dataset preprocessing: build the processed caches of many AIDs.

Reference contract: dataset_multigenerator.py (C17) — a process pool
building the processed cache of every AID in parallel (the reference shells
out ``python wrapper.py --dataset {AID}`` per AID). Here the worker is the
ingest function itself; caches land in each dataset's ``processed/`` dir and
subsequent ``load_qsar_dataset`` calls hit them.

Copy of ``molkgnn_tpu/data/preprocess.py`` over the port's
``data/qsar.py``; the caches it writes are the JAX package's files. Run as
``python -m molkgnn_torch.data.preprocess --root DIR``.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Dict, List, Optional, Sequence

from molkgnn_torch.data.dataset import QSAR_DATASET_NAMES


def _build_one(args) -> Dict:
    root, dataset, gnn_type, backend = args
    t0 = time.time()
    try:
        from molkgnn_torch.data.qsar import load_qsar_dataset

        ds = load_qsar_dataset(
            root, dataset=dataset, gnn_type=gnn_type, backend=backend
        )
        return {
            "dataset": dataset,
            "status": "ok",
            "num_graphs": len(ds.graphs),
            "seconds": time.time() - t0,
        }
    except Exception as e:  # report, don't kill the pool
        return {
            "dataset": dataset,
            "status": "failed",
            "error": repr(e),
            "seconds": time.time() - t0,
        }


def preprocess_all(
    root: str,
    datasets: Optional[Sequence[str]] = None,
    gnn_type: str = "kgnn",
    backend: str = "native",
    processes: int = 9,
) -> List[Dict]:
    """Build processed caches for ``datasets`` (default: all nine AIDs +
    the smoke set) with ``processes`` workers (the reference uses Pool(9),
    dataset_multigenerator.py:59-76)."""
    datasets = list(datasets or QSAR_DATASET_NAMES)
    jobs = [(root, d, gnn_type, backend) for d in datasets]
    if processes <= 1 or len(jobs) == 1:
        return [_build_one(j) for j in jobs]
    with mp.get_context("spawn").Pool(min(processes, len(jobs))) as pool:
        return pool.map(_build_one, jobs)


def main():  # pragma: no cover - thin CLI
    import argparse
    import json

    p = argparse.ArgumentParser(description="build processed dataset caches")
    p.add_argument("--root", required=True)
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--gnn_type", default="kgnn")
    p.add_argument("--backend", default="native")
    p.add_argument("--processes", type=int, default=9)
    args = p.parse_args()
    for rec in preprocess_all(
        args.root, args.datasets, args.gnn_type, args.backend, args.processes
    ):
        print(json.dumps(rec))


if __name__ == "__main__":  # pragma: no cover
    main()
