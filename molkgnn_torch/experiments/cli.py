"""Sweep CLI of the port: run a declarative hyperparameter grid.

Port of ``molkgnn_tpu/experiments/cli.py``. Usage:

  molkgnn-torch-sweep --config sweep.json [--dry-run]

Config format (JSON), the JAX package's:
  {"base_args": {"dataset_name": "1798", "gnn_type": "kgnn", ...},
   "grid": {"peak_lr": [5e-3, 5e-4], "num_layers": [3, 4]},
   "out_dir": "experiments", "max_parallel": 1, "resume": true}

Each run is ``python -m molkgnn_torch.cli.entry`` with those flags, on the
card; ``"device": "cpu"`` in ``base_args`` runs them on the CPU. Prints one
JSON record per experiment; exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="molkgnn_torch sweep runner")
    p.add_argument("--config", required=True)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    from molkgnn_torch.experiments.sweep import SweepConfig, run_sweep

    with open(args.config) as f:
        raw = json.load(f)
    cfg = SweepConfig(
        base_args=raw["base_args"],
        grid=raw["grid"],
        out_dir=raw.get("out_dir", "experiments"),
        max_parallel=int(raw.get("max_parallel", 1)),
        resume=bool(raw.get("resume", True)),
    )
    records = run_sweep(cfg, dry_run=args.dry_run)
    for rec in records:
        print(json.dumps(rec, default=str))
    failed = [r for r in records if r.get("status") == "failed"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
