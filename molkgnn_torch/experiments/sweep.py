"""Hyperparameter sweep runner.

Port of ``molkgnn_tpu/experiments/sweep.py``: an itertools.product grid
over the CLI's flags, one experiment directory per combination (its
``params.log``, ``run.log`` and the run's ``logs/``), resume by skipping
combinations whose ``logs/test_result.log`` exists, and at most
``max_parallel`` runs at a time. Each run is a subprocess of the port's
CLI, ``python -m molkgnn_torch.cli.entry``, so it runs on the card unless
``base_args`` (or the grid) sets ``device`` to ``cpu``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Sequence

ENTRY = "molkgnn_torch.cli.entry"


@dataclasses.dataclass
class SweepConfig:
    base_args: Dict[str, object]  # flag -> value (no leading --)
    grid: Dict[str, Sequence]  # flag -> values to sweep
    out_dir: str = "experiments"
    max_parallel: int = 1
    resume: bool = True
    done_marker: str = "logs/test_result.log"


def grid_points(grid: Dict[str, Sequence]) -> List[Dict[str, object]]:
    keys = list(grid.keys())
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(grid[k] for k in keys))
    ]


def experiment_name(point: Dict[str, object]) -> str:
    return "_".join(f"{k}-{v}" for k, v in sorted(point.items()))


def _flag_list(args: Dict[str, object]) -> List[str]:
    out: List[str] = []
    for k, v in args.items():
        if isinstance(v, bool):
            if v:
                out.append(f"--{k}")
        else:
            out += [f"--{k}", str(v)]
    return out


def command(args: Dict[str, object]) -> List[str]:
    """The command line of one run of the port's CLI."""
    return [sys.executable, "-m", ENTRY] + _flag_list(args)


def run_sweep(cfg: SweepConfig, dry_run: bool = False) -> List[Dict]:
    """Run (or plan) the sweep; returns one record per experiment with its
    status: 'done' (skipped by resume), 'ok', 'failed', or 'planned', and
    its command (``cmd``) where it was planned or run."""
    points = grid_points(cfg.grid)
    records = []
    running: List[tuple] = []

    def reap(block: bool):
        still = []
        for proc, log, rec in running:
            if proc.poll() is None and not block:
                still.append((proc, log, rec))
                continue
            proc.wait()
            log.close()
            rec["status"] = "ok" if proc.returncode == 0 else "failed"
            rec["returncode"] = proc.returncode
        running[:] = still

    try:
        for point in points:
            name = experiment_name(point)
            exp_dir = os.path.join(cfg.out_dir, name)
            rec = {"name": name, "dir": exp_dir, "point": point}
            records.append(rec)
            marker = os.path.join(exp_dir, cfg.done_marker)
            if cfg.resume and os.path.exists(marker):
                rec["status"] = "done"
                continue
            args = dict(cfg.base_args)
            args.update(point)
            args["default_root_dir"] = exp_dir
            args.setdefault("task_name", name)
            rec["cmd"] = command(args)
            if dry_run:
                rec["status"] = "planned"
                continue
            os.makedirs(exp_dir, exist_ok=True)
            with open(os.path.join(exp_dir, "params.log"), "w") as f:
                json.dump(args, f, indent=1, default=str)
            while len(running) >= cfg.max_parallel:
                reap(block=False)
                time.sleep(0.2)
            log = open(os.path.join(exp_dir, "run.log"), "w")
            proc = subprocess.Popen(rec["cmd"], stdout=log,
                                    stderr=subprocess.STDOUT)
            rec["status"] = "running"
            running.append((proc, log, rec))
        while running:
            reap(block=True)
    finally:
        for proc, log, _ in running:  # an interrupted sweep stops its runs
            proc.kill()
            proc.wait()
            log.close()
    return records
