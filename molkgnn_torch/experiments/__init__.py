"""Hyperparameter sweeps and the aggregation of their results.

Port of ``molkgnn_tpu/experiments``; the same names are exported here.
"""

from molkgnn_torch.experiments.sweep import SweepConfig, run_sweep
from molkgnn_torch.experiments.aggregate import aggregate_results

__all__ = [
    "SweepConfig",
    "run_sweep",
    "aggregate_results",
]
