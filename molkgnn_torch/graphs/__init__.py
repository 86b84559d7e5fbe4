"""Graphs and batches: molecules, receptive fields, fixed-shape batches.

Port of ``molkgnn_tpu/graphs``; the same names are exported here.
"""

from molkgnn_torch.graphs.molgraph import MolGraph, receptive_fields
from molkgnn_torch.graphs.batch import (
    GraphBatch,
    DegreeBucket,
    BatchSpec,
    batch_graphs,
    spec_for_graphs,
)
from molkgnn_torch.graphs.balance import spec_for_dataset, spec_for_sampler

__all__ = [
    "MolGraph",
    "receptive_fields",
    "GraphBatch",
    "DegreeBucket",
    "BatchSpec",
    "batch_graphs",
    "spec_for_graphs",
    "spec_for_sampler",
    "spec_for_dataset",
]
