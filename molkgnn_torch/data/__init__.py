"""Datasets: synthetic molecules, QSAR and D4DCHP ingest, prefetching.

Port of ``molkgnn_tpu/data``; the same names are exported here.
"""

from molkgnn_torch.data.synthetic import random_molgraph, random_dataset

__all__ = [
    "random_molgraph",
    "random_dataset",
]
