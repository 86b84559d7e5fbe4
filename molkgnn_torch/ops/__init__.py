"""Tensor operations of the models: permutation tables, cosine similarity,
segment sums and the masked BatchNorm.

Port of ``molkgnn_tpu/ops``; the same names are exported here. The
support-score scorer (``ops/support_score.py``, the port of
``pallas_kernels.py``) and the CUDA build (``ops/_build.py``) are imported
by their own module names; importing this package builds nothing.
"""

from molkgnn_torch.ops.permutations import PERMS, num_perms, perm_table
from molkgnn_torch.ops.similarity import (
    cosine_matrix,
    normalize_rows,
    neighborhood_similarity,
)
from molkgnn_torch.ops.segment import (
    segment_sum_nodes,
    gather_scatter_add,
    global_add_pool,
)
from molkgnn_torch.ops.norm import MaskedBatchNorm

__all__ = [
    "PERMS",
    "num_perms",
    "perm_table",
    "cosine_matrix",
    "normalize_rows",
    "neighborhood_similarity",
    "segment_sum_nodes",
    "gather_scatter_add",
    "global_add_pool",
    "MaskedBatchNorm",
]
