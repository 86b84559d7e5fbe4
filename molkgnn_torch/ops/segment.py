"""Segment (scatter/gather) aggregation primitives.

Port of ``molkgnn_tpu/ops/segment.py``. Indices are static-shape with
boolean masks; padded entries contribute zero. The sums go through
``index_add_``, which on CUDA uses atomics: the summation order, and so the
last bits of a sum of two or more terms, can change from run to run. A
one-term sum is exact.
"""

from __future__ import annotations

import torch


def segment_sum_nodes(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum ``values`` [N, F] into ``num_segments`` buckets by ``segment_ids``.

    Padded rows must either carry a False ``mask`` or already be zero.
    """
    if mask is not None:
        values = torch.where(mask[..., None], values, 0)
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, segment_ids, values)


def gather_scatter_add(
    values: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Message passing h'_i = sum_{(j->i) in E} values_j (sum aggregation):
    gather at edge sources, segment-sum at destinations."""
    return segment_sum_nodes(values[src], dst, num_nodes, mask=edge_mask)


def global_add_pool(
    node_values: torch.Tensor,
    node_graph_id: torch.Tensor,
    num_graphs: int,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Node -> graph segment sum (PyG ``global_add_pool``)."""
    return segment_sum_nodes(
        node_values, node_graph_id, num_graphs, mask=node_mask
    )
