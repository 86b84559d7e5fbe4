"""Segment (scatter/gather) aggregation primitives.

Port of ``molkgnn_tpu/ops/segment.py``. Indices are static-shape with
boolean masks; padded entries contribute zero. The sums go through
``index_add_``, which on CUDA uses atomics: the summation order, and so the
last bits of a sum of two or more terms, can change from run to run. A
one-term sum is exact.

Gathers go through ``take_rows`` (``index_select``), whose gradient is an
``index_add_``. Advanced indexing (``t[idx]``) computes the same values,
but its gradient on CUDA sorts the indices first (``index_put_`` with
accumulate): with every node gathered many times that backward took 250 of
285 ms of device time in a flagship train step at batch 1024 on an NVIDIA
H100 80GB HBM3 at 700 W (``chip_smoke.py``, phase 5; PERF.md).
"""

from __future__ import annotations

import torch


def take_rows(t: torch.Tensor, idx: torch.Tensor, dim: int = 0):
    """``t`` gathered along ``dim`` at ``idx`` of any shape:
    ``t.shape[:dim] + idx.shape + t.shape[dim + 1:]``."""
    out = t.index_select(dim, idx.reshape(-1))
    return out.reshape(t.shape[:dim] + idx.shape + t.shape[dim + 1:])


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
    return segment_sum_nodes(
        take_rows(values, src), dst, num_nodes, mask=edge_mask
    )


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


def segment_min(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Least of ``values`` [N] per segment (``jax.ops.segment_min``); a
    segment with no entry holds ``inf``. Padded entries should carry
    ``inf``. A minimum is exact, so the result does not depend on the
    order in which entries arrive."""
    out = values.new_full((num_segments,), float("inf"))
    return out.scatter_reduce(0, segment_ids.long(), values, "amin",
                              include_self=False)


def segment_max(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Greatest of ``values`` [N, ...] per segment along dim 0
    (``jax.ops.segment_max``); a segment with no entry holds ``-inf``.
    Padded entries should carry ``-inf``. A maximum is exact, so the
    result does not depend on the order in which entries arrive."""
    out = values.new_full((num_segments,) + values.shape[1:],
                          float("-inf"))
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=False)
