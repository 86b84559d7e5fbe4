"""Edge-partitioned model parallelism: the deprecated, eval-only baseline.

Port of ``molkgnn_tpu/parallel/edge_partition.py``. The work rows (degree-
bucket rows and edges) are cut into equal shards, one a rank, while the
node features are replicated; each layer's partial node-order scores and
aggregated features are summed over the ranks by the model's
``psum_group`` hook (``models/kgnn.py``). Both sums move ``[N, sum(L)]``
activations, so the bytes scale with the whole graph, where the halo
partition (``parallel/halo.py``) moves cut-sized exchanges and trains. This
module stays as the baseline the halo design is measured against: it is
eval-only, not exported from ``molkgnn_torch.parallel``, and importing it
warns, as the JAX package's does.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch

warnings.warn(
    "molkgnn_torch.parallel.edge_partition is deprecated: the halo-exchange"
    " partition (molkgnn_torch.parallel.halo) supersedes it; it trains, is"
    " a Trainer/CLI path, and has strictly better communication scaling."
    " This module remains as an eval-only baseline.",
    DeprecationWarning,
    stacklevel=2,
)


def _shard_rows(arrays, mask, n_shards):
    """Split rows (axis 0) into ``n_shards`` equal chunks, zero-padded."""
    outs = []
    cap = mask.shape[0]
    per = -(-cap // n_shards)
    padded_cap = per * n_shards
    for a in arrays:
        if a.shape[0] != cap:
            raise ValueError("row count mismatch")
        pad = np.zeros((padded_cap - cap,) + a.shape[1:], a.dtype)
        outs.append(
            np.concatenate([a, pad]).reshape((n_shards, per) + a.shape[1:])
        )
    mpad = np.zeros((padded_cap - cap,), bool)
    outs.append(np.concatenate([mask, mpad]).reshape(n_shards, per))
    return outs


def partition_batch(batch: GraphBatch, n_shards: int) -> GraphBatch:
    """Edge and degree-bucket rows reshaped to ``[n_shards, rows/shard,
    ...]``; node and graph arrays replicated on the shard axis (numpy, the
    JAX package's arrays bit for bit)."""
    def rep(a):
        a = np.asarray(a)
        return np.broadcast_to(a[None], (n_shards,) + a.shape).copy()

    esrc, edst, eattr, emask = _shard_rows(
        [np.asarray(batch.edge_src), np.asarray(batch.edge_dst),
         np.asarray(batch.edge_attr)],
        np.asarray(batch.edge_mask),
        n_shards,
    )
    buckets = []
    for b in batch.buckets():
        focal, nei, ea, mask = _shard_rows(
            [np.asarray(b.focal_index), np.asarray(b.nei_index),
             np.asarray(b.nei_edge_attr)],
            np.asarray(b.mask),
            n_shards,
        )
        buckets.append(DegreeBucket(focal_index=focal, nei_index=nei,
                                    nei_edge_attr=ea, mask=mask))
    return GraphBatch(
        x=rep(batch.x),
        p=rep(batch.p),
        node_mask=rep(batch.node_mask),
        node_graph_id=rep(batch.node_graph_id),
        edge_src=esrc,
        edge_dst=edst,
        edge_attr=eattr,
        edge_mask=emask,
        deg1=buckets[0],
        deg2=buckets[1],
        deg3=buckets[2],
        deg4=buckets[3],
        y=rep(batch.y),
        graph_mask=rep(batch.graph_mask),
    )


def _shard(batch: GraphBatch, index: int, like: torch.Tensor) -> GraphBatch:
    """Shard ``index`` of a ``partition_batch`` batch as tensors on
    ``like``'s device, float fields in its dtype."""
    def take(a):
        t = torch.from_numpy(np.ascontiguousarray(a[index]))
        return (t.to(like.dtype) if t.is_floating_point() else t).to(
            like.device)

    return GraphBatch.from_leaves([take(a) for a in batch.leaves()])


def edge_parallel_forward(model, mesh, axis: str = "data"):
    """``fn(partitioned batch) -> output``: the eval-mode forward of
    ``model`` (built with ``psum_group`` the mesh's ``axis`` group, so its
    per-layer partial results are summed) on this rank's shard of a
    ``partition_batch`` batch; the same on every rank."""
    if model.gnn.psum_group is None:
        raise ValueError(
            "edge_parallel_forward: build the model with psum_group="
            f"mesh.get_group({axis!r})")
    index = mesh.get_local_rank(axis)

    @torch.no_grad()
    def fn(batch: GraphBatch):
        model.eval()
        return model(_shard(batch, index, next(model.parameters())))

    return fn
