"""Static-shape batched graphs.

Port of ``molkgnn_tpu/graphs/batch.py``. A ``GraphBatch`` packs B molecules
into one disjoint-union graph, padded to a fixed ``BatchSpec``:

  * nodes:   [N_pad] with ``node_mask``; padded rows are all-zero.
  * edges:   [E_pad] src/dst index arrays (COO, both bond directions) with
             ``edge_mask``; padded edges point at node 0 but carry zero weight.
  * degree buckets: for d in 1..4, fixed-capacity receptive fields
             (focal/neighbor indices into the packed node array) with masks.
  * graphs:  [B] labels + mask; ``node_graph_id`` drives segment-sum pooling.

Packing runs on the host in numpy (the arrays are bit-equal to the JAX
package's packer); the result holds CPU torch tensors and moves to the card
with ``GraphBatch.to(device)``. Index tensors stay int32, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from molkgnn_torch.graphs.molgraph import MAX_DEGREE, MolGraph


def _round_up(x: int, m: int) -> int:
    return ((max(int(x), 1) + m - 1) // m) * m


def _to(obj, device):
    """Copy every tensor field of a dataclass to ``device``."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
        },
    )


@dataclasses.dataclass
class DegreeBucket:
    """Padded receptive field of all degree-d nodes in the batch."""

    focal_index: torch.Tensor  # [M] int32 into packed nodes (0 where padded)
    nei_index: torch.Tensor  # [M, d] int32 into packed nodes (0 where padded)
    nei_edge_attr: torch.Tensor  # [M, d, Fe] float (zeros where padded)
    mask: torch.Tensor  # [M] bool

    def to(self, device) -> "DegreeBucket":
        return _to(self, device)


@dataclasses.dataclass
class GraphBatch:
    """One fixed-shape batch of molecules (torch tensors)."""

    x: torch.Tensor  # [N, F] node features
    p: torch.Tensor  # [N, D] positions
    node_mask: torch.Tensor  # [N] bool
    node_graph_id: torch.Tensor  # [N] int32 in [0, B)
    edge_src: torch.Tensor  # [E] int32
    edge_dst: torch.Tensor  # [E] int32
    edge_attr: torch.Tensor  # [E, Fe]
    edge_mask: torch.Tensor  # [E] bool
    deg1: DegreeBucket
    deg2: DegreeBucket
    deg3: DegreeBucket
    deg4: DegreeBucket
    y: torch.Tensor  # [B] float32 labels
    graph_mask: torch.Tensor  # [B] bool

    @property
    def num_graphs(self) -> int:
        return self.y.shape[-1]

    def buckets(self):
        return (self.deg1, self.deg2, self.deg3, self.deg4)

    def to(self, device) -> "GraphBatch":
        return _to(self, device)

    def leaves(self) -> list:
        """The 26 tensors in the order ``jax.tree_util.tree_flatten`` gives
        the JAX package's GraphBatch: the fields in order, each bucket's
        four fields in place of the bucket."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, DegreeBucket):
                out += [getattr(v, b.name) for b in dataclasses.fields(v)]
            else:
                out.append(v)
        return out

    @classmethod
    def from_leaves(cls, leaves) -> "GraphBatch":
        """The inverse of ``leaves``."""
        it = iter(leaves)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name.startswith("deg"):
                kw[f.name] = DegreeBucket(*(next(it) for _ in range(4)))
            else:
                kw[f.name] = next(it)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static capacities of a batch family."""

    num_graphs: int
    num_nodes: int
    num_edges: int
    deg_capacity: tuple  # (M1, M2, M3, M4)
    node_dim: int = 28
    edge_dim: int = 7
    pos_dim: int = 3


def spec_for_graphs(graphs: Sequence[MolGraph], batch_size: int) -> BatchSpec:
    """Derive capacities that fit any ``batch_size`` molecules drawn from
    ``graphs``: the sum of the ``batch_size`` largest counts with 10%
    headroom, aligned up to 8."""

    def cap(values: np.ndarray) -> int:
        top = np.sort(values)[::-1][:batch_size]
        return _round_up(int(np.ceil(top.sum() * 1.1)), 8)

    nodes = np.array([g.num_nodes for g in graphs])
    edges = np.array([g.num_edges for g in graphs])
    degs = []
    for d in range(1, MAX_DEGREE + 1):
        degs.append(
            cap(np.array([g.with_fields().fields[d].count for g in graphs]))
        )
    g0 = graphs[0]
    return BatchSpec(
        num_graphs=batch_size,
        num_nodes=cap(nodes),
        num_edges=cap(edges),
        deg_capacity=tuple(degs),
        node_dim=int(g0.x.shape[1]),
        edge_dim=int(g0.edge_attr.shape[1]),
        pos_dim=int(g0.p.shape[1]),
    )


def _pad_concat(arrays, total: int, name: str) -> np.ndarray:
    """Concatenate then zero-pad axis 0 to ``total``."""
    cat = np.concatenate(arrays, axis=0)
    if cat.shape[0] > total:
        raise ValueError(
            f"batch exceeds {name} capacity ({cat.shape[0]} > {total})"
        )
    pad = np.zeros((total - cat.shape[0],) + cat.shape[1:], cat.dtype)
    return np.concatenate([cat, pad], axis=0)


def batch_graphs(graphs: Sequence[MolGraph], spec: BatchSpec) -> GraphBatch:
    """Pack molecules into one padded GraphBatch (numpy, then CPU tensors).

    Node indices are offset per molecule (disjoint union). Raises if the batch
    exceeds any static capacity.
    """
    B = spec.num_graphs
    if len(graphs) > B:
        raise ValueError(f"batch of {len(graphs)} > spec.num_graphs={B}")

    graphs = [g.with_fields() for g in graphs]
    counts = np.array([g.num_nodes for g in graphs], np.int64)
    n_offsets = np.concatenate([[0], np.cumsum(counts)])
    if n_offsets[-1] > spec.num_nodes:
        raise ValueError("batch exceeds node/edge capacity")

    x = _pad_concat([g.x for g in graphs], spec.num_nodes, "node")
    p = _pad_concat([g.p for g in graphs], spec.num_nodes, "node")
    node_mask = np.arange(spec.num_nodes) < n_offsets[-1]
    node_graph_id = _pad_concat(
        [np.full(g.num_nodes, gi, np.int32) for gi, g in enumerate(graphs)],
        spec.num_nodes,
        "node",
    ).astype(np.int32)

    e_total = int(sum(g.num_edges for g in graphs))
    edge_pair = _pad_concat(
        [
            (g.edge_index + n_offsets[gi]).astype(np.int32).T
            for gi, g in enumerate(graphs)
        ],
        spec.num_edges,
        "edge",
    ).astype(np.int32)
    edge_attr = _pad_concat(
        [g.edge_attr for g in graphs], spec.num_edges, "edge"
    )
    edge_mask = np.arange(spec.num_edges) < e_total

    y = np.zeros((B,), np.float32)
    y[: len(graphs)] = [g.y for g in graphs]
    graph_mask = np.arange(B) < len(graphs)

    t = torch.from_numpy
    buckets = []
    for d in range(1, MAX_DEGREE + 1):
        fs = [g.fields[d] for g in graphs]
        total = sum(f.count for f in fs)
        cap = spec.deg_capacity[d - 1]
        if total > cap:
            raise ValueError(f"batch exceeds degree-{d} capacity")
        live = [(gi, f) for gi, f in enumerate(fs) if f.count]
        focal = _pad_concat(
            [(f.focal_index + n_offsets[i]).astype(np.int32) for i, f in live]
            or [np.zeros((0,), np.int32)],
            cap,
            f"deg{d}",
        ).astype(np.int32)
        nei = _pad_concat(
            [(f.nei_index + n_offsets[i]).astype(np.int32) for i, f in live]
            or [np.zeros((0, d), np.int32)],
            cap,
            f"deg{d}",
        ).astype(np.int32)
        nei_ea = _pad_concat(
            [f.nei_edge_attr for _, f in live]
            or [np.zeros((0, d, spec.edge_dim), np.float32)],
            cap,
            f"deg{d}",
        )
        buckets.append(
            DegreeBucket(
                focal_index=t(focal),
                nei_index=t(nei),
                nei_edge_attr=t(nei_ea),
                mask=t(np.arange(cap) < total),
            )
        )
    return GraphBatch(
        x=t(x),
        p=t(p),
        node_mask=t(node_mask),
        node_graph_id=t(node_graph_id),
        edge_src=t(np.ascontiguousarray(edge_pair[:, 0])),
        edge_dst=t(np.ascontiguousarray(edge_pair[:, 1])),
        edge_attr=t(edge_attr),
        edge_mask=t(edge_mask),
        deg1=buckets[0],
        deg2=buckets[1],
        deg3=buckets[2],
        deg4=buckets[3],
        y=t(y),
        graph_mask=t(graph_mask),
    )
