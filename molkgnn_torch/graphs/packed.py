"""Flat-packed dataset for fast host-side batch assembly.

Port of ``molkgnn_tpu/graphs/packed.py``. ``PackedGraphs`` concatenates the
whole dataset once into flat arrays with per-graph offsets; assembling a
batch is then about a dozen vectorized numpy gathers, whatever the batch
size. ``pack`` gives the same arrays as ``batch_graphs`` (bit for bit) as
CPU tensors. The same flat arrays, on the card, are the device-resident
dataset of ``graphs/device_pack.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from molkgnn_torch.graphs.batch import BatchSpec, DegreeBucket, GraphBatch
from molkgnn_torch.graphs.molgraph import MAX_DEGREE, MolGraph


def _ranges_to_indices(starts, lens) -> np.ndarray:
    """Concatenate the ranges [starts[i], starts[i] + lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros((0,), np.int64)
    base = np.repeat(starts, lens)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
    )
    return base + within


@dataclasses.dataclass
class PackedGraphs:
    """Whole-dataset flat arrays with per-graph offset tables."""

    x: np.ndarray  # [sumN, F]
    p: np.ndarray  # [sumN, 3]
    node_count: np.ndarray  # [G]
    node_start: np.ndarray  # [G]
    edge_local: np.ndarray  # [sumE, 2] local (src, dst)
    edge_attr: np.ndarray  # [sumE, Fe]
    edge_count: np.ndarray  # [G]
    edge_start: np.ndarray  # [G]
    y: np.ndarray  # [G]
    # per degree d (index d - 1): local focal/nei indices + bond attrs
    deg_focal: List[np.ndarray]
    deg_nei: List[np.ndarray]
    deg_ea: List[np.ndarray]
    deg_count: List[np.ndarray]  # [G] per degree
    deg_start: List[np.ndarray]

    @classmethod
    def from_graphs(cls, graphs: Sequence[MolGraph]) -> "PackedGraphs":
        graphs = [g.with_fields() for g in graphs]
        node_count = np.array([g.num_nodes for g in graphs], np.int64)
        edge_count = np.array([g.num_edges for g in graphs], np.int64)

        def starts(c):
            return np.concatenate([[0], np.cumsum(c)[:-1]])

        deg_focal, deg_nei, deg_ea, deg_count, deg_start = [], [], [], [], []
        for d in range(1, MAX_DEGREE + 1):
            fs = [g.fields[d] for g in graphs]
            cnt = np.array([f.count for f in fs], np.int64)
            deg_count.append(cnt)
            deg_start.append(starts(cnt))
            deg_focal.append(
                np.concatenate([f.focal_index for f in fs]).astype(np.int32)
            )
            deg_nei.append(
                np.concatenate([f.nei_index for f in fs]).astype(np.int32)
            )
            deg_ea.append(
                np.concatenate([f.nei_edge_attr for f in fs]).astype(
                    np.float32
                )
            )
        return cls(
            x=np.concatenate([g.x for g in graphs]).astype(np.float32),
            p=np.concatenate([g.p for g in graphs]).astype(np.float32),
            node_count=node_count,
            node_start=starts(node_count),
            edge_local=np.concatenate(
                [g.edge_index.T for g in graphs]
            ).astype(np.int32),
            edge_attr=np.concatenate([g.edge_attr for g in graphs]).astype(
                np.float32
            ),
            edge_count=edge_count,
            edge_start=starts(edge_count),
            y=np.array([g.y for g in graphs], np.float32),
            deg_focal=deg_focal,
            deg_nei=deg_nei,
            deg_ea=deg_ea,
            deg_count=deg_count,
            deg_start=deg_start,
        )

    def pack(self, ids: np.ndarray, spec: BatchSpec) -> GraphBatch:
        """The GraphBatch (CPU tensors) of the graphs ``ids``; raises where
        they exceed a capacity of ``spec``."""
        ids = np.asarray(ids, np.int64)
        B = spec.num_graphs
        if ids.shape[0] > B:
            raise ValueError(f"batch of {ids.shape[0]} > spec.num_graphs={B}")

        nlens = self.node_count[ids]
        n_total = int(nlens.sum())
        if n_total > spec.num_nodes:
            raise ValueError("batch exceeds node/edge capacity")
        nidx = _ranges_to_indices(self.node_start[ids], nlens)
        boff = np.concatenate([[0], np.cumsum(nlens)[:-1]])  # node offsets

        def fill(dst_shape, dtype, src):
            out = np.zeros(dst_shape, dtype)
            out[: src.shape[0]] = src
            return torch.from_numpy(out)

        x = fill((spec.num_nodes, spec.node_dim), np.float32, self.x[nidx])
        p = fill((spec.num_nodes, spec.pos_dim), np.float32, self.p[nidx])
        node_mask = torch.from_numpy(np.arange(spec.num_nodes) < n_total)
        node_graph_id = fill(
            (spec.num_nodes,),
            np.int32,
            np.repeat(np.arange(ids.shape[0], dtype=np.int32), nlens),
        )

        elens = self.edge_count[ids]
        e_total = int(elens.sum())
        if e_total > spec.num_edges:
            raise ValueError("batch exceeds node/edge capacity")
        eidx = _ranges_to_indices(self.edge_start[ids], elens)
        e_off = np.repeat(boff, elens).astype(np.int32)
        pair = self.edge_local[eidx] + e_off[:, None]

        buckets = []
        for d in range(MAX_DEGREE):
            cap = spec.deg_capacity[d]
            dlens = self.deg_count[d][ids]
            d_total = int(dlens.sum())
            if d_total > cap:
                raise ValueError(f"batch exceeds degree-{d + 1} capacity")
            didx = _ranges_to_indices(self.deg_start[d][ids], dlens)
            d_off = np.repeat(boff, dlens).astype(np.int32)
            buckets.append(
                DegreeBucket(
                    focal_index=fill(
                        (cap,), np.int32, self.deg_focal[d][didx] + d_off
                    ),
                    nei_index=fill(
                        (cap, d + 1),
                        np.int32,
                        self.deg_nei[d][didx] + d_off[:, None],
                    ),
                    nei_edge_attr=fill(
                        (cap, d + 1, spec.edge_dim),
                        np.float32,
                        self.deg_ea[d][didx],
                    ),
                    mask=torch.from_numpy(np.arange(cap) < d_total),
                )
            )

        return GraphBatch(
            x=x,
            p=p,
            node_mask=node_mask,
            node_graph_id=node_graph_id,
            edge_src=fill((spec.num_edges,), np.int32, pair[:, 0]),
            edge_dst=fill((spec.num_edges,), np.int32, pair[:, 1]),
            edge_attr=fill(
                (spec.num_edges, spec.edge_dim),
                np.float32,
                self.edge_attr[eidx],
            ),
            edge_mask=torch.from_numpy(np.arange(spec.num_edges) < e_total),
            deg1=buckets[0],
            deg2=buckets[1],
            deg3=buckets[2],
            deg4=buckets[3],
            y=fill((B,), np.float32, self.y[ids]),
            graph_mask=torch.from_numpy(np.arange(B) < ids.shape[0]),
        )
