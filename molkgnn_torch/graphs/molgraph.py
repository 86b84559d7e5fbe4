"""Host-side molecular graph container and receptive-field extraction.

Numpy copy of ``molkgnn_tpu/graphs/molgraph.py`` (the port imports nothing
of the JAX package). A ``MolGraph`` is one molecule: node features ``x``
[N, F], 3D positions ``p`` [N, 3], a directed edge list with both bond
directions emitted consecutively (2i, 2i+1 for bond i), and edge features
[E, Fe].

``receptive_fields`` computes, for each degree d in {1..4}, the focal-node
indices, per-focal neighbor indices and the canonical-direction bond
attributes (bond id normalized via ``2*(edge_id//2)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

MAX_DEGREE = 4


@dataclasses.dataclass
class DegreeField:
    """Receptive field of every node with graph degree ``deg`` (host-side).

    Attributes:
      focal_index: [n_d] int32 node indices with this degree.
      nei_index:   [n_d, deg] int32 neighbor node indices.
      nei_edge_attr: [n_d, deg, Fe] canonical-direction bond features.
    """

    deg: int
    focal_index: np.ndarray
    nei_index: np.ndarray
    nei_edge_attr: np.ndarray

    @property
    def count(self) -> int:
        return int(self.focal_index.shape[0])


@dataclasses.dataclass
class MolGraph:
    """One molecule as numpy arrays (host-side, pre-batching)."""

    x: np.ndarray  # [N, F] float32 node features
    p: np.ndarray  # [N, D] float32 positions (D = 3)
    edge_index: np.ndarray  # [2, E] int32; row 0 = src, row 1 = dst
    edge_attr: np.ndarray  # [E, Fe] float32 bond features
    y: float = 0.0  # label
    atomic_num: Optional[np.ndarray] = None  # [N] int32
    smiles: str = ""
    idx: int = -1
    # filled by receptive_fields
    fields: Optional[Dict[int, DegreeField]] = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def with_fields(self) -> "MolGraph":
        if self.fields is None:
            self.fields = receptive_fields(self)
        return self


def node_degrees(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Out-degree of each node (== graph degree for symmetric edge lists)."""
    return np.bincount(edge_index[0], minlength=num_nodes).astype(np.int64)


def receptive_fields(g: MolGraph) -> Dict[int, DegreeField]:
    """Degree-bucketed neighborhoods, vectorized (no per-focal Python loop).

      * focal_index for degree d = nodes whose degree == d, ascending.
      * nei_index[i] = destinations of edges whose source is focal i, in edge
        list order.
      * nei_edge_attr[i, k] = edge_attr[2 * (e_ik // 2)] where e_ik is the edge
        id of the k-th incident edge — the *first* direction of the bond.
    """
    n = g.num_nodes
    src = g.edge_index[0]
    dst = g.edge_index[1]
    deg = node_degrees(g.edge_index, n)

    # Stable argsort on src gives, per focal node, its incident edge ids in
    # increasing order.
    order = np.argsort(src, kind="stable")
    sorted_dst = dst[order]
    canonical_eid = 2 * (order // 2)
    sorted_eattr = g.edge_attr[canonical_eid]

    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])

    fields: Dict[int, DegreeField] = {}
    for d in range(1, MAX_DEGREE + 1):
        focal = np.nonzero(deg == d)[0].astype(np.int32)
        if focal.shape[0] == 0:
            fields[d] = DegreeField(
                deg=d,
                focal_index=np.zeros((0,), np.int32),
                nei_index=np.zeros((0, d), np.int32),
                nei_edge_attr=np.zeros(
                    (0, d, g.edge_attr.shape[1]), np.float32
                ),
            )
            continue
        take = offsets[focal][:, None] + np.arange(d)[None, :]  # [n_d, d]
        fields[d] = DegreeField(
            deg=d,
            focal_index=focal,
            nei_index=sorted_dst[take].astype(np.int32),
            nei_edge_attr=sorted_eattr[take].astype(np.float32),
        )
    return fields
