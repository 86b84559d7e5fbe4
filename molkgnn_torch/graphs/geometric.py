"""Point-cloud batches for the SchNet, DimeNet++ and SphereNet baselines.

Port of ``molkgnn_tpu/graphs/geometric.py``. The three families read only
atomic numbers and positions, and their graphs are geometric: the radius
graph (every pair closer than the cutoff, both directions), the angle
triplets k -> j -> i over it, and for SphereNet the torsion candidate pairs
of each triplet. All three are static per conformer, so they are enumerated
once per molecule on the host (``molecule_geometry``, cached on the
molecule) and packed with the molecule into fixed-shape, masked index
arrays (``batch_points``, capacities from ``point_spec_for_graphs``).

The enumerations are vectorised numpy (a stable sort of the edges by
destination, ``np.repeat`` over in-degrees, a mask) and give the JAX
package's Python loops' rows in the same order, bit for bit:

  * ``radius_edges``: pairs (j, i), j != i, ordered by i, then j;
  * ``triplet_index``: rows (e_kj, e_ji, k) for ascending e_ji, then
    ascending e_kj, with k != i;
  * ``torsion_pairs``: rows (t, k_n) for ascending triplet t, then the
    in-edges of j in edge order, with k_n != i (k_n == k included).

A ``PointBatch`` holds CPU torch tensors (index tensors int32) and moves
with ``to(device)``; ``leaves``/``from_leaves`` give its 16 tensors in the
JAX package's field order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from molkgnn_torch.graphs.batch import _to
from molkgnn_torch.graphs.molgraph import MolGraph


def molecule_geometry(
    g: MolGraph, cutoff: float, with_triplets: bool, with_torsion: bool
):
    """(edges [2, E], triplets [3, T], quads [2, Q]) of ``g``, cached on the
    molecule per (cutoff, flags): a molecule pays its enumeration once."""
    key = (float(cutoff), bool(with_triplets), bool(with_torsion))
    cache = getattr(g, "_geom_cache", None)
    if cache is None:
        cache = {}
        g._geom_cache = cache
    hit = cache.get(key)
    if hit is not None:
        return hit
    e = radius_edges(g.p, cutoff)
    t = (
        triplet_index(e, g.num_nodes)
        if (with_triplets or with_torsion)
        else np.zeros((3, 0), np.int32)
    )
    q = (
        torsion_pairs(e, t, g.num_nodes)
        if with_torsion
        else np.zeros((2, 0), np.int32)
    )
    cache[key] = (e, t, q)
    return cache[key]


def radius_edges(pos: np.ndarray, cutoff: float) -> np.ndarray:
    """[2, E] directed (j, i) pairs with |pos_j - pos_i| < cutoff, j != i,
    ordered by target i, then source j."""
    d = np.linalg.norm(pos[None, :, :] - pos[:, None, :], axis=-1)
    n = pos.shape[0]
    mask = (d < cutoff) & ~np.eye(n, dtype=bool)
    i_idx, j_idx = np.nonzero(mask)  # row-major: i ascending, then j
    return np.stack([j_idx, i_idx]).astype(np.int32)


def _in_edges(edge_index: np.ndarray, num_nodes: int, centre: np.ndarray):
    """For each row r of ``centre`` (node ids), the in-edges of that node in
    edge order, flattened: (row [R], in-edge id [R])."""
    dst = edge_index[1]
    by_dst = np.argsort(dst, kind="stable")  # in-edges per node, in order
    indeg = np.bincount(dst, minlength=num_nodes)
    first = np.cumsum(indeg) - indeg
    counts = indeg[centre]
    row = np.repeat(np.arange(centre.shape[0]), counts)
    within = np.arange(row.shape[0]) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    return row, by_dst[first[centre[row]] + within]


def triplet_index(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """[3, T] rows (e_kj, e_ji, k) of angle triplets k -> j -> i: for each
    edge e_ji = (j -> i) in order, each in-edge e_kj = (k -> j) of j in
    order, with k != i."""
    src, dst = edge_index
    e_ji, e_kj = _in_edges(edge_index, num_nodes, src)
    k = src[e_kj]
    keep = k != dst[e_ji]
    return np.stack([e_kj[keep], e_ji[keep], k[keep]]).astype(np.int32)


def torsion_pairs(
    edge_index: np.ndarray, triplets: np.ndarray, num_nodes: int
) -> np.ndarray:
    """[2, Q] rows (triplet id, k_n) of torsion candidates: for each triplet
    t = (k -> j -> i) in order, every in-neighbour k_n of j in edge order
    with k_n != i (k_n == k included; it yields the torsion 2 pi).
    SphereNet takes the least torsion over a triplet's candidates."""
    src, dst = edge_index
    e_ji = triplets[1].astype(np.int64)
    t, e_in = _in_edges(edge_index, num_nodes, src[e_ji])
    k_n = src[e_in]
    keep = k_n != dst[e_ji[t]]
    return np.stack([t[keep], k_n[keep]]).astype(np.int32)


@dataclasses.dataclass
class PointBatch:
    """One fixed-shape batch of point clouds: atomic numbers, positions and
    the radius graph, with angle triplets (DimeNet++, SphereNet) and
    torsion candidates (SphereNet)."""

    z: torch.Tensor  # [N] int32 atomic numbers
    pos: torch.Tensor  # [N, 3]
    node_mask: torch.Tensor  # [N] bool
    node_graph_id: torch.Tensor  # [N] int32
    edge_src: torch.Tensor  # [E] int32 (j)
    edge_dst: torch.Tensor  # [E] int32 (i)
    edge_mask: torch.Tensor  # [E] bool
    tri_edge_kj: torch.Tensor  # [T] int32 edge ids
    tri_edge_ji: torch.Tensor  # [T] int32 edge ids
    tri_k: torch.Tensor  # [T] int32 node ids
    tri_mask: torch.Tensor  # [T] bool
    quad_t: torch.Tensor  # [Q] int32 triplet ids
    quad_kn: torch.Tensor  # [Q] int32 node ids
    quad_mask: torch.Tensor  # [Q] bool
    y: torch.Tensor  # [B]
    graph_mask: torch.Tensor  # [B] bool

    @property
    def num_nodes(self) -> int:
        return self.z.shape[-1]

    @property
    def num_graphs(self) -> int:
        return self.y.shape[-1]

    def to(self, device) -> "PointBatch":
        return _to(self, device)

    def leaves(self) -> list:
        """The 16 tensors in field order (the JAX package's tree order)."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "PointBatch":
        return cls(*leaves)


@dataclasses.dataclass(frozen=True)
class PointBatchSpec:
    """Static capacities of a point-cloud batch, and its geometry."""

    num_graphs: int
    num_nodes: int
    num_edges: int
    num_triplets: int
    cutoff: float
    with_triplets: bool = False
    num_quads: int = 8
    with_torsion: bool = False


def point_spec_for_graphs(
    graphs: Sequence[MolGraph],
    batch_size: int,
    cutoff: float,
    with_triplets: bool = False,
    with_torsion: bool = False,
    align: int = 8,
    slack: float = 1.1,
) -> PointBatchSpec:
    """Capacities that fit any ``batch_size`` molecules of ``graphs``: the
    sum of the ``batch_size`` largest counts with 10% headroom, aligned up
    to 8 (unused levels keep a capacity of 8)."""
    def cap(values):
        top = np.sort(np.asarray(values))[::-1][:batch_size]
        v = int(np.ceil(top.sum() * slack))
        return ((max(v, 1) + align - 1) // align) * align

    nodes, edges, tris, quads = [], [], [], []
    for g in graphs:
        e, t, q = molecule_geometry(g, cutoff, with_triplets, with_torsion)
        nodes.append(g.num_nodes)
        edges.append(e.shape[1])
        if with_triplets or with_torsion:
            tris.append(t.shape[1])
            if with_torsion:
                quads.append(q.shape[1])
    return PointBatchSpec(
        num_graphs=batch_size,
        num_nodes=cap(nodes),
        num_edges=cap(edges),
        num_triplets=cap(tris) if (with_triplets or with_torsion) else 8,
        cutoff=cutoff,
        with_triplets=with_triplets or with_torsion,
        num_quads=cap(quads) if with_torsion else 8,
        with_torsion=with_torsion,
    )


def batch_points(
    graphs: Sequence[MolGraph], spec: PointBatchSpec
) -> PointBatch:
    """Pack ``graphs`` into one ``PointBatch`` of ``spec``'s shapes; raises
    ``ValueError`` when they exceed a capacity."""
    B = spec.num_graphs
    if len(graphs) > B:
        raise ValueError(f"batch of {len(graphs)} > spec.num_graphs={B}")
    z = np.zeros((spec.num_nodes,), np.int32)
    pos = np.zeros((spec.num_nodes, 3), np.float32)
    node_mask = np.zeros((spec.num_nodes,), bool)
    gid = np.zeros((spec.num_nodes,), np.int32)
    esrc = np.zeros((spec.num_edges,), np.int32)
    edst = np.zeros((spec.num_edges,), np.int32)
    emask = np.zeros((spec.num_edges,), bool)
    tkj = np.zeros((spec.num_triplets,), np.int32)
    tji = np.zeros((spec.num_triplets,), np.int32)
    tk = np.zeros((spec.num_triplets,), np.int32)
    tmask = np.zeros((spec.num_triplets,), bool)
    qt = np.zeros((spec.num_quads,), np.int32)
    qkn = np.zeros((spec.num_quads,), np.int32)
    qmask = np.zeros((spec.num_quads,), bool)
    y = np.zeros((B,), np.float32)
    gmask = np.zeros((B,), bool)

    n_off = e_off = t_off = q_off = 0
    for bi, g in enumerate(graphs):
        e, t, q = molecule_geometry(
            g, spec.cutoff, spec.with_triplets, spec.with_torsion
        )
        n, ne = g.num_nodes, e.shape[1]
        if n_off + n > spec.num_nodes or e_off + ne > spec.num_edges:
            raise ValueError("point batch exceeds capacity")
        z[n_off : n_off + n] = g.atomic_num
        pos[n_off : n_off + n] = g.p
        node_mask[n_off : n_off + n] = True
        gid[n_off : n_off + n] = bi
        esrc[e_off : e_off + ne] = e[0] + n_off
        edst[e_off : e_off + ne] = e[1] + n_off
        emask[e_off : e_off + ne] = True
        if spec.with_triplets:
            nt = t.shape[1]
            if t_off + nt > spec.num_triplets:
                raise ValueError("point batch exceeds triplet capacity")
            tkj[t_off : t_off + nt] = t[0] + e_off
            tji[t_off : t_off + nt] = t[1] + e_off
            tk[t_off : t_off + nt] = t[2] + n_off
            tmask[t_off : t_off + nt] = True
            if spec.with_torsion:
                nq = q.shape[1]
                if q_off + nq > spec.num_quads:
                    raise ValueError("point batch exceeds quad capacity")
                qt[q_off : q_off + nq] = q[0] + t_off
                qkn[q_off : q_off + nq] = q[1] + n_off
                qmask[q_off : q_off + nq] = True
                q_off += nq
            t_off += nt
        y[bi] = g.y
        gmask[bi] = True
        n_off += n
        e_off += ne
    arrays = (z, pos, node_mask, gid, esrc, edst, emask, tkj, tji, tk, tmask,
              qt, qkn, qmask, y, gmask)
    return PointBatch(*(torch.from_numpy(a) for a in arrays))
