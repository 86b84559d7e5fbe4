"""Fixed-shape batches for ChIRoNet (internal-coordinate graphs).

Port of ``molkgnn_tpu/graphs/chiro.py``. A molecule's node and edge
features, its distance/angle/dihedral paths with their values, and the
local-structure map (each dihedral's row among the molecule's central
bonds) are computed once on the host (``mol_to_chiro_graph``); the packer
concatenates them into one padded batch, rebasing every atom index by the
batch's node offsets and ``ls_map`` by its alpha (central-bond) offsets.
Angles and dihedrals arrive mod 2*pi.

``batch_chiro`` gives the JAX packer's arrays bit for bit (index tensors
int32, float tensors float32; padding zero-filled, so padded edges and
paths point at node 0 and padded dihedrals at alpha row 0). A
``ChiroBatch`` holds CPU torch tensors and moves with ``to(device)``;
``leaves``/``from_leaves`` give its 28 tensors in the JAX package's field
order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from molkgnn_torch.chem.chiro_features import (
    CHIRO_EDGE_DIM,
    CHIRO_NODE_DIM,
    chiro_edge_features,
    chiro_node_features,
    internal_coordinates,
    local_structure_map,
)
from molkgnn_torch.chem.mol import Molecule
from molkgnn_torch.graphs.batch import _to


@dataclasses.dataclass
class ChiroGraph:
    """One molecule, chiro-featurized (host-side)."""

    x: np.ndarray  # [N, 52]
    edge_index: np.ndarray  # [2, E]
    edge_attr: np.ndarray  # [E, 14]
    distances: np.ndarray  # [D]
    distance_index: np.ndarray  # [D, 2]
    angles: np.ndarray  # [P]
    angle_index: np.ndarray  # [P, 3]
    dihedrals: np.ndarray  # [S]
    dihedral_index: np.ndarray  # [S, 4]
    ls_map: np.ndarray  # [S]
    alpha_index: np.ndarray  # [2, A]
    y: float = 0.0
    idx: int = -1
    smiles: str = ""

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    def counts(self) -> tuple:
        """(nodes, edges, distances, angles, dihedrals, alpha rows)."""
        return (self.x.shape[0], self.edge_index.shape[1],
                self.distances.shape[0], self.angles.shape[0],
                self.dihedrals.shape[0], self.alpha_index.shape[1])


COUNT_NAMES = ("nodes", "edges", "distances", "angles", "dihedrals",
               "alpha")


def mol_to_chiro_graph(
    mol: Molecule, y: float = 0.0, idx: int = -1, smiles: str = ""
) -> Optional[ChiroGraph]:
    """The molecule's ChiroGraph, or None when it has no dihedral path or
    its featurization fails (the JAX package drops the same molecules)."""
    try:
        coords = internal_coordinates(mol)
        if coords is None:
            return None
        distances, d_idx, angles, a_idx, dihedrals, s_idx = coords
        edge_index, edge_attr = chiro_edge_features(mol)
        x = chiro_node_features(mol)
        ls_map, alpha = local_structure_map(s_idx)
        return ChiroGraph(
            x=x,
            edge_index=edge_index,
            edge_attr=edge_attr,
            distances=distances,
            distance_index=d_idx,
            angles=(angles % (2 * np.pi)).astype(np.float32),
            angle_index=a_idx,
            dihedrals=(dihedrals % (2 * np.pi)).astype(np.float32),
            dihedral_index=s_idx,
            ls_map=ls_map,
            alpha_index=alpha,
            y=y,
            idx=idx,
            smiles=smiles,
        )
    except Exception:
        return None


def smiles_to_chiro_graph(
    smiles: str, y: float = 0.0, idx: int = -1, seed: int = 42
) -> Optional[ChiroGraph]:
    """SMILES -> embedded ChiroGraph (``chem.embed.embed_molecule`` with
    ``seed``), or None where the SMILES does not parse or the molecule has
    no dihedral: the JAX package's D4DCHP ChIRoNet ingest."""
    from molkgnn_torch.chem.embed import embed_molecule
    from molkgnn_torch.chem.smiles import parse_smiles

    mol = parse_smiles(smiles, add_hs=True)
    if mol is None:
        return None
    pos = embed_molecule(mol, seed=seed)
    for k, a in enumerate(mol.atoms):
        a.x, a.y, a.z = map(float, pos[k])
    return mol_to_chiro_graph(mol, y=y, idx=idx, smiles=smiles)


def template_graph() -> ChiroGraph:
    """A four-atom chain with one dihedral: only its shapes and types
    matter (``Predictor.export``'s example batch)."""
    def idx(rows, width):
        return np.asarray(rows, np.int64).reshape(-1, width)

    return ChiroGraph(
        x=np.zeros((4, CHIRO_NODE_DIM), np.float32),
        edge_index=idx([[0, 1, 1, 2, 2, 3], [1, 0, 2, 1, 3, 2]], 6),
        edge_attr=np.zeros((6, CHIRO_EDGE_DIM), np.float32),
        distances=np.ones((3,), np.float32),
        distance_index=idx([[0, 1], [1, 2], [2, 3]], 2),
        angles=np.ones((2,), np.float32),
        angle_index=idx([[0, 1, 2], [1, 2, 3]], 3),
        dihedrals=np.ones((1,), np.float32),
        dihedral_index=idx([[0, 1, 2, 3]], 4),
        ls_map=np.zeros((1,), np.int64),
        alpha_index=idx([[1], [2]], 1),
    )


@dataclasses.dataclass
class ChiroBatch:
    """One fixed-shape ChIRoNet batch (index tensors int32, masks bool)."""

    x: torch.Tensor  # [N, 52]
    node_mask: torch.Tensor  # [N]
    node_graph_id: torch.Tensor  # [N]
    edge_src: torch.Tensor  # [E]
    edge_dst: torch.Tensor  # [E]
    edge_attr: torch.Tensor  # [E, 14]
    edge_mask: torch.Tensor  # [E]
    distances: torch.Tensor  # [D]
    dist_i: torch.Tensor  # [D]
    dist_j: torch.Tensor  # [D]
    dist_mask: torch.Tensor  # [D]
    angles: torch.Tensor  # [P]
    ang_i: torch.Tensor
    ang_j: torch.Tensor
    ang_k: torch.Tensor
    ang_mask: torch.Tensor
    dihedrals: torch.Tensor  # [S]
    dih_i: torch.Tensor
    dih_j: torch.Tensor
    dih_k: torch.Tensor
    dih_l: torch.Tensor
    dih_mask: torch.Tensor
    ls_map: torch.Tensor  # [S] -> alpha rows
    alpha_x: torch.Tensor  # [A]
    alpha_y: torch.Tensor  # [A]
    alpha_mask: torch.Tensor  # [A]
    y: torch.Tensor  # [B]
    graph_mask: torch.Tensor  # [B]

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def num_graphs(self) -> int:
        return self.y.shape[-1]

    def to(self, device) -> "ChiroBatch":
        return _to(self, device)

    def leaves(self) -> list:
        """The 28 tensors in field order (the JAX package's tree order)."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @classmethod
    def from_leaves(cls, leaves) -> "ChiroBatch":
        return cls(*leaves)


@dataclasses.dataclass(frozen=True)
class ChiroBatchSpec:
    """Static capacities of a ChIRoNet batch."""

    num_graphs: int
    num_nodes: int
    num_edges: int
    num_dist: int
    num_angles: int
    num_dihedrals: int
    num_alpha: int
    node_dim: int = CHIRO_NODE_DIM
    edge_dim: int = CHIRO_EDGE_DIM

    def capacities(self) -> tuple:
        """The capacities in ``ChiroGraph.counts`` order."""
        return (self.num_nodes, self.num_edges, self.num_dist,
                self.num_angles, self.num_dihedrals, self.num_alpha)


def chiro_spec_for_graphs(
    graphs: Sequence[ChiroGraph], batch_size: int, align: int = 8,
    slack: float = 1.1,
) -> ChiroBatchSpec:
    """Capacities that fit any ``batch_size`` molecules of ``graphs``: per
    kind, the sum of the ``batch_size`` largest counts with 10% headroom,
    aligned up to 8."""
    counts = np.asarray([g.counts() for g in graphs],
                        np.int64).reshape(-1, 6)

    def cap(vals):
        top = np.sort(vals)[::-1][:batch_size]
        v = int(np.ceil(top.sum() * slack))
        return ((max(v, 1) + align - 1) // align) * align

    return ChiroBatchSpec(batch_size, *(cap(counts[:, k]) for k in range(6)))


def batch_chiro(
    graphs: Sequence[ChiroGraph], spec: ChiroBatchSpec
) -> ChiroBatch:
    """Pack ``graphs`` into one ``ChiroBatch`` of ``spec``'s shapes; raises
    ``ValueError`` when they exceed a capacity."""
    B = spec.num_graphs
    if len(graphs) > B:
        raise ValueError(f"batch of {len(graphs)} > spec.num_graphs={B}")
    counts = np.asarray([g.counts() for g in graphs],
                        np.int64).reshape(-1, 6)
    if (counts.sum(axis=0) > np.asarray(spec.capacities())).any():
        raise ValueError("chiro batch exceeds capacity")
    n_cnt, _, _, _, s_cnt, al_cnt = counts.T
    n_off = np.cumsum(n_cnt) - n_cnt
    al_off = np.cumsum(al_cnt) - al_cnt

    def fill(cap, chunks, tail=(), dtype=np.float32):
        out = np.zeros((cap,) + tail, dtype)
        if chunks:
            flat = np.concatenate(chunks)
            out[: flat.shape[0]] = flat
        return out

    def mask(cap, total):
        out = np.zeros((cap,), bool)
        out[:total] = True
        return out

    def rebased(cap, chunks, kind, off, width):
        """Index rows [sum, width] of one kind, each graph's rows plus its
        offset, as int32 columns."""
        rows = fill(cap, [np.asarray(c, np.int64).reshape(-1, width)
                          for c in chunks], (width,), np.int64)
        total = int(counts[:, kind].sum())
        rows[:total] += np.repeat(off, counts[:, kind])[:, None]
        return [rows[:, c].astype(np.int32) for c in range(width)]

    nodes = int(n_cnt.sum())
    gid = fill(spec.num_nodes, [np.full(n, b, np.int32)
                                for b, n in enumerate(n_cnt)], (), np.int32)
    esrc, edst = rebased(spec.num_edges, [g.edge_index.T for g in graphs],
                         1, n_off, 2)
    di, dj = rebased(spec.num_dist, [g.distance_index for g in graphs], 2,
                     n_off, 2)
    ai, aj, ak = rebased(spec.num_angles, [g.angle_index for g in graphs],
                         3, n_off, 3)
    si, sj, sk, sl = rebased(spec.num_dihedrals,
                             [g.dihedral_index for g in graphs], 4, n_off, 4)
    (lsm,) = rebased(spec.num_dihedrals, [g.ls_map for g in graphs], 4,
                     al_off, 1)
    ax, ay = rebased(spec.num_alpha, [g.alpha_index.T for g in graphs], 5,
                     n_off, 2)
    tot = counts.sum(axis=0)
    arrays = (
        fill(spec.num_nodes, [g.x for g in graphs], (spec.node_dim,)),
        mask(spec.num_nodes, nodes),
        gid,
        esrc, edst,
        fill(spec.num_edges, [g.edge_attr for g in graphs],
             (spec.edge_dim,)),
        mask(spec.num_edges, tot[1]),
        fill(spec.num_dist, [g.distances for g in graphs]),
        di, dj, mask(spec.num_dist, tot[2]),
        fill(spec.num_angles, [g.angles for g in graphs]),
        ai, aj, ak, mask(spec.num_angles, tot[3]),
        fill(spec.num_dihedrals, [g.dihedrals for g in graphs]),
        si, sj, sk, sl, mask(spec.num_dihedrals, tot[4]),
        lsm,
        ax, ay, mask(spec.num_alpha, tot[5]),
        fill(B, [np.asarray([g.y for g in graphs], np.float32)]),
        mask(B, len(graphs)),
    )
    return ChiroBatch(*(torch.from_numpy(a) for a in arrays))
