"""ChIRoNet featurization: 52-dim nodes, 14-dim edges, internal coordinates.

Copied from ``molkgnn_tpu/chem/chiro_features.py``; the port imports nothing
of the JAX package. Node features (52): atom-symbol one-hot(12)+other, total
degree(7)+other, formal charge(5)+other, total H count(5)+other,
hybridization(7)+other, aromatic flag, mass*0.01, global chiral tag
one-hot(3)+other (0/R/S/other), local chiral tag one-hot(4)+other. Edge
features (14): bond-type one-hot(4)+other, conjugated, in-ring, stereo
one-hot(6)+other.

Internal coordinates come from all simple graph paths of length 1/2/3,
deduplicated by direction and measured from the 3D conformer; the ingest
(``graphs/chiro.py::mol_to_chiro_graph``) then maps angles and dihedrals
mod 2*pi. The rows of the distance, angle and dihedral index arrays and of
the local-structure map are in the JAX package's order exactly.

Global R/S tags are derived from the 3D geometry by the signed volume with
first-shell atomic-number priorities, an approximation of full CIP
(ambiguous centres get the 'other' tag); local (parity) tags are left
unassigned.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from molkgnn_torch.chem import periodic
from molkgnn_torch.chem.features import _pi_capable
from molkgnn_torch.chem.mol import Molecule

ATOM_TYPES = ["H", "C", "B", "N", "O", "F", "Si", "P", "S", "Cl", "Br", "I"]
FORMAL_CHARGE = [-1, -2, 1, 2, 0]
DEGREE = [0, 1, 2, 3, 4, 5, 6]
NUM_HS = [0, 1, 2, 3, 4]
LOCAL_CHIRAL_TAGS = [0, 1, 2, 3]
HYBRIDIZATIONS = ["S", "SP", "SP2", "SP3", "SP3D", "SP3D2", "UNSPECIFIED"]
BOND_TYPES = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]

CHIRO_NODE_DIM = 52
CHIRO_EDGE_DIM = 14


def _one_hot(value, options) -> List[float]:
    emb = [0.0] * (len(options) + 1)
    idx = options.index(value) if value in options else -1
    emb[idx] = 1.0
    return emb


def _hybridization_name(mol: Molecule, i: int) -> str:
    deg = mol.sigma_bonds(i)
    hyb = mol.hybridization(i)
    if mol.degree(i) == 0:
        return "S"
    if hyb == "sp":
        return "SP"
    if hyb == "sp2":
        return "SP2"
    if deg > 4:
        return "SP3D" if deg == 5 else "SP3D2"
    return "SP3"


def global_chiral_tags(mol: Molecule) -> dict:
    """Approximate R/S assignment for tetravalent centers with four
    distinct first-shell substituent priorities (atomic number, ties ->
    unassigned 'other'). Sign of det with the lowest-priority substituent
    behind decides R (+) vs S (-)."""
    tags = {}
    pos = mol.positions()
    for i in range(mol.num_atoms):
        nbrs = [j for j, _ in mol.neighbors(i)]
        if len(nbrs) != 4:
            continue
        prios = [periodic.atomic_number(mol.atoms[j].symbol) for j in nbrs]
        if len(set(prios)) < 4:
            # Could still be a stereocenter via deeper CIP comparison; flag
            # as unassigned ('other') only when branches are symbol-equal
            # at the first shell but structurally distinct is not resolved.
            continue
        order = np.argsort(prios)[::-1]  # descending priority
        a, b, c, d = (nbrs[k] for k in order)
        v1 = pos[a] - pos[i]
        v2 = pos[b] - pos[i]
        v3 = pos[c] - pos[i]
        det = float(np.dot(np.cross(v1, v2), v3))
        tags[i] = "R" if det > 0 else "S"
    return tags


def chiro_node_features(mol: Molecule) -> np.ndarray:
    tags = global_chiral_tags(mol)
    out = np.zeros((mol.num_atoms, CHIRO_NODE_DIM), np.float32)
    for i, atom in enumerate(mol.atoms):
        f: List[float] = []
        f += _one_hot(atom.symbol, ATOM_TYPES)
        f += _one_hot(mol.sigma_bonds(i), DEGREE)
        f += _one_hot(atom.charge, FORMAL_CHARGE)
        f += _one_hot(mol.total_h(i), NUM_HS)
        f += _one_hot(_hybridization_name(mol, i), HYBRIDIZATIONS)
        f.append(float(atom.aromatic))
        f.append(periodic.mass(atom.symbol) * 0.01)
        g = tags.get(i)
        gtag = 1 if g == "R" else (2 if g == "S" else 0)
        f += _one_hot(gtag, [0, 1, 2])
        f += _one_hot(0, LOCAL_CHIRAL_TAGS)  # local parity unassigned
        out[i] = f
    return out


def chiro_edge_features(mol: Molecule) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (edge_index [2, 2B] with paired directions, features [2B, 14]).
    Bonds are ordered by their (min, max) atom pair, an upper-triangular
    scan."""
    pairs = sorted(
        (min(b.a1, b.a2), max(b.a1, b.a2), bi)
        for bi, b in enumerate(mol.bonds)
    )
    edge_index = np.zeros((2, 2 * len(pairs)), np.int64)
    feats = np.zeros((2 * len(pairs), CHIRO_EDGE_DIM), np.float32)
    for n, (a, b, bi) in enumerate(pairs):
        bond = mol.bonds[bi]
        if bond.aromatic:
            btype = "AROMATIC"
        elif bond.order == 2.0:
            btype = "DOUBLE"
        elif bond.order == 3.0:
            btype = "TRIPLE"
        else:
            btype = "SINGLE"
        conj = bond.aromatic or (
            _pi_capable(mol, bond.a1) and _pi_capable(mol, bond.a2)
        )
        f = _one_hot(btype, BOND_TYPES) + [float(conj), float(bond.in_ring)]
        f += _one_hot(0, list(range(6)))  # stereo: NONE (native path)
        edge_index[:, 2 * n] = (a, b)
        edge_index[:, 2 * n + 1] = (b, a)
        feats[2 * n] = f
        feats[2 * n + 1] = f
    return edge_index, feats


def all_paths(mol: Molecule, length: int) -> List[Tuple[int, ...]]:
    """All simple paths with ``length`` edges (both directions), matching
    the networkx enumeration."""
    out: List[Tuple[int, ...]] = []

    def extend(path: List[int], n: int):
        if n == 0:
            out.append(tuple(path))
            return
        for nbr, _ in mol.neighbors(path[-1]):
            if nbr not in path:
                extend(path + [nbr], n - 1)

    for start in range(mol.num_atoms):
        extend([start], length)
    return out


def internal_coordinates(mol: Molecule):
    """(distances, dist_idx [D,2], angles, angle_idx [P,3], dihedrals,
    dihedral_idx [S,4]) or None if the molecule has no dihedral.
    Deduplication keeps the i<j / i<k / j<k-middle directions."""
    pos = mol.positions().astype(np.float64)

    d_idx = np.array(
        [p for p in all_paths(mol, 1) if p[0] < p[1]], dtype=np.int64
    ).reshape(-1, 2)
    a_idx = np.array(
        [p for p in all_paths(mol, 2) if p[0] < p[2]], dtype=np.int64
    ).reshape(-1, 3)
    s_idx = np.array(
        [p for p in all_paths(mol, 3) if p[1] < p[2]], dtype=np.int64
    ).reshape(-1, 4)
    if s_idx.shape[0] == 0:
        return None

    dvec = pos[d_idx[:, 1]] - pos[d_idx[:, 0]]
    distances = np.linalg.norm(dvec, axis=1).astype(np.float32)

    v1 = pos[a_idx[:, 0]] - pos[a_idx[:, 1]]
    v2 = pos[a_idx[:, 2]] - pos[a_idx[:, 1]]
    cosang = np.sum(v1 * v2, axis=1) / np.maximum(
        np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-12
    )
    angles = np.arccos(np.clip(cosang, -1.0, 1.0)).astype(np.float32)

    b1 = pos[s_idx[:, 1]] - pos[s_idx[:, 0]]
    b2 = pos[s_idx[:, 2]] - pos[s_idx[:, 1]]
    b3 = pos[s_idx[:, 3]] - pos[s_idx[:, 2]]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2_len = np.linalg.norm(b2, axis=1, keepdims=True)
    m1 = np.cross(n1, b2 / np.maximum(b2_len, 1e-12))
    x = np.sum(n1 * n2, axis=1)
    y = np.sum(m1 * n2, axis=1)
    dihedrals = np.arctan2(y, x).astype(np.float32)

    return distances, d_idx, angles, a_idx, dihedrals, s_idx


def local_structure_map(dihedral_idx: np.ndarray):
    """(LS_map [S], alpha_indices [2, A]): group dihedrals by central bond
    (j, k) in first-appearance order."""
    ls: dict = {}
    ls_map = np.zeros(dihedral_idx.shape[0], np.int64)
    for i, row in enumerate(dihedral_idx):
        key = (int(row[1]), int(row[2]))
        if key not in ls:
            ls[key] = len(ls)
        ls_map[i] = ls[key]
    alpha = np.array(list(ls.keys()), np.int64).T.reshape(2, -1)
    return ls_map, alpha
