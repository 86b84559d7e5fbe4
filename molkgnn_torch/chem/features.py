"""Featurization: Molecule -> MolGraph with the reference's exact layout.

Copied from ``molkgnn_tpu/chem/features.py``; the port imports nothing of the
JAX package.

Node features (28 dims, order from reference wrapper.py:45-100):
  [0:12]  one-hot atomic number over (H,C,N,O,F,Si,P,S,Cl,Br,I,other)
  [12:16] one-hot graph degree over (1,2,3,4) — values outside the list
          collapse onto the last slot (the reference's one_hot_vector quirk,
          wrapper.py:36-42)
  [16]    formal charge        [17] is-in-ring       [18] is-aromatic
  [19]    explicit valence     [20] atomic mass
  [21]    Gasteiger charge     [22] Gasteiger implicit-H charge
          (NaN/Inf -> 0, wrapper.py:57-68)
  [23]    Crippen logP contrib [24] Crippen MR contrib
  [25]    TPSA contrib         [26] Labute ASA contrib
  [27]    E-State index

Edge features (7 dims, wrapper.py:139-150): one-hot bond order over
(1, 1.5, 2, 3) + (aromatic, conjugated, in-ring); both bond directions are
emitted consecutively (wrapper.py:152-156).

``backend='native'`` uses this package's chemistry; ``backend='rdkit'``
computes the same features through RDKit for bit-exact reference parity
(requires rdkit installed).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from molkgnn_torch.chem import periodic
from molkgnn_torch.chem.contribs import (
    crippen_contribs,
    labute_asa_contribs,
    tpsa_contribs,
)
from molkgnn_torch.chem.estate import estate_indices
from molkgnn_torch.chem.gasteiger import gasteiger_charges
from molkgnn_torch.chem.mol import Molecule
from molkgnn_torch.graphs.molgraph import MolGraph

NODE_DIM = 28
EDGE_DIM = 7

_ELEMENT_ONEHOT = (1, 6, 7, 8, 9, 14, 15, 16, 17, 35, 53, 999)
_DEGREE_ONEHOT = (1, 2, 3, 4)
_BOND_ORDER_ONEHOT = (1.0, 1.5, 2.0, 3.0)


def _one_hot(val, options) -> list:
    if val not in options:
        val = options[-1]
    return [float(val == o) for o in options]


def _pi_capable(mol: Molecule, i: int) -> bool:
    atom = mol.atoms[i]
    if atom.aromatic:
        return True
    if any(mol.bonds[bi].order >= 2.0 for _, bi in mol.neighbors(i)):
        return True
    # Lone-pair donor adjacent to a pi system (amide N, enol O, ...).
    if atom.symbol in ("N", "O", "S"):
        for j, _ in mol.neighbors(i):
            nb = mol.atoms[j]
            if nb.aromatic or any(
                mol.bonds[bj].order >= 2.0 for _, bj in mol.neighbors(j)
            ):
                return True
    return False


def _clean(v: float) -> float:
    return 0.0 if (math.isnan(v) or math.isinf(v)) else float(v)


def featurize_native(mol: Molecule) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x [N,28], edge_index [2,E], edge_attr [E,7])."""
    n = mol.num_atoms
    q, qh = gasteiger_charges(mol)
    logp, mr = crippen_contribs(mol)
    tpsa = tpsa_contribs(mol)
    asa = labute_asa_contribs(mol)
    estate = estate_indices(mol)

    x = np.zeros((n, NODE_DIM), np.float32)
    for i, atom in enumerate(mol.atoms):
        feats = []
        feats += _one_hot(periodic.atomic_number(atom.symbol), _ELEMENT_ONEHOT)
        feats += _one_hot(mol.degree(i), _DEGREE_ONEHOT)
        feats.append(float(atom.charge))
        feats.append(float(atom.in_ring))
        feats.append(float(atom.aromatic))
        feats.append(float(mol.explicit_valence(i)))
        feats.append(periodic.mass(atom.symbol))
        feats.append(_clean(q[i]))
        feats.append(_clean(qh[i]))
        feats.append(float(logp[i]))
        feats.append(float(mr[i]))
        feats.append(float(tpsa[i]))
        feats.append(float(asa[i]))
        feats.append(float(estate[i]))
        x[i] = feats

    edge_list = []
    edge_attr = []
    for b in mol.bonds:
        conj = b.aromatic or (
            _pi_capable(mol, b.a1) and _pi_capable(mol, b.a2)
        )
        attr = _one_hot(b.order, _BOND_ORDER_ONEHOT) + [
            float(b.aromatic),
            float(conj),
            float(b.in_ring),
        ]
        edge_list.append((b.a1, b.a2))
        edge_attr.append(attr)
        edge_list.append((b.a2, b.a1))
        edge_attr.append(attr)

    if edge_list:
        edge_index = np.array(edge_list, np.int32).T
        edge_attr = np.array(edge_attr, np.float32)
    else:
        edge_index = np.zeros((2, 0), np.int32)
        edge_attr = np.zeros((0, EDGE_DIM), np.float32)
    return x, edge_index, edge_attr


def featurize_rdkit(rdmol) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bit-exact reference featurization through RDKit (wrapper.py:45-167)."""
    from rdkit.Chem import EState, rdMolDescriptors, rdPartialCharges

    rdPartialCharges.ComputeGasteigerCharges(rdmol)
    crippen = rdMolDescriptors._CalcCrippenContribs(rdmol)
    tpsa = rdMolDescriptors._CalcTPSAContribs(rdmol)
    asa = rdMolDescriptors._CalcLabuteASAContribs(rdmol)[0]
    estate = EState.EStateIndices(rdmol)

    x = []
    for i, atom in enumerate(rdmol.GetAtoms()):
        feats = []
        feats += _one_hot(atom.GetAtomicNum(), _ELEMENT_ONEHOT)
        feats += _one_hot(len(atom.GetNeighbors()), _DEGREE_ONEHOT)
        feats.append(atom.GetFormalCharge())
        feats.append(float(atom.IsInRing()))
        feats.append(float(atom.GetIsAromatic()))
        feats.append(float(atom.GetExplicitValence()))
        feats.append(atom.GetMass())
        feats.append(_clean(float(atom.GetProp("_GasteigerCharge"))))
        feats.append(_clean(float(atom.GetProp("_GasteigerHCharge"))))
        feats.append(crippen[i][0])
        feats.append(crippen[i][1])
        feats.append(tpsa[i])
        feats.append(asa[i])
        feats.append(float(estate[i]))
        x.append(feats)

    edge_list, edge_attr = [], []
    for bond in rdmol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        attr = _one_hot(bond.GetBondTypeAsDouble(), _BOND_ORDER_ONEHOT) + [
            float(bond.GetIsAromatic()),
            float(bond.GetIsConjugated()),
            float(bond.IsInRing()),
        ]
        edge_list += [(i, j), (j, i)]
        edge_attr += [attr, attr]
    edge_index = (
        np.array(edge_list, np.int32).T
        if edge_list
        else np.zeros((2, 0), np.int32)
    )
    return (
        np.array(x, np.float32),
        edge_index,
        np.array(edge_attr, np.float32)
        if edge_attr
        else np.zeros((0, EDGE_DIM), np.float32),
    )


def mol_to_graph(
    mol,
    y: float = 0.0,
    idx: int = -1,
    smiles: str = "",
    backend: str = "native",
) -> Optional[MolGraph]:
    """Molecule (native or RDKit) -> MolGraph, or None if featurization
    fails (the reference's invalid-molecule contract)."""
    try:
        if backend == "rdkit":
            x, edge_index, edge_attr = featurize_rdkit(mol)
            conf = mol.GetConformer()
            p = np.array(
                [
                    [
                        conf.GetAtomPosition(i).x,
                        conf.GetAtomPosition(i).y,
                        conf.GetAtomPosition(i).z,
                    ]
                    for i in range(mol.GetNumAtoms())
                ],
                np.float32,
            )
            atomic_num = np.array(
                [a.GetAtomicNum() for a in mol.GetAtoms()], np.int32
            )
        else:
            x, edge_index, edge_attr = featurize_native(mol)
            p = mol.positions()
            atomic_num = np.array(
                [periodic.atomic_number(a.symbol) for a in mol.atoms],
                np.int32,
            )
        if x.shape[0] == 0 or edge_index.shape[1] == 0:
            return None
        return MolGraph(
            x=x,
            p=p,
            edge_index=edge_index,
            edge_attr=edge_attr,
            y=y,
            atomic_num=atomic_num,
            smiles=smiles,
            idx=idx,
        )
    except Exception:
        return None
