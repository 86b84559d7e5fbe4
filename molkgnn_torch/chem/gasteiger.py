"""Gasteiger-Marsili (PEOE) partial charges.

Copied from ``molkgnn_tpu/chem/gasteiger.py``; the port imports nothing of the
JAX package.

Native implementation of the iterative partial-equalization-of-orbital-
electronegativity algorithm (Gasteiger & Marsili, Tetrahedron 1980) used by
the reference through RDKit (wrapper.py:115 ``ComputeGasteigerCharges``;
features at wrapper.py:57-68). Electronegativity χ(q) = a + b·q + c·q² with
the published per-(element, hybridization) parameters; charge flows along
each bond from the less to the more electronegative atom, damped by 2^-k per
iteration (12 iterations, RDKit's default). Implicit hydrogens participate
as virtual atoms; their summed charge per heavy atom is the
``_GasteigerHCharge`` analogue.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from molkgnn_torch.chem.mol import Molecule

# (a, b, c) by (symbol, hybridization-ish key); Gasteiger-Marsili Table 1 /
# RDKit Gasteiger parameter set.
PARAMS = {
    ("H", "*"): (7.17, 6.24, -0.56),
    ("C", "sp3"): (7.98, 9.18, 1.88),
    ("C", "sp2"): (8.79, 9.32, 1.51),
    ("C", "sp"): (10.39, 9.45, 0.73),
    ("N", "sp3"): (11.54, 10.82, 1.36),
    ("N", "sp2"): (12.87, 11.15, 0.85),
    ("N", "sp"): (15.68, 11.70, -0.27),
    ("O", "sp3"): (14.18, 12.92, 1.39),
    ("O", "sp2"): (17.07, 13.79, 0.47),
    ("F", "*"): (14.66, 13.85, 2.31),
    ("Cl", "*"): (11.00, 9.69, 1.35),
    ("Br", "*"): (10.08, 8.47, 1.16),
    ("I", "*"): (9.90, 7.96, 0.96),
    ("S", "*"): (10.14, 9.13, 1.38),
    ("P", "*"): (8.90, 8.24, 0.96),
    ("Si", "*"): (8.10, 7.92, 1.78),
    ("B", "*"): (7.22, 8.04, 1.45),
}
_DEFAULT = (7.98, 9.18, 1.88)  # fall back to C sp3 for exotic atoms
_H_CATION_CHI = 20.02
N_ITERATIONS = 12


def _abc(symbol: str, hyb: str) -> Tuple[float, float, float]:
    return (
        PARAMS.get((symbol, hyb))
        or PARAMS.get((symbol, "*"))
        or _DEFAULT
    )


def gasteiger_charges(mol: Molecule) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (charge per heavy atom, summed implicit-H charge per atom)."""
    n = mol.num_atoms
    # Virtual expansion: heavy/explicit atoms 0..n-1, then implicit Hs.
    abc: List[Tuple[float, float, float]] = []
    q: List[float] = []
    owner: List[int] = []  # for virtual Hs, the heavy atom index
    edges: List[Tuple[int, int]] = []
    for i in range(n):
        atom = mol.atoms[i]
        abc.append(_abc(atom.symbol, mol.hybridization(i)))
        q.append(float(atom.charge))
        owner.append(-1)
    for _, b in enumerate(mol.bonds):
        edges.append((b.a1, b.a2))
    for i in range(n):
        for _ in range(mol.atoms[i].implicit_h):
            abc.append(PARAMS[("H", "*")])
            q.append(0.0)
            owner.append(i)
            edges.append((i, len(q) - 1))

    a = np.array([p[0] for p in abc])
    b = np.array([p[1] for p in abc])
    c = np.array([p[2] for p in abc])
    chi_cation = a + b + c
    is_h = np.array(
        [
            (mol.atoms[i].symbol == "H" if i < n else True)
            for i in range(len(q))
        ]
    )
    chi_cation = np.where(is_h, _H_CATION_CHI, chi_cation)
    q = np.array(q)
    src = np.array([e[0] for e in edges], dtype=np.int64)
    dst = np.array([e[1] for e in edges], dtype=np.int64)

    damp = 1.0
    for _ in range(N_ITERATIONS):
        damp *= 0.5
        chi = a + b * q + c * q * q
        diff = chi[dst] - chi[src]
        denom = np.where(diff > 0, chi_cation[src], chi_cation[dst])
        transfer = diff / denom * damp
        dq = np.zeros_like(q)
        np.add.at(dq, src, transfer)
        np.add.at(dq, dst, -transfer)
        q = q + dq

    heavy_q = q[:n]
    h_q = np.zeros(n)
    for vi in range(n, len(q)):
        h_q[owner[vi]] += q[vi]
    return heavy_q, h_q
