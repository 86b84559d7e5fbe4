"""Kier-Hall electrotopological state (E-State) indices.

Copied from ``molkgnn_tpu/chem/estate.py``; the port imports nothing of the
JAX package.

Native implementation of the algorithm behind RDKit's
``EState.EStateIndices`` (reference feature, wrapper.py:83, 91-97):

  intrinsic state  I_i = ((2/n_i)^2 * δv_i + 1) / δ_i
     with δ_i  = graph degree, δv_i = valence electrons − attached H count,
          n_i = principal quantum number;
  field effect     E_i = I_i + Σ_j (I_i − I_j) / (d_ij + 1)^2
     with d_ij the topological (shortest-path) distance.

Computed over the molecule as given (explicit hydrogens included if
present), matching RDKit's behavior on the reference's explicit-H SDF data.
"""

from __future__ import annotations

import numpy as np

from molkgnn_torch.chem import periodic
from molkgnn_torch.chem.mol import Molecule


def topological_distances(mol: Molecule) -> np.ndarray:
    """All-pairs shortest path lengths via BFS (molecules are tiny)."""
    n = mol.num_atoms
    dist = np.full((n, n), 1e8)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        seen = {s}
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v, _ in mol.neighbors(u):
                    if v not in seen:
                        seen.add(v)
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def estate_indices(mol: Molecule) -> np.ndarray:
    n = mol.num_atoms
    I = np.zeros(n)
    for i, atom in enumerate(mol.atoms):
        d = mol.degree(i)
        if d == 0:
            continue
        h = mol.total_h(i)
        dv = periodic.valence_electrons(atom.symbol) - h
        N = periodic.principal_quantum_number(atom.symbol)
        I[i] = ((2.0 / N) ** 2 * dv + 1.0) / d

    dist = topological_distances(mol) + 1.0
    accum = np.zeros(n)
    for i in range(n):
        for j in range(i + 1, n):
            p = dist[i, j]
            if p < 1e6:
                tmp = (I[i] - I[j]) / (p * p)
                accum[i] += tmp
                accum[j] -= tmp
    return accum + I
