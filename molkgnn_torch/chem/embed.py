"""Lightweight 3D coordinate generation for SMILES-derived molecules.

Copied from ``molkgnn_tpu/chem/embed.py``; the port imports nothing of the
JAX package.

Native stand-in for the reference's EmbedMolecule + UFFOptimize step
(wrapper.py:199-203): seeded random initialization followed by gradient
descent on a minimal molecular-mechanics objective —

  * bond springs toward covalent-radius ideal lengths,
  * 1-3 (angle) springs toward the hybridization-ideal geminal distance,
  * soft repulsion between non-bonded pairs.

This produces chemically plausible, non-degenerate 3D geometry (sufficient
for the kernel conv's chirality determinant and the 3D baselines' radial
features); it is NOT a UFF minimum. For publication-grade conformers use the
rdkit backend. Deterministic per (molecule, seed).
"""

from __future__ import annotations

import numpy as np

from molkgnn_torch.chem.mol import Molecule

_RCOV = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Br": 1.20, "I": 1.39,
}
_IDEAL_COS = {"sp3": -1.0 / 3.0, "sp2": -0.5, "sp": -1.0}


def embed_molecule(
    mol: Molecule, seed: int = 42, iterations: int = 300
) -> np.ndarray:
    n = mol.num_atoms
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * max(1.0, n ** (1 / 3))

    # Bond targets
    bsrc = np.array([b.a1 for b in mol.bonds], np.int64)
    bdst = np.array([b.a2 for b in mol.bonds], np.int64)
    blen = np.array(
        [
            (_RCOV.get(mol.atoms[b.a1].symbol, 0.77)
             + _RCOV.get(mol.atoms[b.a2].symbol, 0.77))
            * (1.0 - 0.08 * (b.order - 1.0))
            for b in mol.bonds
        ]
    )

    # Angle (1-3) targets: law of cosines with hybridization-ideal angle.
    asrc, adst, alen = [], [], []
    for j in range(n):
        nbrs = mol.neighbors(j)
        cos_t = _IDEAL_COS.get(mol.hybridization(j), -1.0 / 3.0)
        for ai in range(len(nbrs)):
            for bi in range(ai + 1, len(nbrs)):
                i1, e1 = nbrs[ai]
                i2, e2 = nbrs[bi]
                r1 = (_RCOV.get(mol.atoms[i1].symbol, 0.77)
                      + _RCOV.get(mol.atoms[j].symbol, 0.77))
                r2 = (_RCOV.get(mol.atoms[i2].symbol, 0.77)
                      + _RCOV.get(mol.atoms[j].symbol, 0.77))
                d13 = np.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * cos_t)
                asrc.append(i1)
                adst.append(i2)
                alen.append(d13)
    asrc = np.array(asrc, np.int64)
    adst = np.array(adst, np.int64)
    alen = np.array(alen)

    bonded = set()
    for b in mol.bonds:
        bonded.add((min(b.a1, b.a2), max(b.a1, b.a2)))
    for i1, i2 in zip(asrc, adst):
        bonded.add((min(i1, i2), max(i1, i2)))

    lr = 0.05
    for it in range(iterations):
        grad = np.zeros_like(pos)

        def spring(src, dst, target, k):
            d = pos[src] - pos[dst]
            dist = np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
            f = k * (dist - target[:, None]) * d / dist
            np.add.at(grad, src, f)
            np.add.at(grad, dst, -f)

        if len(bsrc):
            spring(bsrc, bdst, blen, 1.0)
        if len(asrc):
            spring(asrc, adst, alen, 0.3)

        # Soft repulsion for non-bonded pairs (O(n^2), molecules are tiny).
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=-1) + 1e-9
        rep = np.maximum(0.0, 2.0 - dist)
        mask = np.ones((n, n), bool)
        np.fill_diagonal(mask, False)
        for (i1, i2) in bonded:
            mask[i1, i2] = mask[i2, i1] = False
        f = (0.3 * rep * mask / dist)[:, :, None] * diff
        grad -= f.sum(axis=1)

        pos -= lr * grad
        if it == iterations // 2:
            lr *= 0.5
    return (pos - pos.mean(axis=0)).astype(np.float32)


def smiles_to_graph(smiles: str, y: float = 0.0, idx: int = -1, seed: int = 42):
    """SMILES -> embedded, featurized MolGraph (reference smiles2graph,
    wrapper.py:169-206), or None on parse failure."""
    from molkgnn_torch.chem.features import mol_to_graph
    from molkgnn_torch.chem.smiles import parse_smiles

    mol = parse_smiles(smiles, add_hs=True)
    if mol is None:
        return None
    pos = embed_molecule(mol, seed=seed)
    for i, a in enumerate(mol.atoms):
        a.x, a.y, a.z = map(float, pos[i])
    return mol_to_graph(mol, y=y, idx=idx, smiles=smiles)
