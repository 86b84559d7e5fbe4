"""Per-atom descriptor contributions: TPSA, Crippen logP/MR, Labute ASA.

Copied from ``molkgnn_tpu/chem/contribs.py``; the port imports nothing of the
JAX package.

These feed four of the 28 node features (reference wrapper.py:71-100 via
RDKit's _CalcTPSAContribs / _CalcCrippenContribs / _CalcLabuteASAContribs).

TPSA follows Ertl, Rohde & Selzer (J. Med. Chem. 2000): published polar
surface contributions for N/O fragment types classified by charge,
aromaticity, attached-H count and bond pattern, with RDKit's linear fallback
for unmatched types. (Default mode: N/O only, matching RDKit's default that
the reference uses.)

Crippen logP/MR follows Wildman & Crippen (JCICS 1999): atom typing here is
a native decision-tree classifier covering the common organic types; exotic
types fall back to the published defaults. When bit-exact RDKit parity is
required, use the rdkit backend in features.py. Labute ASA implements the
approximate-surface-area formula from Labute (J. Mol. Graph. Model. 2000)
with Bondi radii.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from molkgnn_torch.chem.mol import Molecule

# ---------------------------------------------------------------------------
# TPSA (Ertl 2000, Table 1)
# ---------------------------------------------------------------------------


def tpsa_contribs(mol: Molecule) -> np.ndarray:
    out = np.zeros(mol.num_atoms)
    for i, atom in enumerate(mol.atoms):
        sym = atom.symbol
        if sym not in ("N", "O"):
            continue
        chg = atom.charge
        arom = atom.aromatic
        nH = mol.total_h(i)
        # bond pattern to ALL neighbors (heavy + explicit H count as single)
        n_single = n_double = n_triple = n_arom = 0
        for nbr, bi in mol.neighbors(i):
            b = mol.bonds[bi]
            if b.aromatic:
                n_arom += 1
            elif b.order == 1.0:
                n_single += 1
            elif b.order == 2.0:
                n_double += 1
            elif b.order == 3.0:
                n_triple += 1
        n_single += atom.implicit_h
        # Hs are singles; exclude them for the heavy pattern
        nH_explicit = sum(
            1 for j, _ in mol.neighbors(i) if mol.atoms[j].symbol == "H"
        )
        s = n_single - nH_explicit - atom.implicit_h  # heavy single bonds
        in3ring = any(
            len(r) == 3 for r in mol.rings(max_size=3) if i in r
        )

        v = None
        if sym == "N":
            if chg == 0 and not arom:
                if n_triple == 1 and s == 0 and nH == 0:
                    v = 23.79
                elif n_double == 2 and s == 1 and nH == 0:
                    v = 11.68
                elif n_double == 1 and n_triple == 1 and nH == 0:
                    v = 13.60
                elif n_double == 1 and s == 1 and nH == 0:
                    v = 12.36
                elif s == 3 and nH == 0:
                    v = 3.01 if in3ring else 3.24
                elif n_double == 1 and nH == 1:
                    v = 23.85
                elif s == 2 and nH == 1:
                    v = 21.94 if in3ring else 12.03
                elif s == 1 and nH == 2:
                    v = 26.02
            elif chg == 1 and not arom:
                if s == 4 and nH == 0:
                    v = 0.00
                elif n_double == 1 and s == 2 and nH == 0:
                    v = 3.01
                elif n_triple == 1 and s == 1 and nH == 0:
                    v = 4.36
                elif s == 3 and nH == 1:
                    v = 4.44
                elif n_double == 1 and s == 1 and nH == 1:
                    v = 13.97
                elif s == 2 and nH == 2:
                    v = 16.61
                elif n_double == 1 and nH == 2:
                    v = 25.59
                elif s == 1 and nH == 3:
                    v = 27.64
            elif arom:
                if chg == 0:
                    if n_arom == 2 and s == 0 and nH == 0:
                        v = 12.89
                    elif n_arom == 3 and nH == 0:
                        v = 4.41
                    elif n_arom == 2 and s == 1 and nH == 0:
                        v = 4.93
                    elif n_arom == 2 and n_double == 1 and nH == 0:
                        v = 8.39
                    elif n_arom == 2 and nH == 1:
                        v = 15.79
                elif chg == 1:
                    if n_arom == 3 and nH == 0:
                        v = 4.10
                    elif n_arom == 2 and s == 1 and nH == 0:
                        v = 3.88
                    elif n_arom == 2 and nH == 1:
                        v = 14.14
            if v is None:  # RDKit fallback
                deg = s + n_double + n_triple + n_arom + nH
                v = max(0.0, 30.5 - deg * 8.2 + nH * 1.5)
        else:  # O
            if arom and n_arom == 2 and chg == 0:
                v = 13.14
            elif chg == 0:
                if n_double == 1 and s == 0 and nH == 0:
                    v = 17.07
                elif s == 2 and nH == 0:
                    v = 12.53 if in3ring else 9.23
                elif s == 1 and nH == 1:
                    v = 20.23
            elif chg == -1 and s == 1 and nH == 0:
                v = 23.06
            if v is None:
                deg = s + n_double + n_triple + n_arom + nH
                v = max(0.0, 28.5 - deg * 8.6 + nH * 1.5)
        out[i] = v
    return out


# ---------------------------------------------------------------------------
# Crippen logP / MR (Wildman & Crippen 1999) — native decision-tree typing
# ---------------------------------------------------------------------------

# (logP, MR) for the types our classifier emits (published Table 1 values).
_CRIPPEN = {
    "C1": (0.1441, 2.503),   # sp3 C bonded only to C/H
    "C2": (0.0000, 2.433),   # sp3 C, secondary/tertiary to C/H (merged C1/C2 use)
    "C3": (-0.2035, 2.753),  # sp3 C attached to heteroatom
    "C4": (-0.2051, 2.731),  # sp3 C attached to >=2 heteroatoms
    "C5": (-0.2783, 5.007),  # C = heteroatom
    "C6": (0.1551, 3.513),   # sp2 C (vinyl/alkene)
    "C8": (0.08452, 2.464),  # aromatic C-H... (approximate grouping)
    "C18": (0.1581, 3.350),  # aromatic CH
    "C21": (0.1360, 3.904),  # aromatic C attached to C
    "C22": (0.4619, 4.100),  # aromatic C attached to N
    "C23": (0.5437, 3.928),  # aromatic C attached to O
    "C24": (0.1893, 4.183),  # aromatic C attached to S/halogen
    "C27": (0.2640, 4.261),  # exotic C
    "CS": (0.08129, 3.243),  # fallback C
    "H1": (0.1230, 1.057),   # H attached to C
    "H2": (-0.2677, 1.395),  # H attached to N/O (alcohol/amine)
    "H3": (0.2142, 0.9627),  # H attached to else
    "HS": (0.1125, 1.112),
    "N1": (-1.0190, 2.262),  # amine NH2
    "N2": (-0.7096, 2.173),  # secondary amine
    "N7": (-0.3187, 2.819),  # tertiary amine
    "N11": (-0.3239, 2.202), # aromatic N
    "N12": (-1.1190, 3.359), # protonated N
    "N13": (-0.3396, 0.2604),# quaternary N+
    "NS": (-0.4806, 2.134),
    "O1": (0.1552, 1.080),   # aromatic O
    "O2": (-0.2893, 0.8238), # alcohol/ether O
    "O8": (0.1129, 1.085),   # aromatic O (furan)
    "O9": (-0.1526, 0.0),    # oxide
    "O10": (0.0000, 0.2215), # carbonyl-adjacent
    "O11": (0.4833, 0.389),  # carboxylate-ish
    "O12": (-1.3260, 0.0),   # O- acid
    "O3": (-0.0684, 1.085),  # C=O
    "OS": (-0.1188, 0.6865),
    "F": (0.4202, 1.108),
    "Cl": (0.6895, 5.853),
    "Br": (0.8456, 8.927),
    "I": (0.8857, 14.02),
    "S1": (0.6482, 7.591),
    "S2": (-0.0024, 7.365),
    "S3": (0.6237, 6.691),
    "P": (0.8612, 6.920),
    "Me1": (-0.3808, 5.754), # metals / others
}


def _crippen_type(mol: Molecule, i: int) -> str:
    atom = mol.atoms[i]
    sym = atom.symbol
    if sym == "H":
        nbr = mol.neighbors(i)
        if nbr:
            ns = mol.atoms[nbr[0][0]].symbol
            if ns == "C":
                return "H1"
            if ns in ("N", "O"):
                return "H2"
            return "H3"
        return "HS"
    if sym == "C":
        het = sum(
            1
            for j, _ in mol.neighbors(i)
            if mol.atoms[j].symbol not in ("C", "H")
        )
        if atom.aromatic:
            # Non-aromatic-bond substituents, H excluded: an explicit H
            # neighbor must not push [cH] (C18) into the C21..C24 branches.
            arom_nbr_syms = [
                mol.atoms[j].symbol
                for j, bi in mol.neighbors(i)
                if not mol.bonds[bi].aromatic
                and mol.atoms[j].symbol != "H"
            ]
            if not arom_nbr_syms and mol.total_h(i) > 0:
                return "C18"
            if "N" in arom_nbr_syms:
                return "C22"
            if "O" in arom_nbr_syms:
                return "C23"
            if any(s in ("S", "F", "Cl", "Br", "I") for s in arom_nbr_syms):
                return "C24"
            return "C21"
        hyb = mol.hybridization(i)
        if hyb == "sp3":
            if het == 0:
                return "C1"
            return "C3" if het == 1 else "C4"
        if hyb in ("sp2", "sp"):
            dbl_het = any(
                mol.bonds[bi].order >= 2.0
                and mol.atoms[j].symbol not in ("C", "H")
                for j, bi in mol.neighbors(i)
            )
            return "C5" if dbl_het else "C6"
        return "CS"
    if sym == "N":
        if atom.aromatic:
            return "N11"
        if atom.charge > 0:
            return "N13" if mol.total_h(i) == 0 else "N12"
        h = mol.total_h(i)
        if h >= 2:
            return "N1"
        if h == 1:
            return "N2"
        return "N7"
    if sym == "O":
        if atom.aromatic:
            return "O8"
        if atom.charge < 0:
            return "O12"
        dbl = any(
            mol.bonds[bi].order == 2.0 for _, bi in mol.neighbors(i)
        )
        if dbl:
            return "O3"
        if mol.total_h(i) >= 1 or mol.degree(i) + atom.implicit_h >= 1:
            return "O2"
        return "OS"
    if sym in ("F", "Cl", "Br", "I", "P"):
        return sym
    if sym == "S":
        if atom.aromatic:
            return "S3"
        return "S1" if atom.charge == 0 else "S2"
    return "Me1"


def crippen_contribs(mol: Molecule) -> Tuple[np.ndarray, np.ndarray]:
    logp = np.zeros(mol.num_atoms)
    mr = np.zeros(mol.num_atoms)
    for i in range(mol.num_atoms):
        lp, m = _CRIPPEN[_crippen_type(mol, i)]
        logp[i], mr[i] = lp, m
    return logp, mr


# ---------------------------------------------------------------------------
# Labute approximate surface area (Labute 2000)
# ---------------------------------------------------------------------------

_BONDI = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47, "Si": 2.10,
    "P": 1.80, "S": 1.80, "Cl": 1.75, "Br": 1.85, "I": 1.98,
}
_RCOV = {
    "H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57, "Si": 1.11,
    "P": 1.07, "S": 1.05, "Cl": 1.02, "Br": 1.20, "I": 1.39,
}


def labute_asa_contribs(mol: Molecule) -> np.ndarray:
    """Per-atom approximate accessible surface area (Å²). Implicit Hs fold
    into their heavy atom (RDKit convention for _CalcLabuteASAContribs)."""
    n = mol.num_atoms
    out = np.zeros(n)
    for i, atom in enumerate(mol.atoms):
        ri = _BONDI.get(atom.symbol, 1.7)
        area = 4.0 * math.pi * ri * ri
        partners = []
        for j, bi in mol.neighbors(i):
            partners.append((mol.atoms[j].symbol, mol.bonds[bi].order))
        for _ in range(atom.implicit_h):
            partners.append(("H", 1.0))
        for sym_j, order in partners:
            rj = _BONDI.get(sym_j, 1.7)
            # Ideal bond length shortened by bond order (Labute's eq 2-3).
            d = _RCOV.get(atom.symbol, 0.77) + _RCOV.get(sym_j, 0.77)
            d -= 0.1 * (order - 1.0) if order > 1.0 else 0.0
            d = min(max(abs(ri - rj), d), ri + rj)
            # Spherical-cap overlap removed from atom i's sphere.
            cap = 2.0 * math.pi * ri * (
                ri - d / 2.0 - (ri * ri - rj * rj) / (2.0 * d)
            )
            area -= max(cap, 0.0)
        out[i] = max(area, 0.0)
    return out
