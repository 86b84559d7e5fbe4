"""Element data tables (public physical constants).

Copied from ``molkgnn_tpu/chem/periodic.py``; the port imports nothing of the
JAX package.

Masses follow the IUPAC standard atomic weights (same source RDKit uses), so
the ``mass`` feature (reference wrapper.py:55 ``atom.GetMass()``) matches.
Valence-electron counts and default valences drive implicit-H assignment and
EState intrinsic states.
"""

from __future__ import annotations

# symbol -> (atomic number, standard atomic weight, valence electrons,
#            default valences tuple, principal quantum number)
ELEMENTS = {
    "H": (1, 1.008, 1, (1,), 1),
    "He": (2, 4.003, 2, (0,), 1),
    "Li": (3, 6.941, 1, (1,), 2),
    "Be": (4, 9.012, 2, (2,), 2),
    "B": (5, 10.811, 3, (3,), 2),
    "C": (6, 12.011, 4, (4,), 2),
    "N": (7, 14.007, 5, (3,), 2),
    "O": (8, 15.999, 6, (2,), 2),
    "F": (9, 18.998, 7, (1,), 2),
    "Ne": (10, 20.180, 8, (0,), 2),
    "Na": (11, 22.990, 1, (1,), 3),
    "Mg": (12, 24.305, 2, (2,), 3),
    "Al": (13, 26.982, 3, (3,), 3),
    "Si": (14, 28.086, 4, (4,), 3),
    "P": (15, 30.974, 5, (3, 5), 3),
    "S": (16, 32.067, 6, (2, 4, 6), 3),
    "Cl": (17, 35.453, 7, (1,), 3),
    "Ar": (18, 39.948, 8, (0,), 3),
    "K": (19, 39.098, 1, (1,), 4),
    "Ca": (20, 40.078, 2, (2,), 4),
    "Zn": (30, 65.39, 2, (2,), 4),
    "Ga": (31, 69.723, 3, (3,), 4),
    "Ge": (32, 72.61, 4, (4,), 4),
    "As": (33, 74.922, 5, (3, 5), 4),
    "Se": (34, 78.96, 6, (2, 4, 6), 4),
    "Br": (35, 79.904, 7, (1,), 4),
    "Kr": (36, 83.80, 8, (0,), 4),
    "Ag": (47, 107.868, 1, (1,), 5),
    "Sn": (50, 118.711, 4, (4,), 5),
    "Sb": (51, 121.760, 5, (3, 5), 5),
    "Te": (52, 127.60, 6, (2, 4, 6), 5),
    "I": (53, 126.904, 7, (1,), 5),
    "Xe": (54, 131.29, 8, (0,), 5),
    "Pt": (78, 195.08, 10, (2, 4), 6),
    "Au": (79, 196.967, 11, (1, 3), 6),
    "Hg": (80, 200.59, 2, (1, 2), 6),
    "Pb": (82, 207.2, 4, (2, 4), 6),
    "Bi": (83, 208.980, 5, (3, 5), 6),
}

SYMBOL_TO_Z = {s: v[0] for s, v in ELEMENTS.items()}
Z_TO_SYMBOL = {v[0]: s for s, v in ELEMENTS.items()}


def atomic_number(symbol: str) -> int:
    return SYMBOL_TO_Z.get(symbol, 0)


def mass(symbol: str) -> float:
    return ELEMENTS.get(symbol, (0, 0.0, 0, (0,), 1))[1]


def valence_electrons(symbol: str) -> int:
    return ELEMENTS.get(symbol, (0, 0.0, 0, (0,), 1))[2]


def default_valences(symbol: str) -> tuple:
    return ELEMENTS.get(symbol, (0, 0.0, 0, (0,), 1))[3]


def principal_quantum_number(symbol: str) -> int:
    return ELEMENTS.get(symbol, (0, 0.0, 0, (0,), 2))[4]
