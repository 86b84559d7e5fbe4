"""Molecule container + perception (rings, aromaticity, implicit H,
hybridization).

Copied from ``molkgnn_tpu/chem/mol.py``; the port imports nothing of the
JAX package.

Perception rules follow the standard conventions the reference relies on via
RDKit:

  * rings: smallest-set-of-smallest-rings via BFS per-edge shortest cycles;
  * aromaticity: SDF bond type 4 is taken as authoritative when present;
    otherwise simple Hückel perception on planar rings of sp2 atoms
    (sufficient for the benzene/pyridine/thiophene-class rings in QSAR data);
  * implicit hydrogens: default valence minus explicit bond-order sum,
    adjusted by formal charge;
  * hybridization: from σ-bond count + lone pairs (needed for Gasteiger).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from molkgnn_torch.chem import periodic


@dataclasses.dataclass
class Atom:
    symbol: str
    charge: int = 0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    isotope: int = 0
    # perception results
    implicit_h: int = 0
    aromatic: bool = False
    in_ring: bool = False


@dataclasses.dataclass
class Bond:
    a1: int
    a2: int
    order: float  # 1.0, 1.5 (aromatic), 2.0, 3.0
    aromatic: bool = False
    in_ring: bool = False


class Molecule:
    def __init__(self, atoms: List[Atom], bonds: List[Bond]):
        self.atoms = atoms
        self.bonds = bonds
        self._neighbors: Optional[List[List[Tuple[int, int]]]] = None

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[Tuple[int, int]]:
        """List of (neighbor atom idx, bond idx)."""
        if self._neighbors is None:
            nb: List[List[Tuple[int, int]]] = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                nb[b.a1].append((b.a2, bi))
                nb[b.a2].append((b.a1, bi))
            self._neighbors = nb
        return self._neighbors[i]

    def degree(self, i: int) -> int:
        return len(self.neighbors(i))

    # ------------------------------------------------------------------
    # Perception
    # ------------------------------------------------------------------
    def perceive(self) -> "Molecule":
        self._perceive_rings()
        self._perceive_aromaticity()
        self._assign_implicit_h()
        return self

    def _perceive_rings(self):
        """Mark ring membership: an edge is in a ring iff removing it leaves
        its endpoints connected (cycle edge); atoms inherit from edges."""
        n = self.num_atoms
        for bi, b in enumerate(self.bonds):
            if self._connected_without(b.a1, b.a2, bi):
                b.in_ring = True
                self.atoms[b.a1].in_ring = True
                self.atoms[b.a2].in_ring = True

    def _connected_without(self, src: int, dst: int, skip_bond: int) -> bool:
        seen = {src}
        stack = [src]
        while stack:
            u = stack.pop()
            if u == dst:
                return True
            for v, bi in self.neighbors(u):
                if bi == skip_bond or v in seen:
                    continue
                seen.add(v)
                stack.append(v)
        return False

    def rings(self, max_size: int = 8) -> List[List[int]]:
        """Enumerate simple rings up to ``max_size`` (per-bond shortest cycle)."""
        out = []
        seen = set()
        for bi, b in enumerate(self.bonds):
            cyc = self._shortest_cycle_through(bi, max_size)
            if cyc is None:
                continue
            key = frozenset(cyc)
            if key not in seen:
                seen.add(key)
                out.append(cyc)
        return out

    def _shortest_cycle_through(self, bond_idx: int, max_size: int):
        b = self.bonds[bond_idx]
        # BFS from a1 to a2 avoiding the bond itself.
        from collections import deque

        prev = {b.a1: None}
        q = deque([b.a1])
        while q:
            u = q.popleft()
            if u == b.a2:
                path = []
                while u is not None:
                    path.append(u)
                    u = prev[u]
                return path if len(path) <= max_size else None
            for v, bi in self.neighbors(u):
                if bi == bond_idx or v in prev:
                    continue
                prev[v] = u
                q.append(v)
        return None

    def _perceive_aromaticity(self):
        """SDF type-4 bonds are authoritative; otherwise apply Hückel 4n+2 to
        candidate rings of sp2-capable atoms with alternating unsaturation."""
        if any(b.aromatic for b in self.bonds):
            for b in self.bonds:
                if b.aromatic:
                    b.order = 1.5
                    self.atoms[b.a1].aromatic = True
                    self.atoms[b.a2].aromatic = True
            return

        for ring in self.rings(max_size=7):
            if len(ring) < 5:
                continue
            pi = 0
            ok = True
            ring_set = set(ring)
            for a in ring:
                atom = self.atoms[a]
                sym = atom.symbol
                if sym not in ("C", "N", "O", "S", "P"):
                    ok = False
                    break
                has_double = any(
                    self.bonds[bi].order == 2.0 for _, bi in self.neighbors(a)
                )
                if has_double:
                    pi += 1
                elif sym in ("N", "O", "S") :
                    pi += 2  # lone-pair donor
                else:
                    ok = False
                    break
            if ok and pi % 4 == 2:
                for a in ring:
                    self.atoms[a].aromatic = True
                for bi, b in enumerate(self.bonds):
                    if b.a1 in ring_set and b.a2 in ring_set and b.in_ring:
                        b.aromatic = True
                        b.order = 1.5

    def _assign_implicit_h(self):
        for i, atom in enumerate(self.atoms):
            bond_sum = 0.0
            for _, bi in self.neighbors(i):
                bond_sum += self.bonds[bi].order
            # Aromatic N contributes differently; round up half-orders.
            explicit = int(np.ceil(bond_sum - 1e-9))
            valences = periodic.default_valences(atom.symbol)
            target = None
            for v in valences:
                adj = v + (atom.charge if atom.symbol in ("N", "P") else 0)
                adj = v - abs(atom.charge) if atom.symbol in ("C",) and atom.charge else adj
                if atom.symbol in ("O", "S") and atom.charge:
                    adj = v + atom.charge
                if explicit <= adj:
                    target = adj
                    break
            if target is None:
                target = explicit
            atom.implicit_h = max(0, int(target - explicit))

    # ------------------------------------------------------------------
    def explicit_valence(self, i: int) -> float:
        """Sum of bond orders (RDKit GetExplicitValence counts aromatic as
        1.5 and rounds the total; reference feature wrapper.py:54)."""
        total = 0.0
        for _, bi in self.neighbors(i):
            total += self.bonds[bi].order
        return int(total + 0.5)

    def total_h(self, i: int) -> int:
        explicit_h = sum(
            1 for j, _ in self.neighbors(i) if self.atoms[j].symbol == "H"
        )
        return explicit_h + self.atoms[i].implicit_h

    def sigma_bonds(self, i: int) -> int:
        return self.degree(i) + self.atoms[i].implicit_h

    def hybridization(self, i: int) -> str:
        """'sp3' | 'sp2' | 'sp' from unsaturation (for Gasteiger params)."""
        atom = self.atoms[i]
        if atom.aromatic:
            return "sp2"
        n_double = sum(
            1 for _, bi in self.neighbors(i) if self.bonds[bi].order == 2.0
        )
        n_triple = sum(
            1 for _, bi in self.neighbors(i) if self.bonds[bi].order == 3.0
        )
        if n_triple or n_double >= 2:
            return "sp"
        if n_double == 1:
            return "sp2"
        return "sp3"

    def positions(self) -> np.ndarray:
        return np.array(
            [[a.x, a.y, a.z] for a in self.atoms], dtype=np.float32
        )
