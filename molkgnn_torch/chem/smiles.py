"""SMILES parser + lightweight 3D embedding.

Copied from ``molkgnn_tpu/chem/smiles.py``; the port imports nothing of the
JAX package.

Native replacement for the reference's SMILES ingest path
(``smiles2graph``, reference wrapper.py:169-206: MolFromSmiles ->
AddHs -> EmbedMolecule -> UFFOptimize). The parser covers the organic
subset, bracket atoms (isotope, symbol, H-count, charge), bonds ``- = # :``,
branches, ring closures (incl. ``%nn``), and aromatic lowercase atoms;
stereo markers (``/ \\ @ @@``) are accepted and ignored (documented
deviation — chirality in this framework flows from 3D coordinates, which
SDF data provides; see chem/embed.py for the generated-coordinate path).

``parse_smiles`` also applies the reference's SMILES clean-ups:
``/=``->``=``, ``\\=``->``=`` and the pattern_dict substitutions
(wrapper.py:20-33, 174-190).
"""

from __future__ import annotations

from typing import List, Optional

from molkgnn_torch.chem.mol import Atom, Bond, Molecule

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_OK = {"b", "c", "n", "o", "p", "s"}
_PATTERN_DICT = {"[NH-]": "[N-]", "[OH2+]": "[O]"}

_DEFAULT_VALENCE = {
    "B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
    "F": 1, "Cl": 1, "Br": 1, "I": 1, "H": 1,
}


class SmilesError(ValueError):
    pass


def smiles_cleaner(smiles: str) -> str:
    """The reference's SMILES clean-ups (wrapper.py:20-33)."""
    out = smiles
    for pattern, replacement in _PATTERN_DICT.items():
        if pattern in out:
            out = out.replace(pattern, replacement)
    return out


def parse_smiles(smiles: str, add_hs: bool = True) -> Optional[Molecule]:
    smiles = smiles.replace(r"/=", "=").replace(r"\=", "=")
    try:
        mol = _parse(smiles)
    except SmilesError:
        try:
            mol = _parse(smiles_cleaner(smiles))
        except SmilesError:
            return None
    if mol is None:
        return None
    mol.perceive()
    if add_hs:
        mol = _add_explicit_hs(mol)
        mol.perceive()
    return mol


def _parse(s: str) -> Molecule:
    atoms: List[Atom] = []
    arom_flags: List[bool] = []
    explicit_h: List[Optional[int]] = []
    bonds: List[Bond] = []
    stack: List[int] = []
    prev: Optional[int] = None
    pending_bond: Optional[str] = None
    ring_open = {}

    i = 0
    n = len(s)

    def add_atom(symbol: str, aromatic: bool, charge=0, hcount=None):
        nonlocal prev, pending_bond
        atoms.append(Atom(symbol=symbol, charge=charge))
        arom_flags.append(aromatic)
        explicit_h.append(hcount)
        idx = len(atoms) - 1
        if prev is not None:
            _add_bond(prev, idx, pending_bond, aromatic and arom_flags[prev])
        pending_bond = None
        prev = idx

    def _add_bond(a, b, bond_char, both_aromatic):
        if bond_char == "=":
            order, arom = 2.0, False
        elif bond_char == "#":
            order, arom = 3.0, False
        elif bond_char == ":":
            order, arom = 1.5, True
        elif bond_char is None and both_aromatic:
            order, arom = 1.5, True
        else:
            order, arom = 1.0, False
        bonds.append(Bond(a1=a, a2=b, order=order, aromatic=arom))

    while i < n:
        ch = s[i]
        if ch in "-=#:":
            pending_bond = ch if ch != "-" else None
            i += 1
        elif ch in "/\\":
            i += 1  # cis/trans markers ignored
        elif ch == "(":
            if prev is None:
                raise SmilesError("branch before any atom")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unbalanced )")
            prev = stack.pop()
            i += 1
        elif ch == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesError("unclosed bracket")
            sym, arom, chg, hc = _parse_bracket(s[i + 1 : j])
            add_atom(sym, arom, chg, hc)
            i = j + 1
        elif ch == "%":
            num = s[i + 1 : i + 3]
            if not num.isdigit():
                raise SmilesError("bad %ring")
            _ring(ring_open, int(num), prev, pending_bond, bonds, arom_flags)
            pending_bond = None
            i += 3
        elif ch.isdigit():
            _ring(ring_open, int(ch), prev, pending_bond, bonds, arom_flags)
            pending_bond = None
            i += 1
        elif ch.isalpha():
            two = s[i : i + 2]
            if two in ("Cl", "Br"):
                add_atom(two, False)
                i += 2
            elif ch in _AROMATIC_OK:
                add_atom(ch.upper(), True)
                i += 1
            elif ch.isupper() and ch in "BCNOPSFI":
                add_atom(ch, False)
                i += 1
            else:
                raise SmilesError(f"unknown atom at {i}: {ch}")
        elif ch == ".":
            prev = None
            pending_bond = None
            i += 1
        else:
            raise SmilesError(f"unexpected char {ch!r}")

    if ring_open:
        raise SmilesError("unclosed ring bond")
    if stack:
        raise SmilesError("unbalanced (")
    if not atoms:
        return None

    mol = Molecule(atoms, bonds)
    # Aromatic flags from lowercase notation.
    for idx, flag in enumerate(arom_flags):
        if flag:
            atoms[idx].aromatic = True
    # Explicit bracket H counts are authoritative; stash for _add_explicit_hs
    mol._bracket_h = explicit_h  # type: ignore[attr-defined]
    return mol


def _ring(ring_open, num, prev, pending_bond, bonds, arom_flags):
    if prev is None:
        raise SmilesError("ring digit before atom")
    if num in ring_open:
        a, bond_char = ring_open.pop(num)
        bc = bond_char or pending_bond
        both_arom = arom_flags[a] and arom_flags[prev]
        if bc == "=":
            order, arom = 2.0, False
        elif bc == "#":
            order, arom = 3.0, False
        elif bc == ":" or (bc is None and both_arom):
            order, arom = 1.5, True
        else:
            order, arom = 1.0, False
        bonds.append(Bond(a1=a, a2=prev, order=order, aromatic=arom))
    else:
        ring_open[num] = (prev, pending_bond)


def _parse_bracket(body: str):
    i = 0
    # isotope
    while i < len(body) and body[i].isdigit():
        i += 1
    rest = body[i:]
    if not rest:
        raise SmilesError("empty bracket atom")
    if rest[:2] in ("Cl", "Br") or (
        len(rest) >= 2 and rest[0].isupper() and rest[1].islower()
        and rest[:2] not in ("CH", "NH", "OH", "SH", "PH", "BH", "IH")
    ):
        sym, rest = rest[:2], rest[2:]
        arom = False
    else:
        sym, rest = rest[0], rest[1:]
        arom = sym.islower()
        sym = sym.upper() if arom else sym
    # chirality markers
    while rest.startswith("@"):
        rest = rest[1:]
    hcount = 0
    if rest.startswith("H"):
        rest = rest[1:]
        if rest and rest[0].isdigit():
            hcount = int(rest[0])
            rest = rest[1:]
        else:
            hcount = 1
    charge = 0
    while rest:
        if rest[0] == "+":
            charge += 1
            rest = rest[1:]
            if rest and rest[0].isdigit():
                charge = int(rest[0])
                rest = rest[1:]
        elif rest[0] == "-":
            charge -= 1
            rest = rest[1:]
            if rest and rest[0].isdigit():
                charge = -int(rest[0])
                rest = rest[1:]
        elif rest[0].isdigit() or rest[0] == ":":
            rest = rest[1:]  # atom class
        else:
            raise SmilesError(f"bad bracket tail {rest!r}")
    return sym, arom, charge, hcount


def _add_explicit_hs(mol: Molecule) -> Molecule:
    """Materialize implicit hydrogens as explicit atoms (AddHs analogue).
    Bracket-specified H counts override perceived implicit counts."""
    bracket_h = getattr(mol, "_bracket_h", [None] * mol.num_atoms)
    atoms = list(mol.atoms)
    bonds = list(mol.bonds)
    for i in range(mol.num_atoms):
        nh = bracket_h[i] if bracket_h[i] is not None else mol.atoms[i].implicit_h
        for _ in range(nh):
            atoms.append(Atom(symbol="H"))
            bonds.append(Bond(a1=i, a2=len(atoms) - 1, order=1.0))
        atoms[i].implicit_h = 0
    return Molecule(atoms, bonds)
