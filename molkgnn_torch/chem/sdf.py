"""SDF / MDL molblock (V2000) parser.

Copied from ``molkgnn_tpu/chem/sdf.py``; the port imports nothing of the
JAX package.

Replaces ``Chem.SDMolSupplier`` on the ingest path (reference
wrapper.py:412-414). Handles the counts line, atom block (coords, symbol,
charge code), bond block (order 1-3, aromatic 4), and the property block
(``M  CHG``, ``M  ISO``, ``M  END``); yields one record per ``$$$$``. Data
fields (``>  <name>``) are collected into a dict so label columns can ride
along. Malformed records yield ``None`` (the reference's invalid-molecule
contract, wrapper.py:423-425).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from molkgnn_torch.chem.mol import Atom, Bond, Molecule

_CHARGE_CODE = {0: 0, 1: 3, 2: 2, 3: 1, 4: 0, 5: -1, 6: -2, 7: -3}


def parse_molblock(block: str) -> Optional[Molecule]:
    try:
        lines = block.split("\n")
        counts = lines[3]
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
        atoms: List[Atom] = []
        for i in range(n_atoms):
            ln = lines[4 + i]
            atoms.append(
                Atom(
                    symbol=ln[31:34].strip(),
                    charge=_CHARGE_CODE.get(int(ln[36:39]), 0)
                    if len(ln) >= 39 and ln[36:39].strip()
                    else 0,
                    x=float(ln[0:10]),
                    y=float(ln[10:20]),
                    z=float(ln[20:30]),
                )
            )
        bonds: List[Bond] = []
        for i in range(n_bonds):
            ln = lines[4 + n_atoms + i]
            a1 = int(ln[0:3]) - 1
            a2 = int(ln[3:6]) - 1
            t = int(ln[6:9])
            if not (0 <= a1 < n_atoms and 0 <= a2 < n_atoms) or a1 == a2:
                return None
            order = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}.get(t, 1.0)
            bonds.append(Bond(a1=a1, a2=a2, order=order, aromatic=(t == 4)))
        # Property block overrides charge codes (M  CHG resets all charges).
        saw_chg = False
        for ln in lines[4 + n_atoms + n_bonds :]:
            if ln.startswith("M  END"):
                break
            if ln.startswith("M  CHG"):
                if not saw_chg:
                    for a in atoms:
                        a.charge = 0
                    saw_chg = True
                fields = ln.split()
                k = int(fields[2])
                for j in range(k):
                    idx = int(fields[3 + 2 * j]) - 1
                    atoms[idx].charge = int(fields[4 + 2 * j])
            elif ln.startswith("M  ISO"):
                fields = ln.split()
                k = int(fields[2])
                for j in range(k):
                    idx = int(fields[3 + 2 * j]) - 1
                    atoms[idx].isotope = int(fields[4 + 2 * j])
        mol = Molecule(atoms, bonds)
        mol.perceive()
        return mol
    except (ValueError, IndexError):
        return None


def to_molblock(mol: Molecule, title: str = "") -> str:
    """Serialize a Molecule to a V2000 molblock (writer counterpart)."""
    lines = [title, "  molkgnn", ""]
    lines.append(
        f"{mol.num_atoms:3d}{len(mol.bonds):3d}  0  0  0  0  0  0  0  0999 V2000"
    )
    charged = []
    for i, a in enumerate(mol.atoms):
        lines.append(
            f"{a.x:10.4f}{a.y:10.4f}{a.z:10.4f} {a.symbol:<3s} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
        if a.charge:
            charged.append((i, a.charge))
    for b in mol.bonds:
        t = {1.0: 1, 2.0: 2, 3.0: 3, 1.5: 4}.get(b.order, 1)
        lines.append(f"{b.a1 + 1:3d}{b.a2 + 1:3d}{t:3d}  0")
    for i, chg in charged:
        lines.append(f"M  CHG  1 {i + 1:3d} {chg:3d}")
    lines.append("M  END")
    return "\n".join(lines) + "\n"


def write_sdf(path: str, mols, data_fields=None) -> None:
    """Write molecules (+ optional per-mol data dicts) as an SDF file."""
    with open(path, "w") as f:
        for i, mol in enumerate(mols):
            f.write(to_molblock(mol))
            if data_fields:
                for k, v in data_fields[i].items():
                    f.write(f"> <{k}>\n{v}\n\n")
            f.write("$$$$\n")


def parse_sdf(path: str) -> Iterator[Tuple[Optional[Molecule], Dict[str, str]]]:
    """Yield (molecule_or_None, data_fields) per SDF record."""
    with open(path, "r", errors="replace") as f:
        content = f.read()
    # Line-wise record accumulation: "$$$$" on its own line terminates a
    # record. (String splitting is ambiguous because molblocks may start
    # with an empty title line.)
    records = []
    current: List[str] = []
    for ln in content.split("\n"):
        if ln.strip() == "$$$$":
            records.append("\n".join(current))
            current = []
        else:
            current.append(ln)
    if any(l.strip() for l in current):
        records.append("\n".join(current))
    for record in records:
        if not record.strip():
            continue
        # Split off the data-field section (starts at the first '> <tag>'
        # line after M END).
        data: Dict[str, str] = {}
        if "M  END" in record:
            mol_part, _, rest = record.partition("M  END")
            mol_part += "M  END"
            tag = None
            buf: List[str] = []
            for ln in rest.split("\n"):
                if ln.startswith(">"):
                    if tag is not None:
                        data[tag] = "\n".join(buf).strip()
                    l, r = ln.find("<"), ln.rfind(">")
                    tag = ln[l + 1 : r] if 0 <= l < r else ln[1:].strip()
                    buf = []
                elif tag is not None:
                    buf.append(ln)
            if tag is not None:
                data[tag] = "\n".join(buf).strip()
        else:
            mol_part = record
        yield parse_molblock(mol_part), data
