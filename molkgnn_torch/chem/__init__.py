"""Host-side chemistry ingest: parsers, perception, featurization.

Numpy copy of ``molkgnn_tpu/chem`` (the modules the kgnn ingest needs:
``periodic``, ``mol``, ``sdf``, ``smiles``, ``gasteiger``, ``estate``,
``contribs``, ``features``, ``embed``), bit-equal to it: SDF/SMILES parsing,
ring/aromaticity perception, Gasteiger (PEOE) charges, EState indices,
TPSA / Crippen / Labute-ASA contributions and a seeded 3D embedding, plus
the optional RDKit backend (``features.mol_to_graph(backend="rdkit")``,
imported only when asked for). Everything here runs on the host at ingest
time; nothing is a device op.
"""

from molkgnn_torch.chem.features import EDGE_DIM, NODE_DIM, mol_to_graph
from molkgnn_torch.chem.mol import Atom, Bond, Molecule
from molkgnn_torch.chem.sdf import parse_molblock, parse_sdf

__all__ = [
    "parse_sdf",
    "parse_molblock",
    "Molecule",
    "Atom",
    "Bond",
    "mol_to_graph",
    "NODE_DIM",
    "EDGE_DIM",
]
