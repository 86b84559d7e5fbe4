"""Port parity: the chemistry ingest (``molkgnn_torch/chem``) against the JAX
package's (``molkgnn_tpu/chem``), which it copies.

Every SMILES of ``tests/test_chem_golden.py`` and of the SMILES lists of
``benchmarks/quality_run.py`` goes through both packages. Tolerance: none;
parsing, perception, the native features, the graphs and the seeded 3D
embedding are bit-equal. A molblock written by ``to_molblock`` parses back
to the same atoms and bonds, with coordinates to the 4 decimals it holds.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from molkgnn_torch.chem import embed as t_embed
from molkgnn_torch.chem import features as t_features
from molkgnn_torch.chem import sdf as t_sdf
from molkgnn_torch.chem import smiles as t_smiles
from molkgnn_tpu.chem import embed as j_embed
from molkgnn_tpu.chem import features as j_features
from molkgnn_tpu.chem import smiles as j_smiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(rel):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], os.path.join(ROOT, rel)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smiles():
    golden = _module("tests/test_chem_golden.py")
    quality = _module("benchmarks/quality_run.py")
    out = {"C", "CC", "CF", "CO", "CN", "c1ccccc1"}  # the charge set
    out.update(s for s, *_ in golden.TPSA_GOLDEN)
    out.update(s for s, *_ in golden.CRIPPEN_GOLDEN)
    out.update(s for s, *_ in golden.ESTATE_GOLDEN)
    out.update(golden.PARITY_SMILES)
    for name in ("ACTIVE_SMILES", "INACTIVE_SMILES", "CHIRAL_SMILES"):
        out.update(getattr(quality, name))
    return sorted(out)


SMILES = _smiles()


def _atoms_bonds(mol):
    return ([dataclasses.asdict(a) for a in mol.atoms],
            [dataclasses.asdict(b) for b in mol.bonds])


def _assert_graphs_equal(got, want):
    for name in ("x", "p", "edge_index", "edge_attr", "atomic_num"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.y, got.idx, got.smiles) == (want.y, want.idx, want.smiles)


def test_smiles_cover_both_sources():
    assert len(SMILES) > 40 and "FC(Cl)Br" in SMILES and "CCO" in SMILES


@pytest.mark.parametrize("smi", SMILES)
def test_chemistry_is_bit_equal(smi):
    """parse_smiles (with and without hydrogens), featurize_native,
    mol_to_graph, embed_molecule(seed) and smiles_to_graph give the same
    values in both packages."""
    for add_hs in (False, True):
        t_mol = t_smiles.parse_smiles(smi, add_hs=add_hs)
        j_mol = j_smiles.parse_smiles(smi, add_hs=add_hs)
        assert _atoms_bonds(t_mol) == _atoms_bonds(j_mol)
    for got, want in zip(t_features.featurize_native(t_mol),
                         j_features.featurize_native(j_mol)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for seed in (0, 7):
        np.testing.assert_array_equal(
            t_embed.embed_molecule(t_mol, seed=seed, iterations=60),
            j_embed.embed_molecule(j_mol, seed=seed, iterations=60),
        )
    pos = t_embed.embed_molecule(t_mol, seed=3, iterations=60)
    for mol in (t_mol, j_mol):
        for a, xyz in zip(mol.atoms, pos):
            a.x, a.y, a.z = map(float, xyz)
    _assert_graphs_equal(
        t_features.mol_to_graph(t_mol, y=1.0, idx=4, smiles=smi),
        j_features.mol_to_graph(j_mol, y=1.0, idx=4, smiles=smi),
    )
    _assert_graphs_equal(
        t_embed.smiles_to_graph(smi, y=0.0, idx=2, seed=5),
        j_embed.smiles_to_graph(smi, y=0.0, idx=2, seed=5),
    )


@pytest.mark.parametrize("smi", SMILES)
def test_molblock_round_trip(smi):
    mol = t_smiles.parse_smiles(smi, add_hs=True)
    pos = t_embed.embed_molecule(mol, seed=1, iterations=40)
    for a, xyz in zip(mol.atoms, pos):
        a.x, a.y, a.z = map(float, xyz)
    back = t_sdf.parse_molblock(t_sdf.to_molblock(mol))
    assert back is not None
    assert [(a.symbol, a.charge) for a in back.atoms] == [
        (a.symbol, a.charge) for a in mol.atoms
    ]
    assert [(b.a1, b.a2, b.order) for b in back.bonds] == [
        (b.a1, b.a2, b.order) for b in mol.bonds
    ]
    np.testing.assert_allclose(back.positions(), mol.positions(), atol=5e-5)


def test_malformed_molblock_is_none():
    assert t_sdf.parse_molblock("junk\n\n\n  x  y\nM  END\n") is None
    assert t_smiles.parse_smiles("C1CC(") is None
    assert t_features.mol_to_graph(t_smiles.parse_smiles("[Na+]")) is None
