"""The traffic generator: the same traffic from the same seed, and
molecules with the published means the traffic file was fitted to."""

import numpy as np

from bench_port import files
from bench_port.traffic import make_traffic, random_molecule


def test_molecules_have_the_fitted_means():
    """ogbg-molpcba's 26.0 atoms and 28.1 bonds, the traffic file's
    degree shares, degrees 1-4, bonds in both directions, no self bond
    and no bond twice."""
    m = files.traffic("train-b1024")["molecules"]
    rng = np.random.default_rng(2 ** 31 + 3)
    mols = [random_molecule(rng, m) for _ in range(3000)]
    atoms = np.array([g.x.shape[0] for g in mols])
    bonds = np.array([g.edge_index.shape[1] // 2 for g in mols])
    assert abs(atoms.mean() - 26.0) < 0.3 and abs(bonds.mean() - 28.1) < 0.4
    assert atoms.min() >= m["atoms"][0] and atoms.max() < m["atoms"][1]
    deg = np.concatenate([np.bincount(g.edge_index[0],
                                      minlength=g.x.shape[0]) for g in mols])
    assert deg.min() >= 1 and deg.max() <= 4
    share = np.bincount(deg, minlength=5)[1:] / deg.size
    np.testing.assert_allclose(share, [0.24, 0.38, 0.35, 0.027], atol=0.01)
    for g in mols[:200]:
        src, dst = g.edge_index
        np.testing.assert_array_equal(src[0::2], dst[1::2])
        np.testing.assert_array_equal(g.edge_attr[0::2], g.edge_attr[1::2])
        assert (src != dst).all()
        pairs = {frozenset(p) for p in zip(src[0::2], dst[0::2])}
        assert len(pairs) == src.size // 2


def _small():
    spec = files.traffic("train-b1024")
    spec["molecules"] = dict(spec["molecules"], unique=40)
    spec["entries"] = {"actives": 7, "inactives": 93}
    return spec


def test_same_seed_same_traffic_and_counts():
    spec = _small()
    one, two = make_traffic(spec, 2 ** 31 + 11), \
        make_traffic(spec, 2 ** 31 + 11)
    other = make_traffic(spec, 2 ** 31 + 12)
    np.testing.assert_array_equal(one.mol_of_entry, two.mol_of_entry)
    np.testing.assert_array_equal(one.molecules[5].x, two.molecules[5].x)
    assert not np.array_equal(one.molecules[5].x, other.molecules[5].x)
    assert one.labels.sum() == 7 and len(one.labels) == 100
    assert len(one.split["train"]) == 80 and len(one.split["valid"]) == 10
    assert sorted(np.concatenate(list(one.split.values()))) == list(
        range(100))
    assert set(one.mol_of_entry) == set(range(40))
