"""Port parity: point-cloud geometry, batches, the device gather, the
segment minimum and the DimeNet++/SphereNet bases, on the CPU.

The same molecules (made from a seed with numpy, at most 12 atoms, with a
single-atom molecule and one whose atoms lie beyond the cutoff) go through
``molkgnn_tpu.graphs.geometric`` and ``molkgnn_torch.graphs.geometric``:
edges, triplets, torsion candidates, specs and packed batches are equal bit
for bit, and ``gather_points`` equals ``batch_points``. The bases are held
against the JAX package's sympy forms in float64 within 1e-9 over
x = d / cutoff in [0.1, 1].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs import geometric as t_geo
from molkgnn_torch.graphs.device_pack import pad_ids
from molkgnn_torch.graphs.device_points import (
    DevicePointDataset,
    gather_points,
)
from molkgnn_torch.graphs.molgraph import MolGraph
from molkgnn_torch.models import spherenet as t_sphere
from molkgnn_torch.ops import basis as t_basis
from molkgnn_torch.ops.segment import segment_min
from molkgnn_tpu.graphs import geometric as j_geo
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import spherenet as j_sphere
from molkgnn_tpu.ops import basis as j_basis

CUTOFF = 3.5
GEOMETRY = {
    "radius": {},
    "triplets": {"with_triplets": True},
    "torsion": {"with_torsion": True},
}


def _point_graph(pos, z, y=0.0):
    n = len(z)
    return MolGraph(
        x=np.zeros((n, 28), np.float32), p=np.asarray(pos, np.float32),
        edge_index=np.zeros((2, 0), np.int32),
        edge_attr=np.zeros((0, 7), np.float32), y=y,
        atomic_num=np.asarray(z, np.int32),
    )


def molecules():
    """14 random molecules cut to at most 12 atoms, a single atom, and two
    atoms farther apart than the cutoff."""
    out = []
    for g in random_dataset(seed=5, num_graphs=14):
        n = min(g.num_nodes, 12)
        out.append(_point_graph(g.p[:n], g.atomic_num[:n], g.y))
    out.append(_point_graph([[0.0, 0.0, 0.0]], [6], 1.0))
    out.append(_point_graph([[0.0, 0.0, 0.0], [0.0, 0.0, 9.0]], [6, 8]))
    return out


def _jax(g):
    return JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                     edge_attr=g.edge_attr, y=g.y, atomic_num=g.atomic_num)


@pytest.fixture(scope="module")
def mols():
    graphs = molecules()
    return graphs, [_jax(g) for g in graphs]


@pytest.mark.parametrize("cutoff", [1.5, CUTOFF, 10.0])
def test_geometry_matches_jax(mols, cutoff):
    """Edges, triplets and torsion candidates, in the JAX loops' order."""
    for g, jg in zip(*mols):
        e = t_geo.radius_edges(g.p, cutoff)
        np.testing.assert_array_equal(e, j_geo.radius_edges(jg.p, cutoff))
        t = t_geo.triplet_index(e, g.num_nodes)
        jt = j_geo.triplet_index(e, g.num_nodes)
        assert t.shape == jt.shape and t.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        q = t_geo.torsion_pairs(e, t, g.num_nodes)
        jq = j_geo.torsion_pairs(e, jt, g.num_nodes)
        assert q.shape == jq.shape and q.dtype == np.int32
        np.testing.assert_array_equal(q, jq)


def test_molecule_geometry_is_cached(mols):
    g = mols[0][0]
    first = t_geo.molecule_geometry(g, CUTOFF, True, True)
    assert t_geo.molecule_geometry(g, CUTOFF, True, True) is first
    assert t_geo.molecule_geometry(g, CUTOFF, False, False) is not first


def _leaves_equal(batch, jbatch):
    for got, f in zip(batch.leaves(), dataclasses.fields(jbatch)):
        want = np.asarray(getattr(jbatch, f.name))
        assert got.numpy().dtype == want.dtype, f.name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
def test_spec_and_batch_points_match_jax(mols, geometry):
    graphs, jgraphs = mols
    kw = GEOMETRY[geometry]
    spec = t_geo.point_spec_for_graphs(graphs, 5, CUTOFF, **kw)
    jspec = j_geo.point_spec_for_graphs(jgraphs, 5, CUTOFF, **kw)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    for ids in ([0, 1, 2, 3, 4], [14, 15, 6], [15]):
        _leaves_equal(t_geo.batch_points([graphs[i] for i in ids], spec),
                      j_geo.batch_points([jgraphs[i] for i in ids], jspec))


def test_batch_points_refuses_overflow(mols):
    graphs = mols[0]
    spec = t_geo.point_spec_for_graphs(graphs[:2], 2, CUTOFF)
    big = sorted(graphs, key=lambda g: -g.num_nodes)[:2]
    with pytest.raises(ValueError, match="capacity"):
        t_geo.batch_points(big, dataclasses.replace(spec, num_nodes=8))
    with pytest.raises(ValueError, match="spec.num_graphs"):
        t_geo.batch_points(graphs[:3], spec)


@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
def test_gather_points_matches_batch_points(mols, geometry):
    """The device assembly equals the host packer bit for bit, -1 padded
    ids and an all-padding batch included."""
    graphs = mols[0]
    spec = t_geo.point_spec_for_graphs(graphs, 5, CUTOFF, **GEOMETRY[geometry])
    data = DevicePointDataset.from_graphs(graphs, spec)
    for ids in ([0, 1, 2, 3, 4], [15, 14, 9], [], [7]):
        idv = torch.as_tensor(pad_ids(np.asarray(ids, np.int32), 5))
        got = gather_points(data, idv, spec)
        want = t_geo.batch_points([graphs[i] for i in ids], spec)
        for a, b, f in zip(got.leaves(), want.leaves(),
                           dataclasses.fields(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_gather_points_with_no_edge_in_the_dataset(mols):
    """A dataset with no radius edge at all (empty flat arrays): the gather
    gives the all-padding levels the host packer gives."""
    graphs = [g for g in mols[0] if g.num_nodes <= 2]
    spec = t_geo.point_spec_for_graphs(graphs, 2, 0.5, with_torsion=True)
    data = DevicePointDataset.from_graphs(graphs, spec)
    assert data.edge_local.shape == (0, 2) and data.quad_local.shape == (0, 2)
    got = gather_points(data, torch.tensor([1, 0], dtype=torch.int32), spec)
    want = t_geo.batch_points([graphs[1], graphs[0]], spec)
    for a, b in zip(got.leaves(), want.leaves()):
        assert torch.equal(a, b)


def test_segment_min_matches_jax():
    """Least value per segment, exact; an empty segment holds inf."""
    rng = np.random.default_rng(0)
    values = rng.standard_normal(40).astype(np.float32)
    values[::7] = np.inf
    ids = rng.integers(0, 12, 40).astype(np.int32)
    ids[ids == 5] = 6  # segment 5 is empty
    got = segment_min(torch.tensor(values), torch.tensor(ids), 12).numpy()
    want = np.asarray(jax.ops.segment_min(jnp.asarray(values),
                                          jnp.asarray(ids), 12))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[5])


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


S, R = 4, 4
X = np.linspace(0.1, 1.0, 91)
THETA = np.linspace(0.0, np.pi, 91)
PHI = np.linspace(0.05, 2 * np.pi, 91)


def _basis_case(name):
    """(port value, JAX value) of one basis in float64."""
    x, th, ph = (torch.tensor(a) for a in (X, THETA, PHI))
    d = x * CUTOFF
    if name == "bessel_basis":
        fns = j_basis.bessel_basis_fns(S, R)
        want = np.stack([np.stack([np.asarray(fns[l][r](jnp.asarray(X)))
                                   for r in range(R)], -1)
                         for l in range(S)], -2)
        return t_basis.bessel_basis(x, S, R), want
    if name == "real_sph_harm":
        want = np.stack([np.asarray(f(jnp.asarray(THETA)))
                         for f in j_basis.real_sph_harm_fns(S)], -1)
        return t_basis.real_sph_harm(th, S), want
    if name == "sph_harm_m":
        mf = j_basis.real_sph_harm_m_fns(S)
        f = t_basis.sph_harm_factors(th, S)
        got = [f[l][m] * torch.cos(m * ph) if m else f[l][0]
               for l in range(S) for m in range(l + 1)]
        want = [np.asarray(mf[l][m](jnp.asarray(THETA), jnp.asarray(PHI)))
                for l in range(S) for m in range(l + 1)]
        return torch.stack(got, -1), np.stack(want, -1)
    if name == "bessel_rbf":
        freq = np.arange(1, R + 1) * np.pi
        return (t_basis.bessel_rbf(d, torch.tensor(freq), CUTOFF),
                j_basis.bessel_rbf(jnp.asarray(d.numpy()),
                                   jnp.asarray(freq), CUTOFF))
    if name == "spherical_sbf":
        return (t_basis.spherical_sbf(d, th, S, R, CUTOFF),
                j_basis.spherical_sbf(jnp.asarray(d.numpy()),
                                      jnp.asarray(THETA),
                                      jnp.arange(len(X)), S, R, CUTOFF))
    if name == "angle_emb":
        return (t_sphere.angle_emb(t_basis.bessel_basis(x, S, R), th),
                j_sphere._angle_emb(jnp.asarray(d.numpy()),
                                    jnp.asarray(THETA), S, R, CUTOFF))
    return (t_sphere.torsion_emb(t_basis.bessel_basis(x, S, R), th, ph),
            j_sphere._torsion_emb(jnp.asarray(d.numpy()), jnp.asarray(THETA),
                                  jnp.asarray(PHI), S, R, CUTOFF))


@pytest.mark.parametrize("name", [
    "bessel_basis", "real_sph_harm", "sph_harm_m", "bessel_rbf",
    "spherical_sbf", "angle_emb", "torsion_emb",
])
def test_basis_matches_jax_in_float64(name):
    got, want = _x64(lambda: tuple(np.asarray(a) for a in _basis_case(name)))
    assert got.dtype == np.float64 and want.dtype == np.float64
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_spherical_bessel_is_accurate_in_float32():
    """Below z = l + 1 the series replaces the closed form, whose
    cancellation would leave float32 no correct digit near 0."""
    from scipy.special import spherical_jn

    z = np.concatenate([np.geomspace(1e-3, 1.0, 50), np.linspace(1, 25, 200)])
    for l in range(7):
        got = t_basis.spherical_jn(l, torch.tensor(z, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), spherical_jn(l, z),
                                   rtol=0, atol=2e-7)


def test_port_builds_its_bases_without_sympy():
    """The card's machine need not have sympy: no module of the port
    imports it."""
    import ast
    import pathlib

    root = pathlib.Path(t_basis.__file__).parents[1]
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "sympy" for n in names), path
