"""Port parity: the package-level API and ``enantiomer_separation``.

Every name a JAX package's ``__init__.py`` exports (its ``__all__``; for
the packages without one, the public names it defines or imports from the
JAX package) is importable from the port's package of the same name, or is
on the exclusion list below, whose names the port's package documents with
their counterparts. Then ``enantiomer_separation`` against the JAX one on
the molecule of ``tests/test_experiments.py``'s chirality case, with the
same weights through the weight bridge.
"""

import ast
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import molkgnn_tpu
from molkgnn_torch.analyses.embedding_compare import enantiomer_separation
from molkgnn_torch.data.synthetic import random_molgraph
from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.training.model import GNNModel
from molkgnn_tpu.analyses.embedding_compare import (
    enantiomer_separation as j_enantiomer_separation,
)
from molkgnn_tpu.data.synthetic import random_molgraph as j_random_molgraph
from molkgnn_tpu.graphs import batch_graphs as j_batch_graphs
from molkgnn_tpu.graphs import spec_for_graphs as j_spec_for_graphs
from molkgnn_tpu.models import MolKGNNNet as JMolKGNNNet
from molkgnn_tpu.training.checkpoint import from_torch_state_dict
from molkgnn_tpu.training.model import GNNModel as JGNNModel

JAX_ROOT = Path(molkgnn_tpu.__file__).parent
JAX_PACKAGES = sorted(
    ".".join(p.relative_to(JAX_ROOT.parent).parent.parts)
    for p in JAX_ROOT.rglob("__init__.py")
)
# JAX exports with no namesake in the port: (package, name) -> the port's
# counterpart, which the port package's docstring names.
EXCLUDED = {
    ("molkgnn_tpu.parallel", "shard_train_step"): "GradSync",
    ("molkgnn_tpu.parallel", "stack_shards"): "rank_rows",
}


def _jax_exports(package):
    """A JAX package's exported names, read from its ``__init__.py``."""
    path = JAX_ROOT.parent.joinpath(*package.split("."), "__init__.py")
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (
                node.module or "").startswith("molkgnn_tpu"):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and t.id.isupper()]
    return [n for n in names if not n.startswith("_")]


def test_every_jax_package_is_listed():
    assert len(JAX_PACKAGES) == 13
    assert "molkgnn_tpu.native" in JAX_PACKAGES


@pytest.mark.parametrize("package", JAX_PACKAGES)
def test_jax_exports_importable_from_the_port(package):
    port_name = package.replace("molkgnn_tpu", "molkgnn_torch", 1)
    port = importlib.import_module(port_name)
    missing = []
    for name in _jax_exports(package):
        if (package, name) in EXCLUDED:
            doc = port.__doc__ or ""
            assert name in doc and EXCLUDED[package, name] in doc, name
            assert hasattr(port, EXCLUDED[package, name])
            continue
        namespace = {}
        try:
            exec(f"from {port_name} import {name}", namespace)
        except ImportError:
            missing.append(name)
    assert not missing, f"{port_name} lacks {missing}"


def test_enantiomer_separation_matches_jax():
    """The molecule and model of test_experiments.py's chirality case
    (1 layer, 2/3/4/5 kernels, embedding 8); the port's seeded weights go
    to the JAX model through its importer."""
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    graphs = [random_molgraph(rng, num_atoms=14) for _ in range(4)]
    jgraphs = [j_random_molgraph(jrng, num_atoms=14) for _ in range(4)]
    for g, jg in zip(graphs, jgraphs):
        np.testing.assert_array_equal(g.x, jg.x)
        np.testing.assert_array_equal(g.p, jg.p)
    chiral = [i for i, g in enumerate(jgraphs)
              if g.with_fields().fields[4].count > 0]
    assert chiral, "need at least one molecule with a degree-4 center"
    cfg = dict(num_layers=1, kernels_1hop=(2, 3, 4, 5),
               kernels_nhop=(2, 3, 4, 5), graph_embedding_dim=8)
    spec = spec_for_graphs(graphs, 1)
    jspec = j_spec_for_graphs(jgraphs, batch_size=1)
    model = GNNModel(MolKGNNNet(generator=torch.Generator().manual_seed(0),
                                **cfg))
    jmodel = JGNNModel(encoder=JMolKGNNNet(**cfg))
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jmodel.init, jax.random.key(0),
                       j_batch_graphs([jgraphs[chiral[0]]], jspec)))
    variables = from_torch_state_dict(template, model.state_dict())
    encoder = model.gnn_model.eval()

    pairs = [(f"m{i}", graphs[i]) for i in chiral]
    got = enantiomer_separation(encoder, lambda g: batch_graphs([g], spec),
                                pairs)
    apply = jax.jit(jmodel.apply)
    want = j_enantiomer_separation(
        lambda v, b: apply(v, b)[1], variables,
        lambda g: j_batch_graphs([g], jspec),
        [(f"m{i}", jgraphs[i]) for i in chiral])
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, name
    assert got[f"m{chiral[0]}"] < 0.99999
