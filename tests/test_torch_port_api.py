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
import dataclasses
import importlib
import inspect
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


def _params(fn):
    """{name: default} of ``fn``'s parameters (a flax module's fields
    without ``parent`` and ``name``)."""
    return {name: p.default for name, p in inspect.signature(fn).parameters
            .items() if name not in ("parent", "name", "self")}


def _gap_kernel_conv():
    from molkgnn_torch.models.kgnn import KernelConv
    from molkgnn_tpu.models.kgnn import KernelConv as JKernelConv

    # use_pallas is the port's use_kernel (the CUDA scorer).
    want = {k: v for k, v in _params(JKernelConv).items()
            if k != "use_pallas"}
    port = KernelConv(deg=2, num_kernels=3, node_dim=4, edge_dim=2,
                      init_sc_weight=0.7)
    # Its setup makes every parameter: touching one initialises them all
    # without tracing the forward.
    jvars = JKernelConv(2, 3, 4, 2, init_sc_weight=0.7).init(
        jax.random.key(0), method=lambda m: m.w_center)
    names = ("length_sc_weight", "angle_sc_weight", "center_attr_sc_weight",
             "support_attr_sc_weight", "edge_attr_support_sc_weight")
    got = [getattr(port, n).item() for n in names]
    ref = [float(jvars["params"][n]) for n in names]
    return want, _params(KernelConv), got, ref


def _gap_normalize_rows():
    from molkgnn_torch.ops.similarity import normalize_rows
    from molkgnn_tpu.ops.similarity import normalize_rows as j_normalize_rows

    t = np.random.default_rng(1).standard_normal((3, 4, 5))
    got = normalize_rows(torch.from_numpy(t), axis=1).numpy()
    ref = np.asarray(_jax_x64(lambda: j_normalize_rows(t, axis=1)))
    return _params(j_normalize_rows), _params(normalize_rows), got, ref


def _gap_masked_batch_norm():
    from molkgnn_torch.ops.norm import MaskedBatchNorm
    from molkgnn_tpu.ops.norm import MaskedBatchNorm as JMaskedBatchNorm

    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0], bool)
    port = MaskedBatchNorm(4, eps=0.5, momentum=0.3)
    y = port(torch.from_numpy(x), torch.from_numpy(mask))
    jbn = JMaskedBatchNorm(4, eps=0.5, momentum=0.3)
    jv = jbn.init(jax.random.key(0), x, mask)
    jy, stats = jbn.apply(jv, x, mask, mutable=["batch_stats"])
    got = np.concatenate([y.detach().numpy().ravel(),
                          port.running_mean.numpy(), port.running_var.numpy()])
    ref = np.concatenate([np.asarray(jy).ravel(),
                          np.asarray(stats["batch_stats"]["mean"]),
                          np.asarray(stats["batch_stats"]["var"])])
    return (_params(JMaskedBatchNorm), _params(MaskedBatchNorm),
            got.tolist(), ref.tolist())


def _graph_arrays(g):
    return [g.x.tolist(), g.p.tolist(), g.edge_index.tolist(),
            g.edge_attr.tolist(), g.y]


def _gap_random_molgraph():
    kw = dict(num_atoms=13, node_dim=5, edge_dim=6, label=1.0,
              extra_edge_prob=0.9)
    got = random_molgraph(np.random.default_rng(3), **kw)
    ref = j_random_molgraph(np.random.default_rng(3), **kw)
    return (_params(j_random_molgraph), _params(random_molgraph),
            _graph_arrays(got), _graph_arrays(ref))


def _gap_random_dataset():
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_tpu.data.synthetic import random_dataset as j_random_dataset

    kw = dict(seed=4, num_graphs=3, extra_edge_prob=0.9, edge_dim=5)
    return (_params(j_random_dataset), _params(random_dataset),
            [_graph_arrays(g) for g in random_dataset(**kw)],
            [_graph_arrays(g) for g in j_random_dataset(**kw)])


def _gap_spec_for_graphs():
    rng = np.random.default_rng(5)
    graphs = [random_molgraph(rng) for _ in range(9)]
    got = spec_for_graphs(graphs, 4, node_align=16, slack=1.5)
    ref = j_spec_for_graphs(graphs, 4, node_align=16, slack=1.5)
    return (_params(j_spec_for_graphs), _params(spec_for_graphs),
            dataclasses.asdict(got), dataclasses.asdict(ref))


def _gap_validate():
    from molkgnn_torch.graphs.batch import BatchSpec
    from molkgnn_tpu.graphs.batch import BatchSpec as JBatchSpec

    def outcome(cls, caps):
        try:
            cls(8, 64, 128, caps).validate()
            return "ok"
        except AssertionError:
            return "AssertionError"

    cases = [(8, 8, 8, 8), (8, 8, 8)]
    return (_params(JBatchSpec.validate), _params(BatchSpec.validate),
            [outcome(BatchSpec, c) for c in cases],
            [outcome(JBatchSpec, c) for c in cases])


def _jax_x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


GAPS = {
    "KernelConv.init_sc_weight": _gap_kernel_conv,
    "normalize_rows.axis": _gap_normalize_rows,
    "MaskedBatchNorm.eps_momentum": _gap_masked_batch_norm,
    "random_molgraph": _gap_random_molgraph,
    "random_dataset.kwargs": _gap_random_dataset,
    "spec_for_graphs.align_slack": _gap_spec_for_graphs,
    "BatchSpec.validate": _gap_validate,
}


@pytest.mark.parametrize("gap", sorted(GAPS))
def test_parameter_gap_closed(gap):
    """Each parameter that the JAX function takes, the port's counterpart
    takes under the same name and default (in the JAX order for the
    functions), and one non-default value gives what the JAX function
    gives (fp64 within 1e-12; fp32 within 1e-6)."""
    want, have, got, ref = GAPS[gap]()
    for name, default in want.items():
        assert name in have, f"{gap}: the port lacks {name!r}"
        assert have[name] == default, (gap, name, have[name], default)
    if gap != "KernelConv.init_sc_weight":
        assert list(have) == list(want), (list(have), list(want))
    if gap.startswith(("normalize", "MaskedBatchNorm", "KernelConv")):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert got == ref
