"""Port parity: the serving path, and the port's independence from JAX.

``Predictor.predict_graphs`` of both packages serve the same 20 molecules
at batch 8 (two full chunks and a padded partial one) with the same
weights; scores, probabilities and embeddings agree within 1e-5 (fp32, one
layer, where no permutation argmax rests on a tie).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.model import GNNModel
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models.kgnn import MolKGNNNet as JMolKGNNNet
from molkgnn_tpu.serving.predictor import Predictor as JPredictor
from molkgnn_tpu.training.model import GNNModel as JGNNModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    num_layers=1, kernels_1hop=(2, 3, 4, 5), kernels_nhop=(2, 3, 4, 5),
    graph_embedding_dim=8,
)


def _setup():
    graphs = random_dataset(seed=4, num_graphs=20, active_fraction=0.3)
    jgraphs = [
        JMolGraph(
            x=g.x, p=g.p, edge_index=g.edge_index, edge_attr=g.edge_attr,
            y=g.y, atomic_num=g.atomic_num,
        ).with_fields()
        for g in graphs
    ]
    jspec = j_batch.spec_for_graphs(jgraphs, batch_size=8)
    jmodel = JGNNModel(encoder=JMolKGNNNet(**CFG), ffn_dropout_rate=0.0)
    v = jax.device_get(
        jax.jit(jmodel.init)(
            jax.random.key(3), j_batch.batch_graphs(jgraphs[:8], jspec)
        )
    )
    return graphs, jgraphs, jspec, jmodel, v


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predictor_matches_jax(use_kernel):
    graphs, jgraphs, jspec, jmodel, v = _setup()
    jpred = JPredictor(jmodel, v["params"], v["batch_stats"], jspec)
    want_scores, want_emb = jpred.predict_graphs(jgraphs, return_embeddings=True)
    want_probs = jpred.predict_graphs(jgraphs, probabilities=True)

    model = GNNModel(MolKGNNNet(**CFG, use_kernel=use_kernel), ffn_dropout_rate=0.0)
    pred = Predictor(
        model, from_jax_variables(v), spec_for_graphs(graphs, 8), device="cpu"
    )
    scores, emb = pred.predict_graphs(graphs, return_embeddings=True)
    probs = pred.predict_graphs(graphs, probabilities=True)
    assert scores.shape == (20,) and emb.shape == (20, 8)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb, want_emb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs, want_probs, rtol=1e-5, atol=1e-6)
    assert np.all((probs > 0) & (probs < 1))


def test_predictor_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """No silent CPU fallback: without CUDA the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graphs = random_dataset(seed=0, num_graphs=4)
    model = GNNModel(MolKGNNNet(**CFG))
    sd = model.state_dict()
    spec = spec_for_graphs(graphs, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model, sd, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model, sd, spec, device="cuda")
    assert Predictor(model, sd, spec, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """Importing the port (every module) and chip_smoke.py loads neither
    jax/flax/optax, nor scikit-learn, nor the JAX package, even where they
    are importable: a finder that refuses them is installed first, and
    sys.modules is checked afterwards. The imports load no CUDA or native
    library either."""
    code = """
import sys

BANNED = ("jax", "jaxlib", "flax", "optax", "sklearn", "molkgnn_tpu")

def banned(name):
    return name.split(".")[0] in BANNED

for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import molkgnn_torch
import molkgnn_torch.models.kgnn
import molkgnn_torch.serving.predictor
import molkgnn_torch.training.checkpoint
import molkgnn_torch.data.synthetic
import molkgnn_torch.data.dataset
import molkgnn_torch.graphs.packed
import molkgnn_torch.graphs.device_pack
import molkgnn_torch.training.metrics
import molkgnn_torch.training.optim
import molkgnn_torch.training.schedule
import molkgnn_torch.training.trainer
import molkgnn_torch.chem
import molkgnn_torch.chem.embed
import molkgnn_torch.chem.smiles
import molkgnn_torch.data.qsar
import molkgnn_torch.data.d4dchp
import molkgnn_torch.data.preprocess
import molkgnn_torch.cli.entry
import molkgnn_torch.cli.import_ckpt
import molkgnn_torch.cli.screen
import molkgnn_torch.serving.blocks
import molkgnn_torch.graphs.geometric
import molkgnn_torch.graphs.device_points
import molkgnn_torch.ops.basis
import molkgnn_torch.models.schnet
import molkgnn_torch.models.dimenetpp
import molkgnn_torch.models.spherenet
import molkgnn_torch.models.registry
import molkgnn_torch.chem.chiro_features
import molkgnn_torch.graphs.chiro
import molkgnn_torch.graphs.device_chiro
import molkgnn_torch.models.chironet
import molkgnn_torch.tools.enantiomer
import molkgnn_torch.graphs.balance
import molkgnn_torch.data.prefetch
import molkgnn_torch.training.contrastive
import molkgnn_torch.training.monitors
import molkgnn_torch.analyses.fixed_kernels
import molkgnn_torch.analyses.kernel_reader
import molkgnn_torch.analyses.embedding_compare
import molkgnn_torch.experiments.sweep
import molkgnn_torch.experiments.aggregate
import molkgnn_torch.experiments.cli
import molkgnn_torch.tools.replay_step
import molkgnn_torch.tools.screen_rate
import molkgnn_torch.parallel
import molkgnn_torch.parallel.data_parallel
import molkgnn_torch.parallel.multihost
import molkgnn_torch.parallel.launch
import molkgnn_torch.parallel.collectives
import molkgnn_torch.parallel.halo
import molkgnn_torch.parallel.hybrid
import molkgnn_torch.parallel.edge_partition
import molkgnn_torch.native
import molkgnn_torch.analyses
import molkgnn_torch.data
import molkgnn_torch.experiments
import molkgnn_torch.graphs
import molkgnn_torch.models
import molkgnn_torch.ops
import molkgnn_torch.serving
import molkgnn_torch.training
from molkgnn_torch.training import *
from molkgnn_torch.analyses.embedding_compare import enantiomer_separation
import chip_smoke
loaded = sorted(m for m in sys.modules if banned(m))
assert not loaded, loaded
import molkgnn_torch.ops._build
assert not molkgnn_torch.ops._build._loaded  # no CUDA library loaded
assert molkgnn_torch.native._lib is None  # nor the native one
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "sklearn", "molkgnn_tpu"}


def test_port_sources_import_no_jax():
    """No import statement anywhere in the port's sources or chip_smoke.py,
    at module level or inside a function, names jax, flax, optax,
    scikit-learn or the JAX package."""
    import ast
    import pathlib

    files = sorted(pathlib.Path(REPO, "molkgnn_torch").rglob("*.py"))
    files.append(pathlib.Path(REPO, "chip_smoke.py"))
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED_ROOTS, (path, name)


def test_load_exported_needs_no_model_code(tmp_path):
    """An exported model loads and scores in a process that imports
    nothing under molkgnn_torch/models (nor jax): load_exported registers
    the scorer op and rebuilds the batch leaves, no more."""
    graphs = random_dataset(seed=0, num_graphs=8)
    spec = spec_for_graphs(graphs, 4)
    model = GNNModel(MolKGNNNet(**CFG, use_kernel=True))
    pred = Predictor(model, model.state_dict(), spec, device="cpu")
    path = str(tmp_path / "model.pt2")
    pred.export(path)
    want = pred.predict_graphs(graphs[:4])
    np.save(tmp_path / "want.npy", want)
    code = f"""
import sys
import numpy as np
from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs.batch import batch_graphs
from molkgnn_torch.serving.predictor import Predictor

call, spec = Predictor.load_exported({path!r}, device="cpu")
pred, emb = call(batch_graphs(random_dataset(seed=0, num_graphs=8)[:4], spec))
want = np.load({str(tmp_path / "want.npy")!r})
np.testing.assert_allclose(pred.numpy(), want, rtol=1e-6, atol=1e-6)
loaded = sorted(m for m in sys.modules if m.startswith("molkgnn_torch.models")
                or m.split(".")[0] in ("jax", "molkgnn_tpu"))
assert not loaded, loaded
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"
