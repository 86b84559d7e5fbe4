"""Port parity: library screening, SMILES scoring, export, the reference
checkpoint importer and the screening/import CLIs, on the CPU.

The port against the JAX package, fed the same molecules (made from a seed
with numpy) and the same weights (``from_jax_variables``), one layer,
kernels (2, 3, 4, 5), hidden 8: fp32 within 1e-5 (JAX on the CPU, its XLA
scorer: the same arithmetic as the Pallas kernel's reference; at one layer
no permutation argmax rests on a tie that the two sum differently). The
port against itself: ``screen_library`` equals ``predict_graphs`` exactly
in fp64 (the device assembly is bit-equal to the host packer, and the
CPU's sums are deterministic), and ``Trainer.evaluate`` through the block
scorer equals the eager loop it replaced, bit for bit.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from molkgnn_torch.cli import import_ckpt as t_import
from molkgnn_torch.cli import screen as t_screen
from molkgnn_torch.data.dataset import make_synthetic_dataset
from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
from molkgnn_torch.graphs.device_pack import gather_batch, pad_ids
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.serving import predictor as t_predictor
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training import checkpoint as t_ckpt
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.cli import import_ckpt as j_import
from molkgnn_tpu.cli import screen as j_screen
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs.chiro import ChiroBatchSpec
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models.kgnn import MolKGNNNet as JMolKGNNNet
from molkgnn_tpu.serving.predictor import Predictor as JPredictor
from molkgnn_tpu.training import checkpoint as j_ckpt
from molkgnn_tpu.training.model import GNNModel as JGNNModel
from test_torch_port_qsar import MALFORMED, _block

KERNELS = (2, 3, 4, 5)
CFG = dict(num_layers=1, kernels_1hop=KERNELS, kernels_nhop=KERNELS,
           graph_embedding_dim=8)
MODEL_FLAGS = [
    "--num_layers", "1", "--hidden_dim", "8",
    *[f for i, k in enumerate(KERNELS, 1)
      for f in (f"--num_kernel{i}_1hop", str(k), f"--num_kernel{i}_Nhop",
                str(k))],
]
# Reference keys that are dead in its forward, and BatchNorm bookkeeping:
# the importers skip them.
DEAD_KEYS = {
    "lin1.weight": (8, 8), "lin1.bias": (8,), "lin2.weight": (1, 8),
    "gnn_model.graph_embedding_linear.weight": (8, 14),
    "gnn_model.node_batch_norm.num_batches_tracked": (),
    "gnn_model.edge_batch_norm.num_batches_tracked": (),
}


def _jgraphs(graphs):
    return [
        JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                  edge_attr=g.edge_attr, y=g.y,
                  atomic_num=g.atomic_num).with_fields()
        for g in graphs
    ]


@pytest.fixture(scope="module")
def setup():
    """30 molecules, a spec at batch 8, and a JAX Predictor with random
    weights."""
    graphs = random_dataset(seed=12, num_graphs=30, active_fraction=0.3)
    jgraphs = _jgraphs(graphs)
    jspec = j_batch.spec_for_graphs(jgraphs, batch_size=8)
    jmodel = JGNNModel(encoder=JMolKGNNNet(**CFG), ffn_dropout_rate=0.0)
    v = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(5), j_batch.batch_graphs(jgraphs[:8], jspec)))
    jpred = JPredictor(jmodel, v["params"], v["batch_stats"], jspec)
    return graphs, jgraphs, spec_for_graphs(graphs, 8), jpred, v


def _port(v, spec, use_kernel=True, dtype=torch.float32):
    model = GNNModel(MolKGNNNet(**CFG, use_kernel=use_kernel),
                     ffn_dropout_rate=0.0)
    sd = {k: t.to(dtype) for k, t in from_jax_variables(v).items()}
    return Predictor(model.to(dtype), sd, spec, device="cpu")


@pytest.fixture(scope="module")
def jax_screened(setup):
    """JAX's screen_library of the whole library, and of a ragged one of
    12 over slabs of 7 (the last block of each slab partly padded) in
    probabilities."""
    jgraphs, jpred = setup[1], setup[3]
    return (jpred.screen_library(jgraphs),
            jpred.screen_library(jgraphs[:12], probabilities=True, slab=7))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_screen_library_matches_jax(setup, jax_screened, use_kernel):
    graphs, _, spec, _, v = setup
    pred = _port(v, spec, use_kernel)
    got = pred.screen_library(graphs)
    assert got.shape == (30,)
    np.testing.assert_allclose(got, jax_screened[0], rtol=1e-5, atol=1e-5)
    got = pred.screen_library(graphs[:12], probabilities=True, slab=7)
    assert got.shape == (12,) and len(pred.screen_slabs) == 2
    np.testing.assert_allclose(got, jax_screened[1], rtol=1e-5, atol=1e-6)


def test_screen_library_equals_predict_graphs_in_fp64(setup):
    graphs, _, spec, _, v = setup
    pred = _port(v, spec, dtype=torch.float64)
    want = pred.predict_graphs(graphs)
    assert want.dtype == np.float64
    np.testing.assert_array_equal(pred.screen_library(graphs), want)
    np.testing.assert_array_equal(pred.screen_library(graphs[:19], slab=7),
                                  want[:19])


def _refusal(case, setup):
    graphs, _, spec, _, v = setup
    if case == "overflow":
        # A spec built over the smallest molecules: the large ones overflow.
        small = sorted(graphs, key=lambda g: g.num_nodes)[:10]
        pred = _port(v, spec_for_graphs(small, 8))
        return ValueError, "exceeds the spec", lambda: pred.screen_library(
            sorted(graphs, key=lambda g: -g.num_nodes))
    if case == "mesh":
        # A mesh of another device type than the Predictor's.
        cuda_mesh = types.SimpleNamespace(device_type="cuda")
        return ValueError, "a cuda mesh for a Predictor on cpu", lambda: (
            _port(v, spec).screen_library(graphs, mesh=cuda_mesh))
    # The JAX package's ChiroBatchSpec is not a spec of the port.
    chiro = ChiroBatchSpec(num_graphs=8, num_nodes=64, num_edges=256,
                           num_dist=64, num_angles=64, num_dihedrals=64,
                           num_alpha=64)
    return NotImplementedError, "not a batch spec", lambda: _port(v, chiro)


# "point_spec" keeps its name from when the point family was the unported
# one; it now holds a spec type the port does not register.
@pytest.mark.parametrize("case", ["overflow", "mesh", "point_spec"])
def test_screen_library_refusals(setup, case):
    """An overflowing batch raises before any scoring (the device gather
    would truncate it); a data-parallel mesh of another device type than
    the Predictor's raises; a spec of a type the port does not register
    raises."""
    err, match, call = _refusal(case, setup)
    with pytest.raises(err, match=match):
        call()


def test_predict_smiles_matches_jax(setup):
    _, _, spec, jpred, v = setup
    smiles = ["CCO", "not_a_smiles((", "c1ccccc1", "CC(N)=O"]
    got = _port(v, spec).predict_smiles(smiles, probabilities=True)
    want = jpred.predict_smiles(smiles, probabilities=True)
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def exported(setup, tmp_path_factory):
    """{use_kernel: (Predictor, path of its export, the program)}."""
    v, spec = setup[4], setup[2]
    out = {}
    for use_kernel in (False, True):
        pred = _port(v, spec, use_kernel)
        path = str(tmp_path_factory.mktemp("export") / "model.pt2")
        out[use_kernel] = pred, path, pred.export(path)
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_export_roundtrip_equals_predict_graphs(setup, exported, use_kernel):
    """The exported program, loaded without the model, scores as the
    Predictor does; with use_kernel=True its graph holds the scorer op,
    one node a layer, and no einsum of the plain form."""
    graphs, spec = setup[0], setup[2]
    pred, path, program = exported[use_kernel]
    call, got_spec = Predictor.load_exported(path, device="cpu")
    assert got_spec == spec
    batch = batch_graphs(graphs[:8], spec)
    out, emb = call(batch)
    want, want_emb = pred.predict_graphs(graphs[:8], return_embeddings=True)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(emb.numpy(), want_emb, rtol=1e-5, atol=1e-6)
    targets = [str(n.target) for n in program.graph.nodes]
    ops = [t for t in targets if "molkgnn.support_score" in t]
    assert len(ops) == (1 if use_kernel else 0)
    if not use_kernel:
        assert any("matmul" in t or "mm" in t for t in targets)
    with pytest.raises(ValueError, match="exported on cpu"):
        Predictor.load_exported(path, device="meta")


def _reference_ckpt(v, path, prefix="", raw=False):
    """A reference-layout checkpoint of the JAX weights ``v``: the port's
    state_dict keys (the reference's), ``prefix``ed, plus dead keys; a PL
    ``.ckpt`` unless ``raw``."""
    sd = {prefix + k: t for k, t in from_jax_variables(v).items()}
    for k, shape in DEAD_KEYS.items():
        sd[prefix + k] = torch.zeros(shape)
    torch.save(sd if raw else {"state_dict": sd, "epoch": 3}, path)
    return sd


@pytest.mark.parametrize("prefix,raw", [("model.", False), ("", True)])
def test_importer_matches_jax(setup, tmp_path, prefix, raw):
    graphs, jgraphs, spec, jpred, v = setup
    path = str(tmp_path / "ref.ckpt")
    _reference_ckpt(v, path, prefix, raw)
    template = jax.tree.map(np.zeros_like, v)
    jv = j_ckpt.load_torch_checkpoint(path, template, prefix=prefix)
    want = JPredictor(jpred.model, jv["params"], jv["batch_stats"],
                      jpred.spec).predict_graphs(jgraphs)
    model = GNNModel(MolKGNNNet(**CFG, use_kernel=True))
    sd = t_ckpt.load_torch_checkpoint(path, model, prefix=prefix)
    got = Predictor(model, sd, spec, device="cpu").predict_graphs(graphs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault,err", [
    ("missing", KeyError), ("shape", ValueError), ("leftover", ValueError),
])
def test_importer_errors_match_jax(setup, fault, err):
    """A missing key, a wrong shape and a key no target takes raise in
    both importers, with the same message."""
    v = setup[4]
    sd = {"model." + k: t for k, t in from_jax_variables(v).items()}
    key = "model.gnn_model.gnn.layers.0.trainable_kernelconv_set.2.x_support"
    if fault == "missing":
        del sd[key]
    elif fault == "shape":
        sd[key] = torch.zeros(1, 3, 28)
    else:
        sd["model.gnn_model.gnn.layers.0.fixed_kernelconv_set.0.x_center"] = (
            torch.zeros(2, 28))
    model = GNNModel(MolKGNNNet(**CFG))
    with pytest.raises(err) as t_err:
        t_ckpt.from_torch_state_dict(model, sd, prefix="model.")
    with pytest.raises(err) as j_err:
        j_ckpt.from_torch_state_dict(jax.tree.map(np.zeros_like, v), sd,
                                     prefix="model.")
    key = "'model." if fault != "shape" else "shape mismatch at 'model."
    assert key in str(t_err.value) and key in str(j_err.value)


def _csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "record_index,score"
    rows = [line.split(",") for line in lines[1:]]
    assert [int(i) for i, _ in rows] == list(range(len(rows)))
    return np.array([np.nan if s == "" else float(s) for _, s in rows])


def test_import_and_screen_clis_match_jax(setup, tmp_path, monkeypatch):
    """The same reference .ckpt and SDF (24 records, the 6th malformed)
    through the JAX package's molkgnn-import + molkgnn-screen and through
    the port's, called in-process on the CPU: CSVs within 1e-5, the same
    empty cell. (The JAX CLI's template init, whose values the import
    replaces, runs jitted here: eagerly it compiles op by op, ~25 s.)"""
    v = setup[4]
    init = JGNNModel.init
    monkeypatch.setattr(JGNNModel, "init", lambda self, rng, *a, **kw: (
        jax.jit(functools.partial(init, self, **kw))(rng, *a)))
    sdf = tmp_path / "lib.sdf"
    with open(sdf, "w") as f:
        for i in range(24):
            f.write(MALFORMED if i == 5 else _block(i, 300 + i))
            f.write("$$$$\n")
    ckpt = str(tmp_path / "ref.ckpt")
    _reference_ckpt(v, ckpt, "model.")
    common = ["--torch_ckpt", ckpt, "--sdf", str(sdf), "--batch_size", "8",
              "--prefix", "model.", *MODEL_FLAGS]
    csv = {}
    for name, imp, scr, extra in (
        ("jax", j_import, j_screen, []),
        ("torch", t_import, t_screen, ["--device", "cpu"]),
    ):
        art, out = str(tmp_path / f"{name}.model"), str(tmp_path / name)
        assert imp.main(common + ["--out", art, *extra]) == 0
        assert scr.main(["--exported", art, "--sdf", str(sdf), "--out",
                         out + ".csv", *extra]) == 0
        assert scr.main(["--exported", art, "--sdf", str(sdf), "--out",
                         out + "_p.csv", "--probabilities", *extra]) == 0
        csv[name] = (_csv(out + ".csv"), _csv(out + "_p.csv"))
    for got, want in zip(csv["torch"], csv["jax"]):
        assert got.shape == (24,)
        np.testing.assert_array_equal(np.isnan(got), np.arange(24) == 5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    logits, probs = csv["torch"]
    ok = ~np.isnan(logits)
    np.testing.assert_allclose(probs[ok], 1 / (1 + np.exp(-logits[ok])),
                               rtol=1e-6)


def test_evaluate_through_blocks_equals_the_eager_loop(tmp_path):
    """On the CPU the Trainer's evaluation (BlockScorer over the split's id
    blocks) gives what the per-batch eager loop it replaced gave, bit for
    bit, with a partly padded last block."""
    ds = make_synthetic_dataset(seed=2, num_graphs=60)
    spec = spec_for_graphs(ds.graphs, 8)
    gen = torch.Generator().manual_seed(1)
    model = GNNModel(MolKGNNNet(**CFG, use_kernel=True, generator=gen),
                     generator=gen)
    trainer = Trainer(model, ds, spec, TrainConfig(
        batch_size=8, max_epochs=1, warmup_iterations=2, progress=False,
        log_dir=str(tmp_path / "logs")), device="cpu")
    trainer.fit()
    ids = np.asarray(ds.split["valid"])
    assert len(ids) % 8
    idm = np.stack([pad_ids(ids[s:s + 8], 8) for s in range(0, len(ids), 8)])
    model.eval()
    with torch.no_grad():
        want = torch.cat([
            model(gather_batch(trainer._device_data, row, spec))[0]
            for row in torch.as_tensor(idm)
        ]).numpy()[(idm >= 0).reshape(-1)]
    true_y, pred_y = trainer._predictions("valid")
    np.testing.assert_array_equal(pred_y, want)
    results = trainer.evaluate("valid")
    assert results["loss"] == trainer.history[0]["loss"]


def test_predictor_from_trainer_and_from_checkpoint(tmp_path):
    """A Predictor of a trainer's checkpoint tag, in memory and from its
    .pt file, scores with that tag's weights; the trainer's own model keeps
    its weights and its dropout generator."""
    ds = make_synthetic_dataset(seed=3, num_graphs=48)
    spec = spec_for_graphs(ds.graphs, 8)
    gen = torch.Generator().manual_seed(2)
    model = GNNModel(MolKGNNNet(**CFG, generator=gen), generator=gen)
    trainer = Trainer(model, ds, spec, TrainConfig(
        batch_size=8, max_epochs=2, warmup_iterations=2, progress=False,
        log_dir=str(tmp_path / "logs"),
        checkpoint_dir=str(tmp_path / "ckpt")), device="cpu")
    trainer.fit()
    tag = "best_loss"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pred = Predictor.from_trainer(trainer, tag=tag)
    assert pred.model is not model and pred.device.type == "cpu"
    assert model.dropout.generator is trainer.dropout_rng
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    other = GNNModel(MolKGNNNet(**CFG))
    want = Predictor(other, trainer._ckpts[tag]["model"], spec,
                     device="cpu").predict_graphs(ds.graphs)
    np.testing.assert_array_equal(pred.predict_graphs(ds.graphs), want)
    loaded = Predictor.from_checkpoint(
        GNNModel(MolKGNNNet(**CFG)), str(tmp_path / "ckpt" / tag), spec,
        device="cpu")
    np.testing.assert_array_equal(loaded.predict_graphs(ds.graphs), want)


@pytest.mark.parametrize("entry", [
    "screen_cli", "import_cli", "load_exported", "screen_library",
])
def test_new_entry_points_need_cuda_unless_cpu_is_asked(setup, exported,
                                                        monkeypatch, entry):
    """Without a card, each new entry point raises by default; none falls
    back to the CPU unless it is asked for."""
    graphs, _, spec, _, v = setup
    path = exported[True][1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "screen_cli": lambda: t_screen.main(
            ["--exported", path, "--sdf", "x.sdf", "--out", "x.csv"]),
        "import_cli": lambda: t_import.main(
            ["--torch_ckpt", "x.ckpt", "--sdf", "x.sdf", "--out", path]),
        "load_exported": lambda: Predictor.load_exported(path),
        "screen_library": lambda: Predictor(
            GNNModel(MolKGNNNet(**CFG)), from_jax_variables(v), spec
        ).screen_library(graphs),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert t_predictor.resolve_device("cpu").type == "cpu"


def test_graph_batch_leaves_follow_the_jax_tree_order(setup):
    """``GraphBatch.leaves`` lists the fields as jax.tree_util flattens the
    JAX package's GraphBatch, so an exported program takes the same
    inputs in the same order."""
    graphs, jgraphs, spec, jpred, _ = setup
    got = batch_graphs(graphs[:8], spec).leaves()
    want = jax.tree_util.tree_leaves(j_batch.batch_graphs(jgraphs[:8],
                                                          jpred.spec))
    assert len(got) == len(want) == 26
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
