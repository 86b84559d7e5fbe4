"""Port parity: SchNet, DimeNet++ and SphereNet, and their path through
the Trainer, the CLI, the importer, export and screening, on the CPU.

Both packages run the same packed batch (molecules made from a seed with
numpy, at most 12 atoms) with the same weights, carried over by
``molkgnn_torch.training.checkpoint.from_jax_variables``, at tiny widths
(2 layers, hidden 16, 3 spherical and 4 radial orders):

  * fp64 (JAX with jax_enable_x64, the port in double): forward within
    1e-9, parameter gradients of the BCE loss within 1e-8. The JAX
    package's SchNet and DimeNet++ layers ask their products for float32
    (``preferred_element_type``); here they run with the product in the
    inputs' dtype, through a stand-in for the module's ``jnp`` that passes
    everything else through, so that the reference is float64 throughout;
  * fp32: forward within 1e-5 of the largest value;
  * the mirror contract of ``tests/test_geometric_models.py``: SchNet and
    DimeNet++ give bit-equal outputs for a molecule and its mirror image,
    SphereNet (whose torsion changes sign) does not.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.cli import entry as t_entry
from molkgnn_torch.cli import import_ckpt as t_import
from molkgnn_torch.cli import screen as t_screen
from molkgnn_torch.data.dataset import make_synthetic_dataset
from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs import geometric as t_geo
from molkgnn_torch.models.dimenetpp import DimeNetPP
from molkgnn_torch.models.registry import get_family
from molkgnn_torch.models.schnet import SchNet
from molkgnn_torch.models.spherenet import SphereNet
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training import checkpoint as t_ckpt
from molkgnn_torch.training.model import GNNModel, bce_with_logits_loss
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.graphs import geometric as j_geo
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import dimenetpp as j_dimenet
from molkgnn_tpu.models import schnet as j_schnet
from molkgnn_tpu.models.spherenet import SphereNet as JSphereNet
from molkgnn_tpu.training import checkpoint as j_ckpt
from molkgnn_tpu.training.model import GNNModel as JGNNModel
from molkgnn_tpu.training.model import bce_with_logits_loss as j_bce

CUTOFF = 3.5
SMALL = dict(hidden_channels=16, out_channels=8)
BASES = dict(num_spherical=3, num_radial=4, int_emb_size=8,
             out_emb_channels=16, num_after_skip=1, num_output_layers=1)
FAMILIES = {
    "schnet": (
        dict(num_layers=2, num_filters=16, num_gaussians=10, **SMALL),
        j_schnet.SchNet, SchNet, {},
        ["--num_layers", "2", "--num_filters", "16", "--num_gaussians", "10"],
    ),
    "dimenet_pp": (
        dict(num_blocks=2, basis_emb_size=4, **SMALL, **BASES),
        j_dimenet.DimeNetPP, DimeNetPP, {"with_triplets": True},
        ["--num_blocks", "2", "--basis_emb_size", "4", "--num_spherical",
         "3", "--num_radial", "4", "--int_emb_size", "8",
         "--out_emb_channels", "16", "--num_after_skip", "1",
         "--num_output_layers", "1"],
    ),
    "spherenet": (
        dict(num_layers=2, basis_emb_size_dist=4, basis_emb_size_angle=4,
             basis_emb_size_torsion=4, **SMALL, **BASES),
        JSphereNet, SphereNet, {"with_torsion": True},
        ["--num_layers", "2", "--num_spherical", "3", "--num_radial", "4",
         "--int_emb_size", "8", "--out_emb_channels", "16",
         "--num_after_skip", "1", "--num_output_layers", "1"],
    ),
}
NAMES = sorted(FAMILIES)


class _Float64Products:
    """The JAX models' ``jnp`` with ``dot`` in the inputs' dtype."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None):
        return jnp.dot(a, b)


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    saved = j_schnet.jnp, j_dimenet.jnp
    j_schnet.jnp = j_dimenet.jnp = _Float64Products()
    try:
        return fn()
    finally:
        j_schnet.jnp, j_dimenet.jnp = saved
        jax.config.update("jax_enable_x64", False)


def _as64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree)


def _double(batch):
    return dataclasses.replace(batch, pos=batch.pos.double(),
                               y=batch.y.double())


def _mirror(batch):
    flip = torch.tensor([-1.0, 1.0, 1.0], dtype=batch.pos.dtype)
    return dataclasses.replace(batch, pos=batch.pos * flip)


def _molecules(n=8, seed=11):
    out = random_dataset(seed=seed, num_graphs=n)
    for g in out:
        k = min(g.num_nodes, 12)
        g.x, g.p, g.atomic_num = g.x[:k], g.p[:k], g.atomic_num[:k]
        g.edge_index = np.zeros((2, 0), np.int32)
        g.edge_attr = np.zeros((0, 7), np.float32)
        g.fields = None
    return out


def _jax_graph(g):
    return JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                     edge_attr=g.edge_attr, y=g.y, atomic_num=g.atomic_num)


@functools.lru_cache(maxsize=None)
def _family(name):
    """(port model in eval mode, JAX model, JAX variables, port batch, JAX
    batch, spec, molecules) of one family on 6 molecules. The JAX
    variables are the port's initial weights through the JAX importer
    (its template from ``jax.eval_shape``, no compile); the port model is
    loaded back from them through ``from_jax_variables``."""
    cfg, jcls, tcls, geo, _ = FAMILIES[name]
    graphs = _molecules()
    spec = t_geo.point_spec_for_graphs(graphs, 6, CUTOFF, **geo)
    jspec = j_geo.point_spec_for_graphs([_jax_graph(g) for g in graphs], 6,
                                        CUTOFF, **geo)
    batch = t_geo.batch_points(graphs[:6], spec)
    jbatch = j_geo.batch_points([_jax_graph(g) for g in graphs[:6]], jspec)
    jmodel = JGNNModel(encoder=jcls(cutoff=CUTOFF, **cfg), task_dim=1,
                       ffn_dropout_rate=0.0)
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jmodel.init, jax.random.key(0), jbatch))
    gen = torch.Generator().manual_seed(7)
    model = GNNModel(tcls(cutoff=CUTOFF, generator=gen, **cfg),
                     ffn_dropout_rate=0.0, generator=gen)
    v = j_ckpt.from_torch_state_dict(template, model.state_dict())
    model.load_state_dict(t_ckpt.from_jax_variables(v), strict=True)
    return model.eval(), jmodel, v, batch, jbatch, spec, graphs


@functools.lru_cache(maxsize=None)
def _jax64(name):
    """JAX in float64: ((prediction, embedding), parameter gradients of
    the mean BCE loss over the real graphs) on the family's batch."""
    _, jmodel, v, _, jbatch, _, _ = _family(name)
    jb = dataclasses.replace(jbatch, pos=np.asarray(jbatch.pos, np.float64),
                             y=np.asarray(jbatch.y, np.float64))

    def run():
        def loss(params):
            out = jmodel.apply({"params": params}, jb)
            return j_bce(out[0], jb.y, jb.graph_mask), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _as64(v)["params"])
        return jax.device_get((out, grads))

    return _x64(run)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_fp64(name):
    model, _, _, batch, _, _, _ = _family(name)
    want = [np.asarray(a) for a in _jax64(name)[0]]
    with torch.no_grad():
        got = [t.numpy() for t in model.double()(_double(batch))]
    model.float()
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_fp32(name):
    model, jmodel, v, batch, jbatch, _, _ = _family(name)
    want = [np.asarray(a) for a in jax.jit(jmodel.apply)(v, jbatch)]
    with torch.no_grad():
        got = [t.numpy() for t in model(batch)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_fp64(name):
    """Parameter gradients of the mean BCE loss over the real graphs."""
    model, _, _, batch, _, _, _ = _family(name)
    want = t_ckpt.from_jax_variables({"params": _jax64(name)[1]})
    model.double().zero_grad()
    b64 = _double(batch)
    pred, _ = model(b64)
    bce_with_logits_loss(pred, b64.y, b64.graph_mask).backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.float().zero_grad()
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-8 * scale, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_padding_invariance(name):
    """Two molecules alone in the batch score as they do among six."""
    model, _, _, batch, _, spec, graphs = _family(name)
    few = t_geo.batch_points(graphs[:2], spec)
    with torch.no_grad():
        full, part = model(batch)[1], model(few)[1]
    np.testing.assert_allclose(part[:2].numpy(), full[:2].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.all(part[2:] == 0)


@pytest.mark.parametrize("name", NAMES)
def test_mirror_contract(name):
    """SchNet and DimeNet++ are bit-for-bit mirror-invariant; SphereNet's
    torsion sees the mirror image."""
    model, _, _, batch, _, _, _ = _family(name)
    with torch.no_grad():
        a = model(batch)[1]
        b = model(_mirror(batch))[1]
    if name == "spherenet":
        assert float((a - b).abs().max()) > 1e-6
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_round_trip(name):
    """The port's state_dict goes back through the JAX importer to the
    JAX variables it came from, and through the port's importer to
    itself; the reference's dead keys are skipped."""
    model, _, v, _, _, _, _ = _family(name)
    sd = model.state_dict()
    back = j_ckpt.from_torch_state_dict(v, sd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref = {"model." + k: t for k, t in sd.items()}
    ref["model.lin1.weight"] = torch.zeros(2, 2)
    if name == "schnet":
        ref["model.gnn_model.dist_emb.offset"] = torch.zeros(10)
    got = t_ckpt.from_torch_state_dict(model, ref, prefix="model.")
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k])


def test_spherenet_learned_node_vector_matches_jax_fp64():
    """SphereNet(use_node_features=False): one learned vector in place of
    the atom table, under the key the JAX importer maps its
    ``init_e/node_embedding`` leaf to. The port's seeded weights pass the
    JAX importer (no key missing or left over) and come back through
    ``from_jax_variables`` unchanged; the fp64 forward within 1e-9."""
    cfg = FAMILIES["spherenet"][0]
    _, _, _, batch, jbatch, _, _ = _family("spherenet")
    jmodel = JGNNModel(encoder=JSphereNet(cutoff=CUTOFF,
                                          use_node_features=False, **cfg),
                       task_dim=1, ffn_dropout_rate=0.0)
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jmodel.init, jax.random.key(0), jbatch))
    gen = torch.Generator().manual_seed(8)
    model = GNNModel(SphereNet(cutoff=CUTOFF, use_node_features=False,
                               generator=gen, **cfg),
                     ffn_dropout_rate=0.0, generator=gen)
    sd = model.state_dict()
    assert sd["gnn_model.init_e.node_embedding.node_embedding"].shape == (16,)
    assert not any(k.startswith("gnn_model.init_e.emb") for k in sd)
    v = j_ckpt.from_torch_state_dict(template, sd)
    np.testing.assert_array_equal(
        np.asarray(v["params"]["encoder"]["init_e"]["node_embedding"]),
        sd["gnn_model.init_e.node_embedding.node_embedding"].numpy())
    back = t_ckpt.from_jax_variables(v)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

    jb = dataclasses.replace(jbatch, pos=np.asarray(jbatch.pos, np.float64),
                             y=np.asarray(jbatch.y, np.float64))
    want = _x64(lambda: jax.device_get(jax.jit(jmodel.apply)(_as64(v), jb)))
    with torch.no_grad():
        got = model.double().eval()(_double(batch))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and np.asarray(w).dtype == np.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_trainer_scan_steps_on_cpu(name, tmp_path):
    """Trainer.fit with scan_steps=4 (K eager steps on the CPU) equals
    scan_steps=1 bit for bit, on the device-data path with device
    sampling: the same losses, weights and validation metrics."""
    cfg, _, tcls, _, _ = FAMILIES[name]
    dataset = make_synthetic_dataset(seed=2, num_graphs=24)
    for g in dataset.graphs:
        k = min(g.num_nodes, 10)
        g.p, g.atomic_num, g.x = g.p[:k], g.atomic_num[:k], g.x[:k]
    spec = get_family(name).make_spec(dataset.graphs, 4, cutoff=CUTOFF)
    runs = []
    for k in (1, 4):
        gen = torch.Generator().manual_seed(0)
        model = GNNModel(tcls(cutoff=CUTOFF, generator=gen, **cfg),
                         generator=gen)
        trainer = Trainer(model, dataset, spec, TrainConfig(
            batch_size=4, max_epochs=2, scan_steps=k, progress=False,
            oversample=True, device_sampling=True, warmup_iterations=2,
            log_dir=str(tmp_path / str(k))), device="cpu")
        history = trainer.fit()
        runs.append((trainer.step_losses, history[-1]["loss"],
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()}))
    (l1, v1, p1), (l4, v4, p4) = runs
    assert len(l1) == len(l4) > 4 and l1 == l4 and v1 == v4
    assert all(np.isfinite(l1))
    for n in p1:
        assert torch.equal(p1[n], p4[n]), n


def test_cli_schnet_one_epoch_on_cpu(tmp_path, capsys):
    """`--gnn_type schnet --device cpu`: one epoch, test, artifacts."""
    root = tmp_path / "run"
    assert t_entry.main([
        "--gnn_type", "schnet", "--device", "cpu", "--dataset_name",
        "synthetic", "--synthetic_graphs", "40", "--max_epochs", "1",
        "--batch_size", "8", "--cutoff", str(CUTOFF),
        "--hidden_channels", "16", "--out_channels", "8",
        "--default_root_dir", str(root), *FAMILIES["schnet"][4],
    ]) == 0
    logs = root / "logs"
    for f in ("test_result.log", "history.json", "graph_embedding.npy",
              "task_info.log"):
        assert (logs / f).exists(), f
    assert not (logs / "kernels").exists()  # kgnn only
    assert "[last]" in (logs / "test_result.log").read_text()
    assert (root / "checkpoints" / "last.pt").exists()


def test_import_export_screen_schnet(tmp_path):
    """A reference-layout .ckpt of a SchNet model goes through the import
    CLI (export on the CPU) and the screen CLI: the CSV equals a
    Predictor's scores with the same weights, the malformed record's cell
    is empty; the artifact carries the point spec."""
    from test_torch_port_qsar import MALFORMED, _block

    model, _, _, _, _, _, _ = _family("schnet")
    sdf = tmp_path / "lib.sdf"
    with open(sdf, "w") as f:
        for i in range(12):
            f.write(MALFORMED if i == 4 else _block(i, 500 + i))
            f.write("$$$$\n")
    sd = {"model." + k: t for k, t in model.state_dict().items()}
    sd["model.gnn_model.dist_emb.offset"] = torch.zeros(10)
    ckpt = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    art, csv = str(tmp_path / "schnet.pt2"), str(tmp_path / "scores.csv")
    flags = ["--gnn_type", "schnet", "--cutoff", str(CUTOFF),
             "--hidden_channels", "16", "--out_channels", "8",
             *FAMILIES["schnet"][4]]
    assert t_import.main(["--torch_ckpt", ckpt, "--sdf", str(sdf), "--out",
                          art, "--batch_size", "4", "--prefix", "model.",
                          "--device", "cpu", *flags]) == 0
    assert t_screen.main(["--exported", art, "--sdf", str(sdf), "--out",
                          csv, "--device", "cpu"]) == 0
    rows = [line.split(",") for line in open(csv).read().splitlines()[1:]]
    assert len(rows) == 12 and rows[4][1] == ""
    got = np.array([float(s) for i, s in rows if i != "4"])

    call, spec = Predictor.load_exported(art, "cpu")
    assert isinstance(spec, t_geo.PointBatchSpec) and spec.num_graphs == 4
    from molkgnn_torch.chem.sdf import parse_sdf
    from molkgnn_torch.serving.predictor import host_pipeline_for_spec

    to_graph, collate = host_pipeline_for_spec(spec)
    graphs = [to_graph(m, y=0.0, idx=i)
              for i, (m, _) in enumerate(parse_sdf(str(sdf)))
              if m is not None]
    pred = Predictor(model, model.state_dict(), spec, device="cpu")
    want = pred.predict_graphs(graphs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pred.screen_library(graphs, slab=5), want)
