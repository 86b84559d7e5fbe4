"""Port parity: ChIRoNet, and its path through the featurisation, the
device gather, the Trainer, the CLIs, the importer, export and screening,
on the CPU.

Both packages featurize the same molecules: each parses the SMILES with
its own chemistry, and both get one set of positions, made from a seed
with numpy. The featurisation, the spec, the packed batch and the CPU
gather must agree bit for bit. The models run the same batch (6 molecules
padded to 8) with the same weights, carried over by
``molkgnn_torch.training.checkpoint.from_jax_variables``, at tiny widths
(every width distinct, so that a transposition shows):

  * fp64 (JAX with jax_enable_x64, its float32-initialised variables cast
    to float64; the port in double): forward within 1e-9 relative to the
    largest value, parameter gradients of the BCE loss within 1e-9 of the
    largest gradient, in every output mode, with chiral message passing on
    and off, sigmoid and softmax c, sum and mean reduction;
  * three AdamW steps (weight decay 0.1, dropout 0) of the port's Trainer
    against the JAX Trainer in fp64: losses and every parameter within
    1e-7 relative (optax's fp32 bias corrections), the internal-coordinate
    encoder's parameters included, which only decay;
  * fp32 through the importer, the Predictor and the CLIs: 1e-5.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from molkgnn_torch.chem.smiles import parse_smiles as t_parse
from molkgnn_torch.cli import entry as t_entry
from molkgnn_torch.cli import import_ckpt as t_import
from molkgnn_torch.cli import screen as t_screen
from molkgnn_torch.data import qsar as t_qsar
from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.graphs import chiro as t_chiro
from molkgnn_torch.graphs.device_chiro import DeviceChiroDataset, gather_chiro
from molkgnn_torch.graphs.device_pack import pad_ids
from molkgnn_torch.models.chironet import ChIRoNet
from molkgnn_torch.models.registry import embedding_width, get_family
from molkgnn_torch.ops.segment import segment_max
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training import checkpoint as t_ckpt
from molkgnn_torch.training.model import GNNModel, bce_with_logits_loss
from molkgnn_torch.training.optim import fill_missing_grads
from molkgnn_torch.training.trainer import TrainConfig as TConfig
from molkgnn_torch.training.trainer import Trainer as TTrainer
from molkgnn_tpu.chem.smiles import parse_smiles as j_parse
from molkgnn_tpu.data import qsar as j_qsar
from molkgnn_tpu.data.dataset import Dataset as JDataset
from molkgnn_tpu.graphs import chiro as j_chiro
from molkgnn_tpu.models.chironet import ChIRoNet as JChIRoNet
from molkgnn_tpu.serving.predictor import Predictor as JPredictor
from molkgnn_tpu.training import TrainConfig as JConfig
from molkgnn_tpu.training import Trainer as JTrainer
from molkgnn_tpu.training import checkpoint as j_ckpt
from molkgnn_tpu.training.model import GNNModel as JGNNModel
from molkgnn_tpu.training.model import bce_with_logits_loss as j_bce
from test_torch_port_qsar import MALFORMED, _block, write_9999

# tests/test_chironet.py's molecules, and two with a tagged stereocentre.
SMILES = ["CCO", "CC(=O)O", "c1ccccc1O", "CCN(C)C", "CC(N)C(=O)O", "CCCC",
          "CC(F)Cl", "CC(N)F"]
SMALL = dict(f_z=(4, 3, 5), f_h=8, f_h_econv=6, econv_mlp_hidden=(5,),
             gat_hidden=(7,), gat_heads=2, hidden_d=(6,), hidden_phi=(6,),
             hidden_c=(6,), hidden_shift=(10, 6), hidden_alpha=(6,),
             cmp_econv_hidden=(9,), cmp_gat_layers=2, cmp_gat_heads=2)
CONFIGS = {
    "default": {},
    "conformer_softmax_mean": dict(output_mode="conformer",
                                   c_normalization="softmax",
                                   reduction="mean"),
    "both_cmp_sigmoid_mean": dict(output_mode="both",
                                  chiral_message_passing=True,
                                  reduction="mean"),
    "both_cmp_softmax_sum": dict(output_mode="both",
                                 chiral_message_passing=True,
                                 c_normalization="softmax"),
    "molecule_cmp_softmax_mean": dict(chiral_message_passing=True,
                                      c_normalization="softmax",
                                      reduction="mean"),
}
FLOATS = ("x", "edge_attr", "distances", "angles", "dihedrals", "y")
CLI_SMALL = ["--F_H", "8", "--F_H_EConv", "8", "--GAT_N_heads", "2",
             "--batch_size", "16", "--ffn_dropout_rate", "0",
             "--warmup_iterations", "3", "--peak_lr", "1e-2"]


def _molecules(smiles, seed):
    """(JAX molecules, port molecules) with one set of positions each."""
    rng = np.random.default_rng(seed)
    out = ([], [])
    for s in smiles:
        pair = (j_parse(s, add_hs=True), t_parse(s, add_hs=True))
        pos = rng.normal(size=(pair[0].num_atoms, 3)) * 1.3
        for m, mols in zip(pair, out):
            for a, p in zip(m.atoms, pos):
                a.x, a.y, a.z = map(float, p)
            mols.append(m)
    return out


@functools.lru_cache(maxsize=None)
def _graphs(seed=0, n_sets=1):
    """(JAX ChiroGraphs, port ChiroGraphs): ``n_sets`` conformers of each
    SMILES, labels alternating."""
    jg, tg = [], []
    for s in range(n_sets):
        jm, tm = _molecules(SMILES, seed + s)
        for a, b in zip(jm, tm):
            k = len(tg)
            jg.append(j_chiro.mol_to_chiro_graph(a, y=float(k % 2), idx=k))
            tg.append(t_chiro.mol_to_chiro_graph(b, y=float(k % 2), idx=k))
    assert all(g is not None for g in jg + tg)
    return jg, tg


def _double(batch, dtype=torch.float64):
    return dataclasses.replace(
        batch, **{f: getattr(batch, f).to(dtype) for f in FLOATS})


def _jdouble(batch):
    return dataclasses.replace(
        batch, **{f: np.asarray(getattr(batch, f), np.float64)
                  for f in FLOATS})


def _as64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree)


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(port model in eval mode, JAX model, JAX variables, port batch, JAX
    batch, spec) of one configuration: 6 molecules in a batch of 8. The
    JAX variables are the port's initial weights through the JAX importer
    (its template from ``jax.eval_shape``, no compile); the port model is
    loaded back from them through ``from_jax_variables``."""
    jg, tg = _graphs()
    spec = t_chiro.chiro_spec_for_graphs(tg, 8)
    jspec = j_chiro.chiro_spec_for_graphs(jg, 8)
    batch = t_chiro.batch_chiro(tg[:6], spec)
    jbatch = j_chiro.batch_chiro(jg[:6], jspec)
    cfg = dict(SMALL, **CONFIGS[name])
    jmodel = JGNNModel(encoder=JChIRoNet(**cfg), task_dim=1,
                       ffn_dropout_rate=0.0)
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jmodel.init, jax.random.key(0), jbatch))
    gen = torch.Generator().manual_seed(3)
    model = GNNModel(ChIRoNet(generator=gen, **cfg), ffn_dropout_rate=0.0,
                     generator=gen)
    v = j_ckpt.from_torch_state_dict(template, model.state_dict())
    model.load_state_dict(t_ckpt.from_jax_variables(v), strict=True)
    return model.eval(), jmodel, v, batch, jbatch, spec


@functools.lru_cache(maxsize=None)
def _jax64(name):
    """JAX in float64: ((prediction, embedding), parameter gradients of
    the mean BCE loss over the real graphs)."""
    _, jmodel, v, _, jbatch, _ = _setup(name)
    jb = _jdouble(jbatch)

    def run():
        def loss(params):
            out = jmodel.apply({"params": params}, jb)
            return j_bce(out[0], jb.y, jb.graph_mask), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _as64(v)["params"])
        return jax.device_get((out, grads))

    return _x64(run)


# ------------------------------------------------------------ featurisation
def test_featurisation_equals_jax():
    """Every ChiroGraph array, the spec and the packed batch, bit for bit;
    a molecule with no dihedral gives None in both."""
    jg, tg = _graphs()
    for a, b in zip(jg, tg):
        for f in dataclasses.fields(a):
            x, y = np.asarray(getattr(a, f.name)), np.asarray(
                getattr(b, f.name))
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert any(g.x[:, -8:-6].any() for g in tg)  # an R or S tag
    jm, tm = _molecules(["FC(Cl)Br"], 1)
    assert j_chiro.mol_to_chiro_graph(jm[0]) is None
    assert t_chiro.mol_to_chiro_graph(tm[0]) is None
    for b in (8, 3):
        spec = t_chiro.chiro_spec_for_graphs(tg, b)
        jspec = j_chiro.chiro_spec_for_graphs(jg, b)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    spec = t_chiro.chiro_spec_for_graphs(tg, 8)
    for ids in ([0, 1, 2, 3, 4, 5, 6, 7], [7, 2], []):
        got = t_chiro.batch_chiro([tg[i] for i in ids], spec)
        want = j_chiro.batch_chiro([jg[i] for i in ids], spec)
        for f in dataclasses.fields(want):
            w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)
            assert g.numpy().dtype == w.dtype, f.name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
    with pytest.raises(ValueError, match="exceeds capacity"):
        t_chiro.batch_chiro(tg, t_chiro.chiro_spec_for_graphs(tg[:1], 8))


def test_gather_chiro_equals_batch_chiro():
    """The device gather on CPU tensors equals the host packer bit for
    bit, for full, padded and shuffled id sets."""
    _, tg = _graphs()
    spec = t_chiro.chiro_spec_for_graphs(tg, 8)
    data = DeviceChiroDataset.from_graphs(tg)
    for ids in ([0, 1, 2, 3, 4, 5, 6, 7], [6, 0, 3], [5]):
        ids = np.asarray(ids, np.int32)
        got = gather_chiro(data, torch.as_tensor(pad_ids(ids, 8)), spec)
        want = t_chiro.batch_chiro([tg[i] for i in ids], spec)
        for f, a, b in zip(dataclasses.fields(got), got.leaves(),
                           want.leaves()):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_segment_max_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    v[[2, 9]] = -np.inf
    ids = rng.integers(0, 12, 30).astype(np.int32)
    ids[ids == 5] = 6  # an empty segment
    want = np.asarray(jax.ops.segment_max(v, ids, num_segments=12))
    got = segment_max(torch.tensor(v), torch.tensor(ids), 12).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_gradients_match_jax_fp64(name):
    """Prediction, embedding and every parameter's gradient (the unused
    internal-coordinate encoder's are zero) against jax.grad in fp64, on
    a padded batch."""
    model, _, _, batch, _, _ = _setup(name)
    (jout, jgrads) = _jax64(name)
    model.double().zero_grad(set_to_none=True)
    b64 = _double(batch)
    pred, emb = model(b64)
    bce_with_logits_loss(pred, b64.y, b64.graph_mask).backward()
    unused = [n for n, p in model.named_parameters() if p.grad is None]
    fill_missing_grads(list(model.parameters()))
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    outs = [pred.detach().numpy(), emb.detach().numpy()]
    model.float().zero_grad(set_to_none=True)
    if name == "default":
        assert unused and all("InternalCoordinateEncoder" in n
                              for n in unused)
    for g, w in zip(outs, jout):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())
    want = t_ckpt.from_jax_variables({"params": jgrads})
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert torch.isfinite(w).all(), k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["default", "both_cmp_softmax_sum"])
def test_forward_matches_jax_fp32(name):
    model, jmodel, v, batch, jbatch, _ = _setup(name)
    want = [np.asarray(a) for a in jax.jit(jmodel.apply)(v, jbatch)]
    with torch.no_grad():
        got = [t.numpy() for t in model(batch)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", ["default", "both_cmp_sigmoid_mean"])
def test_padding_invariance(name):
    """Two molecules alone in the batch score as they do among six."""
    model, _, _, batch, _, spec = _setup(name)
    _, tg = _graphs()
    few = t_chiro.batch_chiro(tg[:2], spec)
    with torch.no_grad():
        full, part = model(batch)[1], model(few)[1]
    np.testing.assert_allclose(part[:2].numpy(), full[:2].numpy(),
                               rtol=1e-6, atol=1e-6)
    if CONFIGS[name].get("output_mode", "molecule") == "molecule":
        assert torch.all(part[2:] == 0)


def test_skipped_encoder_changes_nothing():
    """In molecule mode without chiral message passing the
    internal-coordinate encoder is skipped; a 'both' model with the same
    weights runs it, and its molecule columns equal the molecule model's
    output bit for bit. The embedding width follows the output mode."""
    model, _, _, batch, _, _ = _setup("default")
    both = GNNModel(ChIRoNet(**SMALL, output_mode="both"),
                    ffn_dropout_rate=0.0)
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("ffn.")}
    both.load_state_dict(sd, strict=False)
    with torch.no_grad():
        a = model.gnn_model(batch)
        b = both.gnn_model.eval()(batch)
    assert torch.equal(b[:, :SMALL["f_h"]], a)
    assert embedding_width(model.gnn_model) == 8
    assert embedding_width(both.gnn_model) == 8 + 12
    assert embedding_width(ChIRoNet(**SMALL, output_mode="conformer")) == 12


def test_mirror_flips_the_tags_and_the_output():
    """A mirror image swaps the R and S tags, and the embedding moves."""
    model, _, _, _, _, spec = _setup("default")
    _, tm = _molecules(["CC(F)Cl", "CC(N)F"], 5)
    graphs, mirrored = [], []
    for m in tm:
        graphs.append(t_chiro.mol_to_chiro_graph(m))
        for a in m.atoms:
            a.x = -a.x
        mirrored.append(t_chiro.mol_to_chiro_graph(m))
    for g, h in zip(graphs, mirrored):
        tags = g.x[:, -8:-6]  # R, S
        assert tags.any()
        np.testing.assert_array_equal(h.x[:, -8:-6], tags[:, ::-1])
    with torch.no_grad():
        a = model(t_chiro.batch_chiro(graphs, spec))[1]
        b = model(t_chiro.batch_chiro(mirrored, spec))[1]
    assert float((a - b)[:2].abs().max()) > 1e-4


# ---------------------------------------------------------- weight bridge
@pytest.mark.parametrize("name", ["default", "both_cmp_softmax_sum"])
def test_state_dict_round_trip(name):
    """The port's state_dict goes through the JAX importer with no missing
    or leftover key (it raises on either) to the JAX variables it came
    from, and through the port's importer to itself; a missing or an extra
    key is refused."""
    model, _, v, _, _, _ = _setup(name)
    sd = model.state_dict()
    back = j_ckpt.from_torch_state_dict(v, sd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref = {"model." + k: t for k, t in sd.items()}
    ref["model.lin1.weight"] = torch.zeros(2, 2)
    got = t_ckpt.from_torch_state_dict(model, ref, prefix="model.")
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    key = "model.gnn_model.encoder.Graph_Embedder.EConv.lin.weight"
    with pytest.raises(KeyError, match="missing"):
        t_ckpt.from_torch_state_dict(
            model, {k: t for k, t in ref.items() if k != key},
            prefix="model.")
    with pytest.raises(ValueError, match="no target"):
        t_ckpt.from_torch_state_dict(
            model, {**ref, "model.gnn_model.encoder.extra": torch.ones(1)},
            prefix="model.")


def test_reference_ckpt_scores_like_the_jax_import(tmp_path):
    """A reference-layout .ckpt loads through the port's importer and
    through the JAX package's; both models score the batch alike."""
    model, jmodel, v, batch, jbatch, _ = _setup("both_cmp_sigmoid_mean")
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {"model." + k: t for k, t in
                               model.state_dict().items()}}, path)
    fresh = GNNModel(ChIRoNet(**SMALL, **CONFIGS["both_cmp_sigmoid_mean"]),
                     ffn_dropout_rate=0.0)
    fresh.load_state_dict(t_ckpt.load_torch_checkpoint(
        path, fresh, prefix="model."), strict=True)
    jv = j_ckpt.load_torch_checkpoint(path, v, prefix="model.")
    want = np.asarray(jax.jit(jmodel.apply)(jv, jbatch)[0])
    with torch.no_grad():
        got = fresh.eval()(batch)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module")
def trained():
    """Three fp64 AdamW steps of the JAX Trainer and the port's from the
    same weights on the same ids: (JAX losses and variables per step,
    port losses and state dicts per step)."""
    jg, tg = _graphs(seed=10, n_sets=2)
    split = {"train": np.arange(10), "valid": np.arange(10, 13),
             "test": np.arange(13, 16)}
    metrics = list(QSAR_METRICS)
    jds = JDataset("chiro", jg, split, metrics, "bce_with_logits")
    tds = TDataset("chiro", tg, split, metrics, "bce_with_logits")
    spec = t_chiro.chiro_spec_for_graphs(tg, 4)
    jspec = j_chiro.chiro_spec_for_graphs(jg, 4)
    kw = dict(batch_size=4, max_epochs=1, warmup_iterations=2,
              weight_decay=0.1, progress=False)
    rng = np.random.default_rng(0)
    ids = [rng.choice(10, 4, replace=False).astype(np.int32)
           for _ in range(3)]
    ids[2][3:] = -1  # a padded batch

    def run_jax():
        jt = JTrainer(JGNNModel(encoder=JChIRoNet(**SMALL),
                                ffn_dropout_rate=0.0),
                      jds, jspec, JConfig(**kw), collate=j_chiro.batch_chiro)
        params = _as64(jax.device_get(jt.state.params))
        jt.state = jt.state.replace(params=params,
                                    opt_state=jt.tx.init(params))
        jt._device_data = _as64(jax.device_get(jt._device_data))
        v0 = {"params": jax.device_get(jt.state.params)}
        st, steps = jt.state, []
        for idv in ids:
            st, loss = jt._train_step_ids(st, jt._device_data, idv)
            steps.append((float(loss),
                          {"params": jax.device_get(st.params)}))
        return v0, steps

    v0, jsteps = _x64(run_jax)
    model = GNNModel(ChIRoNet(**SMALL), ffn_dropout_rate=0.0).double()
    model.load_state_dict(t_ckpt.from_jax_variables(v0), strict=True)
    tt = TTrainer(model, tds, spec, TConfig(**kw), device="cpu")
    dd = tt._device_data
    tt._device_data = dataclasses.replace(dd, **{
        f: getattr(dd, f).double()
        for f in ("x", "edge_attr", "dist_val", "ang_val", "dih_val", "y")})
    tsteps = []
    for idv in ids:
        loss = float(tt._step_ids(idv))
        tsteps.append((loss, {k: t.clone()
                              for k, t in model.state_dict().items()}))
    return jsteps, tsteps, v0


def test_three_steps_match_jax(trained):
    jsteps, tsteps, v0 = trained
    start = t_ckpt.from_jax_variables(v0)
    for (jl, jv), (tl, tsd) in zip(jsteps, tsteps):
        np.testing.assert_allclose(tl, jl, rtol=1e-7)
        want = t_ckpt.from_jax_variables(jv)
        assert set(want) == set(tsd)
        for k, w in want.items():
            np.testing.assert_allclose(tsd[k].numpy(), w.numpy(),
                                       rtol=1e-7, atol=1e-9, err_msg=k)
    # The encoder's parameters took no gradient: each only decayed, by
    # (1 - lr * 0.1) a step.
    k = ("gnn_model.encoder.InternalCoordinateEncoder.Encoder_c."
         "linear_layers.0.weight")
    final = tsteps[-1][1][k]
    assert not torch.equal(final, start[k].double())
    np.testing.assert_allclose(
        (final / start[k].double()).numpy().std(), 0.0, atol=1e-12)


def test_trainer_fit_on_cpu_scan_steps(tmp_path):
    """Trainer.fit with scan_steps=4 (K eager steps on the CPU) equals
    scan_steps=1 bit for bit on the device-data path with device sampling;
    the host loader's path runs too."""
    _, tg = _graphs(seed=20, n_sets=2)
    ds = TDataset("chiro", list(tg), {"train": np.arange(10),
                                      "valid": np.arange(10, 13),
                                      "test": np.arange(13, 16)},
                  list(QSAR_METRICS), "bce_with_logits")
    spec = get_family("chironet").make_spec(tg, 4)
    runs = []
    for k, device_data in ((1, True), (4, True), (1, False)):
        gen = torch.Generator().manual_seed(0)
        model = GNNModel(ChIRoNet(generator=gen, **SMALL), generator=gen)
        tr = TTrainer(model, ds, spec, TConfig(
            batch_size=4, max_epochs=2, scan_steps=k, progress=False,
            oversample=True, device_sampling=device_data,
            use_device_data=device_data, warmup_iterations=2,
            log_dir=str(tmp_path / f"{k}{device_data}")), device="cpu")
        tr.fit()
        runs.append((tr.step_losses, {n: p.detach().clone()
                                      for n, p in model.named_parameters()}))
    (l1, p1), (l4, p4), (lh, _) = runs
    assert len(l1) == len(l4) > 4 and l1 == l4
    assert all(np.isfinite(l1)) and all(np.isfinite(lh))
    assert all(torch.equal(p1[n], p4[n]) for n in p1)


# ----------------------------------------------------------------- serving
def test_predictor_screen_and_export_match_jax(tmp_path):
    """predict_graphs against the JAX Predictor, screen_library (over two
    slabs) against predict_graphs, the exported program against both, and
    predict_smiles with an unparseable SMILES and one with no dihedral."""
    model, jmodel, v, _, _, _ = _setup("both_cmp_softmax_sum")
    jg, tg = _graphs()
    spec = t_chiro.chiro_spec_for_graphs(tg, 4)
    jspec = j_chiro.chiro_spec_for_graphs(jg, 4)
    pred = Predictor(model, model.state_dict(), spec, device="cpu")
    want = JPredictor(jmodel, v["params"], {}, jspec).predict_graphs(jg)
    got = pred.predict_graphs(tg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pred.screen_library(tg, slab=5), got)
    assert len(pred.screen_slabs) == 2
    path = str(tmp_path / "chiro.pt2")
    pred.export(path)
    call, spec2 = Predictor.load_exported(path, "cpu")
    assert spec2 == spec
    out = call(t_chiro.batch_chiro(tg[:4], spec2))[0].numpy()
    np.testing.assert_allclose(out, got[:4], rtol=1e-6, atol=1e-6)
    scores = pred.predict_smiles(["CCO", "bad((", "FC(Cl)Br", "CC(N)F"])
    assert np.isnan(scores[[1, 2]]).all() and np.isfinite(scores[[0, 3]]).all()


# ---------------------------------------------------------- ingest and CLI
@pytest.fixture(scope="module")
def qsar_root(tmp_path_factory):
    base = tmp_path_factory.mktemp("chiro_qsar")
    write_9999(str(base / "qsar" / "clean_sdf" / "raw"))
    return str(base)


def test_qsar_ingest_and_cache_match_jax(qsar_root):
    """The ChIRoNet ingest of the AID-9999 pair equals the JAX package's
    (graphs and invalid records: the malformed one and the molecules with
    no dihedral); the port's .npz cache reads back to the same graphs and
    the dataset's split drops the invalid records."""
    root = os.path.join(qsar_root, "qsar", "clean_sdf")
    want, jinvalid = j_qsar.ingest_qsar_sdf(root, "9999", progress=False,
                                            gnn_type="chironet")
    got, invalid = t_qsar.ingest_qsar_sdf(root, "9999", progress=False,
                                          gnn_type="chironet")
    assert invalid == jinvalid and len(invalid) > 1
    assert len(got) == len(want) == 263 - len(invalid)
    cache = os.path.join(root, "processed", "chironet-9999-3D-native.npz")
    assert not os.path.exists(cache)
    first = t_qsar.load_qsar_dataset(root, "9999", gnn_type="chironet")
    assert os.path.exists(cache)
    again = t_qsar.load_qsar_dataset(root, "9999", gnn_type="chironet")
    for ds in (first, again):
        assert len(ds.graphs) == len(want)
        for a, b in zip(want, ds.graphs):
            for f in dataclasses.fields(a):
                x = np.asarray(getattr(a, f.name))
                y = np.asarray(getattr(b, f.name))
                assert x.dtype == y.dtype or f.name == "smiles", f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert {k: list(v) for k, v in first.split.items()} == {
        k: list(v) for k, v in again.split.items()}
    dropped = {i for i, _ in invalid}
    kept = {g.idx for g in first.graphs}
    assert not dropped & kept


def test_cli_import_and_screen(qsar_root, tmp_path, capsys):
    """`--gnn_type chironet --device cpu`: a fit and test with artifacts,
    then --test on the same root; a reference-layout .ckpt through the
    import CLI and the screen CLI: the CSV equals a Predictor's scores,
    and the malformed record and the one with no dihedral get empty
    cells."""
    root = tmp_path / "run"
    argv = ["--gnn_type", "chironet", "--device", "cpu", "--dataset_name",
            "9999", "--dataset_path", qsar_root, "--max_epochs", "1",
            "--default_root_dir", str(root), *CLI_SMALL]
    assert t_entry.main(argv) == 0
    logs = root / "logs"
    for f in ("test_result.log", "history.json", "graph_embedding.npy",
              "task_info.log"):
        assert (logs / f).exists(), f
    assert not (logs / "kernels").exists()  # kgnn only
    assert (root / "checkpoints" / "last.pt").exists()
    assert t_entry.main(argv + ["--test"]) == 0

    sdf = tmp_path / "lib.sdf"
    with open(sdf, "w") as f:  # POOL[20] of _block is FC(Cl)Br
        for i in range(12):
            f.write(MALFORMED if i == 4 else _block(20 if i == 7 else i,
                                                    500 + i))
            f.write("$$$$\n")
    ckpt = str(tmp_path / "ref.ckpt")
    art, csv = str(tmp_path / "chiro.pt2"), str(tmp_path / "scores.csv")
    flags = ["--gnn_type", "chironet", "--F_H", "8", "--F_H_EConv", "6",
             "--GAT_N_heads", "2", "--seed", "5"]
    cli_model = t_entry.build_model(t_entry.build_parser("chironet")
                                    .parse_args(flags + ["--device", "cpu"]))
    torch.save({"state_dict": {"model." + k: t for k, t in
                               cli_model.state_dict().items()}}, ckpt)
    assert t_import.main(["--torch_ckpt", ckpt, "--sdf", str(sdf), "--out",
                          art, "--batch_size", "4", "--prefix", "model.",
                          "--device", "cpu", *flags]) == 0
    assert t_screen.main(["--exported", art, "--sdf", str(sdf), "--out",
                          csv, "--device", "cpu"]) == 0
    rows = [line.split(",") for line in open(csv).read().splitlines()[1:]]
    assert len(rows) == 12 and rows[4][1] == "" and rows[7][1] == ""
    got = np.array([float(s) for i, s in rows if i not in ("4", "7")])
    _, spec = Predictor.load_exported(art, "cpu")
    assert isinstance(spec, t_chiro.ChiroBatchSpec)
    from molkgnn_torch.chem.sdf import parse_sdf

    graphs = [t_chiro.mol_to_chiro_graph(m) for m, _ in parse_sdf(str(sdf))
              if m is not None]
    graphs = [g for g in graphs if g is not None]
    want = Predictor(cli_model, cli_model.state_dict(), spec,
                     device="cpu").predict_graphs(graphs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
