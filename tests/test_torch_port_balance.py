"""Port parity: balanced batches (graphs/balance.py) and the balanced Trainer.

The port's copy of the balance functions against the JAX package's on the
same graphs: bit-equal results, and the same field named where a batch
overflows. The port's ``Trainer(balanced_batches=True, device="cpu")``
against the JAX ``Trainer(balanced_batches=True)``: the same dealt id
matrices from the same seed; from the same weights (the weight bridge),
three steps on the dealt batches in fp64 within rtol 1e-7 / atol 1e-9 (the
tolerance of ``tests/test_torch_port_training.py::
test_three_steps_match_jax``), and the balanced evaluation's predictions in
the caller's order (the JAX package writes them into a float32 array,
within the same tolerance). Tens of tie-free molecules, two layers.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.dataset import (
    make_synthetic_dataset,
    oversampling_weights,
)
from molkgnn_torch.data.synthetic import tie_free_molgraph
from molkgnn_torch.graphs import balance as t_bal
from molkgnn_torch.graphs.batch import spec_for_graphs as t_spec
from molkgnn_torch.models.kgnn import MolKGNNNet as TNet
from molkgnn_torch.models.registry import get_family
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.model import GNNModel as TModel
from molkgnn_torch.training.trainer import TrainConfig as TConfig
from molkgnn_torch.training.trainer import Trainer as TTrainer
from molkgnn_tpu.data.dataset import Dataset as JDataset
from molkgnn_tpu.graphs import balance as j_bal
from molkgnn_tpu.graphs.batch import BatchSpec as JSpec
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import MolKGNNNet as JNet
from molkgnn_tpu.training import GNNModel as JModel
from molkgnn_tpu.training import TrainConfig as JConfig
from molkgnn_tpu.training import Trainer as JTrainer

CFG = dict(num_layers=2, kernels_1hop=(2, 3, 2, 3), kernels_nhop=(2, 3, 2, 3),
           graph_embedding_dim=8)
KW = dict(batch_size=8, max_epochs=2, warmup_iterations=3, weight_decay=0.1,
          progress=False, balanced_batches=True)
R64 = dict(rtol=1e-7, atol=1e-9)


def _jgraph(g):
    jg = JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                   edge_attr=g.edge_attr, y=g.y,
                   atomic_num=g.atomic_num).with_fields()
    jg.idx = g.idx
    return jg


@pytest.fixture(scope="module")
def data():
    """48 tie-free molecules of varied size, 0/1 labels, split 32/8/8, as a
    port and a JAX dataset sharing the graphs' arrays and split."""
    rng = np.random.default_rng(12)
    graphs = [tie_free_molgraph(rng) for _ in range(48)]
    for i, g in enumerate(graphs):
        g.y, g.idx = float(rng.random() < 0.4), i
    perm = rng.permutation(48)
    split = {"train": np.sort(perm[:32]), "valid": np.sort(perm[32:40]),
             "test": np.sort(perm[40:])}
    args = ("tie_free", list(QSAR_METRICS), "bce_with_logits")
    tds = TDataset(args[0], graphs, split, *args[1:])
    jds = JDataset(args[0], [_jgraph(g) for g in graphs], split, *args[1:])
    return tds, jds


def _spec_equal(t, j):
    return dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------------- functions
def test_count_matrix_and_deal_are_bit_equal(data):
    tds, jds = data
    counts = t_bal.count_matrix(tds.graphs)
    np.testing.assert_array_equal(counts, j_bal.count_matrix(jds.graphs))
    assert counts.dtype == np.int64
    rng = np.random.default_rng(3)
    for n, bs in ((101, 16), (48, 8), (5, 8)):
        ids = rng.choice(48, size=n, replace=True)
        sizes = counts[ids, t_bal.SIZE_FIELD]
        t_out, j_out = (m.deal_by_size(ids, sizes, bs)
                        for m in (t_bal, j_bal))
        for t, j in zip(t_out, j_out):
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype == np.int32
        np.testing.assert_array_equal(
            t_bal.batch_field_sums(t_out[0], counts),
            j_bal.batch_field_sums(j_out[0], counts))


@pytest.mark.parametrize("oversample", [True, False])
def test_specs_are_bit_equal(data, oversample):
    """spec_for_dataset (every split's pool, the oversampled train draw)
    and spec_for_sampler with its defaults and with other epochs, slack,
    seed and alignment."""
    tds, jds = data
    assert _spec_equal(t_bal.spec_for_dataset(tds, 8, oversample=oversample),
                       j_bal.spec_for_dataset(jds, 8, oversample=oversample))
    kw = dict(epochs=4, slack=1.2, seed=5, node_align=16)
    assert _spec_equal(t_bal.spec_for_sampler(tds.graphs, 16, **kw),
                       j_bal.spec_for_sampler(jds.graphs, 16, **kw))
    assert _spec_equal(t_bal.spec_for_sampler(tds.graphs, 8),
                       j_bal.spec_for_sampler(jds.graphs, 8))


@pytest.mark.parametrize("field", range(6))
def test_check_batches_fit_raises_on_the_same_field(data, field):
    """A spec one short of a dealt batch's sum in one field: both packages
    raise and name that field; with the sum itself, both pass."""
    tds, jds = data
    counts = t_bal.count_matrix(tds.graphs)
    ids = np.asarray(tds.split["train"])
    idm, _ = t_bal.deal_by_size(ids, counts[ids, t_bal.SIZE_FIELD], 8)
    caps = t_bal.batch_field_sums(idm, counts).max(0)
    fit = dict(num_graphs=8, num_nodes=int(caps[0]), num_edges=int(caps[1]),
               deg_capacity=tuple(int(c) for c in caps[2:]))
    short = list(caps)
    short[field] -= 1
    tight = dict(num_graphs=8, num_nodes=int(short[0]),
                 num_edges=int(short[1]),
                 deg_capacity=tuple(int(c) for c in short[2:]))
    name = t_bal.FIELD_NAMES[field]
    assert name == j_bal.FIELD_NAMES[field]
    for mod, spec in ((t_bal, t_bal.BatchSpec), (j_bal, JSpec)):
        mod.check_batches_fit(idm, counts, spec(**fit))
        with pytest.raises(ValueError, match=f"exceeds spec {name} "):
            mod.check_batches_fit(idm, counts, spec(**tight))


def test_balanced_spec_is_tighter_and_every_epoch_fits():
    """On 256 synthetic molecules (the JAX package's test_balance set) the
    dealt spec is smaller than the cover spec in every field, and dealt
    oversampled epochs from fresh seeds fit it."""
    ds = make_synthetic_dataset(seed=0, num_graphs=256)
    tight = t_bal.spec_for_dataset(ds, 32)
    cover = t_spec(ds.graphs, 32)
    assert (t_bal.caps_vector(tight) < t_bal.caps_vector(cover)).all()
    counts = t_bal.count_matrix(ds.graphs)
    train = np.asarray(ds.split["train"])
    labels = np.array([ds.graphs[i].y for i in train])
    p = oversampling_weights(labels)
    for seed in range(5):
        draw = np.random.default_rng(100 + seed).choice(
            train, size=len(train), p=p / p.sum())
        idm, _ = t_bal.deal_by_size(draw, counts[draw, t_bal.SIZE_FIELD], 32)
        t_bal.check_batches_fit(idm, counts, tight)


# ---------------------------------------------------------------- Trainer
@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _variables(state):
    return jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX balanced Trainer in fp64: two epochs' dealt id matrices,
    then from its initial state three steps on the first dealt batches and
    the test split's balanced predictions."""
    tds, jds = data
    jspec = j_bal.spec_for_dataset(jds, 8)
    with _x64():
        jt = JTrainer(
            JModel(encoder=JNet(**CFG), ffn_dropout_rate=0.0), jds, jspec,
            JConfig(**KW, log_dir=str(tmp_path_factory.mktemp("jax")))
        )
        params = _f64(jt.state.params)
        jt.state = jt.state.replace(
            params=params, batch_stats=_f64(jt.state.batch_stats),
            opt_state=jt.tx.init(params))
        jt._device_data = _f64(jt._device_data)
        v0 = _variables(jt.state)
        epochs = [np.stack(list(jt._epoch_id_batches(jt.config)))
                  for _ in range(2)]
        steps = []
        for ids in epochs[0][:3]:
            jt.state, loss = jt._train_step_ids(jt.state, jt._device_data,
                                                ids)
            steps.append((float(loss), _variables(jt.state)))
        true, pred = jt._predict_ids(jds.split["test"])
    return dict(spec=jspec, v0=v0, epochs=epochs, steps=steps,
                test=(true, pred))


def _port(data, jax_run, tmp_path, **kw):
    tds, _ = data
    model = TModel(TNet(**CFG), ffn_dropout_rate=0.0).double()
    model.load_state_dict(from_jax_variables(jax_run["v0"]), strict=True)
    spec = t_bal.spec_for_dataset(tds, 8)
    assert _spec_equal(spec, jax_run["spec"])
    tt = TTrainer(model, tds, spec, TConfig(**dict(KW, **kw),
                                            log_dir=str(tmp_path)),
                  device="cpu")
    dd = tt._device_data
    tt._device_data = dataclasses.replace(
        dd, x=dd.x.double(), p=dd.p.double(),
        edge_attr=dd.edge_attr.double(), y=dd.y.double(),
        deg_ea=tuple(a.double() for a in dd.deg_ea))
    return tt


def test_balanced_trainer_deals_the_jax_id_matrices(data, jax_run, tmp_path):
    """Two epochs of dealt ids equal the JAX Trainer's; each epoch's
    multiset is the unbalanced Trainer's draw from the same seed."""
    tt = _port(data, jax_run, tmp_path)
    plain = _port(data, jax_run, tmp_path, balanced_batches=False)
    for want in jax_run["epochs"]:
        got = np.stack(list(tt._epoch_id_batches()))
        np.testing.assert_array_equal(got, want)
        drawn = np.stack(list(plain._epoch_id_batches()))
        assert sorted(got[got >= 0]) == sorted(drawn[drawn >= 0])


def test_balanced_three_steps_and_test_predictions_match_jax(
        data, jax_run, tmp_path):
    tt = _port(data, jax_run, tmp_path)
    for ids, (want_loss, want_vars) in zip(jax_run["epochs"][0],
                                           jax_run["steps"]):
        np.testing.assert_allclose(float(tt._step_ids(ids)), want_loss,
                                   rtol=1e-7)
        want = from_jax_variables(want_vars)
        got = tt.model.state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       err_msg=k, **R64)
    true, pred = tt._predict_ids(data[0].split["test"])
    np.testing.assert_array_equal(true, jax_run["test"][0])
    np.testing.assert_allclose(pred, jax_run["test"][1], **R64)


def test_balanced_evaluation_equals_cover_evaluation(data, tmp_path):
    """The same weights score the same graphs alike under the dealt tight
    spec and the consecutive cover spec, in the caller's order; the graph
    embeddings are written in split order alike."""
    tds, _ = data
    gen = torch.Generator().manual_seed(0)
    model = TModel(TNet(**CFG, generator=gen), generator=gen)
    out = {}
    for name, spec, balanced in (
            ("cover", t_spec(tds.graphs, 8), False),
            ("balanced", t_bal.spec_for_dataset(tds, 8), True)):
        tt = TTrainer(model, tds, spec, TConfig(
            batch_size=8, progress=False, balanced_batches=balanced,
            log_dir=str(tmp_path / name)), device="cpu")
        ids = np.concatenate([tds.split["valid"], tds.split["train"]])
        tt.save_graph_embedding(str(tmp_path / name))
        out[name] = (tt._predict_ids(ids),
                     np.load(tmp_path / name / "graph_embedding.npy"))
    (t_c, p_c), e_c = out["cover"]
    (t_b, p_b), e_b = out["balanced"]
    np.testing.assert_array_equal(t_c, t_b)
    np.testing.assert_allclose(p_b, p_c, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(e_b, e_c, rtol=1e-6, atol=1e-6)
    assert e_b.shape == (len(tds.split["test"]), 8)


def test_balanced_trainer_refusals_and_host_check(data, tmp_path):
    """Balanced mode needs the device-data path and kgnn batches, and
    excludes device sampling; a dealt epoch that overflows the spec raises
    on the host before any step."""
    tds, _ = data
    spec = t_bal.spec_for_dataset(tds, 8)
    model = TModel(TNet(**CFG), ffn_dropout_rate=0.0)

    def make(spec=spec, **kw):
        return TTrainer(model, tds, spec, TConfig(
            **dict(KW, **kw), log_dir=str(tmp_path)), device="cpu")

    with pytest.raises(ValueError, match="device-data path"):
        make(use_device_data=False)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make(device_sampling=True, oversample=True)
    point_spec = get_family("schnet").make_spec(tds.graphs, batch_size=8)
    with pytest.raises(ValueError, match="kgnn batches"):
        make(spec=point_spec)
    small = dataclasses.replace(spec, num_edges=spec.num_edges // 4)
    tt = make(spec=small)
    with pytest.raises(ValueError, match="exceeds spec edges"):
        tt.fit()
    assert tt.step == 0


def test_balanced_embeddings_where_consecutive_chunks_overflow(tmp_path):
    """On 4096 synthetic molecules at batch 16, consecutive chunks of the
    test split overflow the tight spec (the JAX Trainer's
    save_graph_embedding packs such chunks on the host, whose packer then
    raises); the port's balanced Trainer deals them and writes the
    embeddings of the cover spec's run, in split order."""
    ds = make_synthetic_dataset(seed=0, num_graphs=4096)
    tight = t_bal.spec_for_dataset(ds, 16)
    counts = t_bal.count_matrix(ds.graphs)
    test = np.asarray(ds.split["test"])
    chunks = np.stack([np.pad(test[s:s + 16], (0, max(0, s + 16 - len(test))),
                              constant_values=-1)
                       for s in range(0, len(test), 16)])
    with pytest.raises(ValueError, match="exceeds spec"):
        t_bal.check_batches_fit(chunks, counts, tight)
    gen = torch.Generator().manual_seed(1)
    model = TModel(TNet(num_layers=1, kernels_1hop=(2, 3, 2, 3),
                        graph_embedding_dim=4, generator=gen), generator=gen)
    out = {}
    for name, spec, balanced in (("cover", t_spec(ds.graphs, 16), False),
                                 ("balanced", tight, True)):
        TTrainer(model, ds, spec, TConfig(
            batch_size=16, progress=False, balanced_batches=balanced,
            log_dir=str(tmp_path)), device="cpu").save_graph_embedding(
            str(tmp_path / name))
        out[name] = np.load(tmp_path / name / "graph_embedding.npy")
    assert out["balanced"].shape == (len(test), 4)
    np.testing.assert_allclose(out["balanced"], out["cover"], rtol=1e-6,
                               atol=1e-6)
