"""Port parity: datasets, host packing, on-device batch assembly, sampling.

Array comparisons are exact: the port's ``PackedGraphs.pack`` and
``gather_batch`` (on CPU tensors) must equal the JAX package's packers and
the port's ``batch_graphs`` bit for bit, and the same seed must draw the
same graphs, splits and batch ids.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.data import dataset as t_data
from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
from molkgnn_torch.graphs.device_pack import (
    DeviceDataset,
    gather_batch,
    pad_ids,
)
from molkgnn_torch.graphs.molgraph import MolGraph
from molkgnn_torch.graphs.packed import PackedGraphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.data import dataset as j_data
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs import device_pack as j_device
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.graphs.packed import PackedGraphs as JPackedGraphs
from molkgnn_tpu.training.trainer import TrainConfig as JTrainConfig
from molkgnn_tpu.training.trainer import Trainer as JTrainer


def _jax_graphs(graphs):
    out = []
    for g in graphs:
        jg = JMolGraph(
            x=g.x, p=g.p, edge_index=g.edge_index, edge_attr=g.edge_attr,
            y=g.y, atomic_num=g.atomic_num,
        ).with_fields()
        jg.idx = g.idx
        out.append(jg)
    return out


def _chain(rng, n):
    """A path molecule: degrees 1 and 2 only."""
    ei = [(u, v) for i in range(n - 1) for u, v in ((i, i + 1), (i + 1, i))]
    g = MolGraph(
        x=rng.standard_normal((n, 28)).astype(np.float32),
        p=rng.standard_normal((n, 3)).astype(np.float32),
        edge_index=np.array(ei, np.int32).T,
        edge_attr=np.repeat(
            rng.standard_normal((n - 1, 7)).astype(np.float32), 2, axis=0
        ),
        y=float(rng.random() < 0.5),
    )
    return g.with_fields()


def _graph_sets():
    """Synthetic molecules (all degrees), and chains, whose dataset has no
    degree-3 or degree-4 atom at all."""
    rng = np.random.default_rng(0)
    chains = [_chain(rng, int(rng.integers(3, 9))) for _ in range(10)]
    return {
        "synthetic": t_data.make_synthetic_dataset(seed=2, num_graphs=24)
        .graphs,
        "chains": chains,
    }


def _fields(batch):
    """Every array of a batch, flat, by name (torch or numpy/jax)."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


def _assert_same(got, want):
    got, want = _fields(got), _fields(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["synthetic", "chains"])
@pytest.mark.parametrize("take", ["full", "partial"])
def test_pack_and_gather_match_jax_and_batch_graphs(name, take):
    """pack and gather_batch (ids -1 padded) against the JAX packers and
    batch_graphs; the chains exercise the empty-degree buckets."""
    graphs = _graph_sets()[name]
    spec = spec_for_graphs(graphs, 8)
    jgraphs = _jax_graphs(graphs)
    jspec = j_batch.spec_for_graphs(jgraphs, 8)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    ids = np.array([5, 0, 7, 3, 9, 1, 2, 8][: 8 if take == "full" else 5])
    padded = pad_ids(ids, 8)

    packed = PackedGraphs.from_graphs(graphs)
    got_pack = packed.pack(ids, spec)
    _assert_same(got_pack, batch_graphs([graphs[i] for i in ids], spec))
    _assert_same(got_pack, JPackedGraphs.from_graphs(jgraphs).pack(ids, jspec))

    data = DeviceDataset.from_packed(packed)
    got_gather = gather_batch(data, torch.from_numpy(padded), spec)
    _assert_same(got_gather, got_pack)
    jdata = j_device.DeviceDataset.from_packed(
        JPackedGraphs.from_graphs(jgraphs)
    )
    _assert_same(
        got_gather, j_device.gather_batch(jdata, jnp.asarray(padded), jspec)
    )
    if name == "chains":
        assert not got_gather.deg3.mask.any() and not got_gather.deg4.mask.any()


def test_pack_raises_over_capacity():
    graphs = _graph_sets()["synthetic"]
    spec = spec_for_graphs(graphs, 2)
    with pytest.raises(ValueError):
        PackedGraphs.from_graphs(graphs).pack(np.arange(3), spec)


def test_datasets_match_jax():
    """The same seed gives the same molecules, labels and splits."""
    for make in ("make_synthetic_dataset", "make_motif_dataset"):
        got = getattr(t_data, make)(seed=3, num_graphs=20)
        want = getattr(j_data, make)(seed=3, num_graphs=20)
        assert (got.name, got.metrics, got.loss_name) == (
            want.name, want.metrics, want.loss_name
        )
        for part in ("train", "valid", "test"):
            np.testing.assert_array_equal(got.split[part], want.split[part])
        for g, w in zip(got.graphs, want.graphs):
            assert (g.y, g.idx) == (w.y, w.idx)
            for f in ("x", "p", "edge_index", "edge_attr", "atomic_num"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("oversample", [True, False])
def test_graph_loader_matches_jax(oversample):
    """Two epochs of the loader: the same batches for the same seed."""
    graphs = t_data.make_synthetic_dataset(seed=4, num_graphs=30).graphs
    jgraphs = _jax_graphs(graphs)
    spec = spec_for_graphs(graphs, 8)
    jspec = j_batch.spec_for_graphs(jgraphs, 8)
    kw = dict(shuffle=not oversample, oversample=oversample, seed=11)
    got = t_data.GraphLoader(graphs, spec, 8, **kw)
    want = j_data.GraphLoader(jgraphs, jspec, 8, **kw)
    assert len(got) == len(want) == 4
    for _ in range(2):
        for a, b in zip(got, want):
            _assert_same(a, b)


@pytest.mark.parametrize("oversample", [True, False])
def test_epoch_id_batches_match_jax(oversample, tmp_path):
    """Two epochs of the Trainer's sampled, -1 padded train ids against the
    JAX Trainer's own ``_epoch_id_batches`` (run on a stand-in object that
    holds the attributes it reads)."""
    ds = t_data.make_synthetic_dataset(seed=5, num_graphs=50)
    jds = j_data.make_synthetic_dataset(seed=5, num_graphs=50)
    spec = spec_for_graphs(ds.graphs, 16)
    cfg = TrainConfig(batch_size=16, oversample=oversample, seed=9,
                      progress=False, log_dir=str(tmp_path))
    jcfg = JTrainConfig(batch_size=16, oversample=oversample, seed=9)
    model = GNNModel(MolKGNNNet(num_layers=1, kernels_1hop=(1, 1, 1, 1)))
    port = Trainer(model, ds, spec, cfg, device="cpu")
    stand_in = types.SimpleNamespace(dataset=jds, spec=None)
    for _ in range(2):
        got = list(port._epoch_id_batches())
        want = list(JTrainer._epoch_id_batches(stand_in, jcfg))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
