"""Port parity: the QSAR and D4DCHP ingest, the processed caches and the
device sampler, against the JAX package.

  * splits, ingest, caches and the D4DCHP loader: bit-equal (no tolerance);
  * the alias table: bit-equal (float64 host arithmetic in both);
  * ``sample_ids``: a torch generator does not give JAX's bits, so the draws
    are held to the weights: each position's count over 2e5 CPU draws lies
    within 5 standard deviations of its expectation;
  * a device-sampled run resumed from ``save_state`` draws what the
    uninterrupted run draws, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from molkgnn_torch.chem.embed import embed_molecule
from molkgnn_torch.chem.sdf import to_molblock
from molkgnn_torch.chem.smiles import parse_smiles
from molkgnn_torch.data import d4dchp as t_d4
from molkgnn_torch.data import qsar as t_qsar
from molkgnn_torch.data.dataset import QSAR_METRICS, oversampling_weights
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs import device_pack as t_dp
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.data import d4dchp as j_d4
from molkgnn_tpu.data import qsar as j_qsar
from molkgnn_tpu.graphs import device_pack as j_dp

POOL = [
    "CCO", "CC(=O)O", "c1ccccc1", "CCN", "CCC", "CCCC", "CC(C)C", "CCOC",
    "CCS", "CNC", "COC", "CCCl", "CCBr", "CCF", "c1ccncc1", "CC(N)=O",
    "CC(C)O", "CCCO", "CCCC(=O)O", "Oc1ccccc1", "FC(Cl)Br", "CC(N)F",
]
MALFORMED = "bad record\n\n\n  x  y  0  0  0  0  0  0  0  0999 V2000\nM  END\n"
BAD_INACTIVE = 10  # the 11th inactive record is malformed


def _block(i, seed):
    m = parse_smiles(POOL[i % len(POOL)], add_hs=True)
    pos = embed_molecule(m, seed=seed, iterations=40)
    for k, a in enumerate(m.atoms):
        a.x, a.y, a.z = map(float, pos[k])
    return to_molblock(m)


def write_9999(raw):
    """The AID-9999 SDF pair at its real counts (37 actives, 226
    inactives), one inactive record malformed."""
    os.makedirs(raw, exist_ok=True)
    for name, n, seed0 in (("actives", 37, 0), ("inactives", 226, 1000)):
        with open(os.path.join(raw, f"9999_{name}_new.sdf"), "w") as f:
            for i in range(n):
                bad = name == "inactives" and i == BAD_INACTIVE
                f.write(MALFORMED if bad else _block(i, seed0 + i))
                f.write("$$$$\n")


@pytest.fixture(scope="module")
def qsar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("qsar")
    write_9999(str(root / "raw"))
    return str(root)


def _assert_same_graphs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in ("x", "p", "edge_index", "edge_attr", "atomic_num"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)
        assert (a.y, a.idx, a.smiles) == (b.y, b.idx, b.smiles)


@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("name", sorted(j_qsar.DATASET_INFO))
def test_make_split_equals_jax(name, shrink):
    assert t_qsar.DATASET_INFO[name] == j_qsar.DATASET_INFO[name]
    info = t_qsar.DATASET_INFO[name]
    args = (info["num_active"], info["num_inactive"], 2)
    got = t_qsar.make_split(*args, shrink=shrink)
    assert got == j_qsar.make_split(*args, shrink=shrink)
    assert t_qsar.split_checksum(got) == j_qsar.split_checksum(got)


def test_ingest_equals_jax(qsar_root):
    t_graphs, t_invalid = t_qsar.ingest_qsar_sdf(qsar_root, "9999",
                                                 progress=False)
    j_graphs, j_invalid = j_qsar.ingest_qsar_sdf(qsar_root, "9999",
                                                 progress=False)
    assert t_invalid == j_invalid == [(37 + BAD_INACTIVE, 0)]
    assert len(t_graphs) == 262
    _assert_same_graphs(t_graphs, j_graphs)


@pytest.mark.parametrize("shard_size", [0, 50])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_others_cache(qsar_root, tmp_path, writer,
                                             shard_size):
    """One package builds the cache (single file, or shards of 50), the
    other reads it; both then give the same Dataset."""
    first, second = (t_qsar, j_qsar) if writer == "torch" else (j_qsar,
                                                                 t_qsar)
    cache = str(tmp_path / "processed")
    kw = dict(cache_dir=cache, shard_size=shard_size, seed=2, shrink=True)
    built = first.load_qsar_dataset(qsar_root, "9999", **kw)
    cpath = os.path.join(cache, "kgnn-9999-3D-native.npz")
    assert os.path.exists(cpath) == (shard_size == 0)
    assert os.path.exists(cpath + ".manifest.json") == (shard_size > 0)
    read = second.load_qsar_dataset(qsar_root, "9999", **kw)
    _assert_same_graphs(read.graphs, built.graphs)
    for part in ("train", "valid", "test"):
        np.testing.assert_array_equal(read.split[part], built.split[part])
    assert 37 + BAD_INACTIVE not in {g.idx for g in read.graphs}


def test_reference_split_file_loads(tmp_path):
    split = t_qsar.make_split(37, 226, seed=2, shrink=True)
    path = str(tmp_path / "shrink_9999_seed2.pt")
    digest = t_qsar.save_split(split, path)
    assert digest == j_qsar.split_checksum(split)
    assert t_qsar.load_reference_split(path) == split
    assert j_qsar.load_reference_split(path) == split


def test_d4dchp_equals_jax(tmp_path):
    smiles = ["CC(N)O", "C1CC(", "FC(Cl)Br", "CCO", "OC(F)Cl", "CCN"]
    csv_path = tmp_path / "d4.csv"
    with open(csv_path, "w") as f:
        f.write("smiles,labels,docking_score\n")
        for i, s in enumerate(smiles):
            f.write(f"{s},{i % 2},{-5.0 - i}\n")
    idx = tmp_path / "split.npy"
    np.save(idx, np.array([[0, 2, 3], [4], [1, 5]], dtype=object),
            allow_pickle=True)
    for subset in ("CHIRAL1", "D4DCHP"):
        got = t_d4.load_d4dchp_dataset(str(csv_path), subset, str(idx))
        want = j_d4.load_d4dchp_dataset(str(csv_path), subset, str(idx))
        _assert_same_graphs(got.graphs, want.graphs)
        assert (got.metrics, got.loss_name) == (want.metrics, want.loss_name)
        for part in ("train", "valid", "test"):
            np.testing.assert_array_equal(got.split[part], want.split[part])
    assert len(got.graphs) == 5  # the unparsable SMILES is dropped


@pytest.mark.parametrize("case", ["oversampling", "random", "uniform", "one"])
def test_alias_table_equals_jax(case):
    rng = np.random.default_rng(3)
    weights = {
        "oversampling": oversampling_weights(
            (rng.random(1000) < 0.05).astype(np.float32)),
        "random": rng.random(777) ** 3,
        "uniform": np.ones(64),
        "one": np.array([2.5]),
    }[case]
    got, want = t_dp.alias_sampler(weights), j_dp.alias_sampler(weights)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sample_ids_follow_the_weights():
    rng = np.random.default_rng(4)
    labels = (rng.random(60) < 0.1).astype(np.float32)
    labels[:2] = 1.0
    weights = oversampling_weights(labels)
    table = t_dp.alias_sampler(weights)
    train_ids = torch.arange(100, 160, dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    draws = torch.cat([
        t_dp.sample_ids(gen, torch.from_numpy(table.prob),
                        torch.from_numpy(table.alias), train_ids, 1000)
        for _ in range(200)
    ]).numpy()
    assert draws.dtype == np.int32 and draws.shape == (200_000,)
    counts = np.bincount(draws - 100, minlength=60)
    p = weights / weights.sum()
    expected = p * draws.size
    sigma = np.sqrt(draws.size * p * (1 - p))
    assert np.all(np.abs(counts - expected) <= 5 * sigma), (
        counts, expected)


def _sampling_trainer(tmp_path, sub, **kw):
    graphs = random_dataset(seed=6, num_graphs=40, active_fraction=0.2)
    perm = np.random.default_rng(8).permutation(40)
    ds = TDataset(
        "synthetic", graphs,
        {"train": np.sort(perm[:26]), "valid": np.sort(perm[26:33]),
         "test": np.sort(perm[33:])},
        list(QSAR_METRICS), "bce_with_logits",
    )
    gen = torch.Generator().manual_seed(2)
    model = GNNModel(MolKGNNNet(num_layers=1, kernels_1hop=(2, 2, 2, 2),
                                kernels_nhop=(2, 2, 2, 2),
                                graph_embedding_dim=8, drop_ratio=0.2,
                                generator=gen),
                     ffn_dropout_rate=0.2, generator=gen)
    cfg = dict(batch_size=8, max_epochs=4, warmup_iterations=3,
               progress=False, device_sampling=True, scan_steps=3,
               tot_iterations=18,
               log_dir=str(tmp_path / sub / "logs"))
    cfg.update(kw)
    return Trainer(model, ds, spec_for_graphs(graphs, 8), TrainConfig(**cfg),
                   device="cpu")


def test_device_sampling_epoch_budget_and_rejections(tmp_path):
    """ceil(n_train / B) full batches an epoch; oversample is required, as
    is the device-data path."""
    t = _sampling_trainer(tmp_path, "a", max_epochs=1)
    t.fit()
    assert t.step == 4 and len(t.step_losses) == 4
    with pytest.raises(ValueError, match="oversampling"):
        _sampling_trainer(tmp_path, "b", oversample=False)
    with pytest.raises(ValueError, match="device-data path"):
        _sampling_trainer(tmp_path, "c", use_device_data=False)


def test_device_sampling_resume_draws_the_same(tmp_path):
    """A device-sampled run stopped after 2 of 4 epochs and resumed from its
    autosave (a fresh Trainer) draws the same ids and ends where the
    uninterrupted run ends, bit for bit."""
    straight = _sampling_trainer(tmp_path, "straight")
    straight.fit()
    auto = str(tmp_path / "auto")
    _sampling_trainer(tmp_path, "first", max_epochs=2,
                      autosave_path=auto).fit()
    second = _sampling_trainer(tmp_path, "second", autosave_path=auto)
    second.fit()
    assert second.step == straight.step == 16
    assert second.step_losses == straight.step_losses[8:]
    assert torch.equal(second.sample_rng.get_state(),
                       straight.sample_rng.get_state())
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k
