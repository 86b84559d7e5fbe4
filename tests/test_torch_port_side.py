"""Port parity: the side packages and the CLI's --balanced_batches.

Each port module against its JAX-package counterpart on the same numpy
inputs from a seed: the contrastive losses within 1e-12 in fp64 (the same
arithmetic; only summation order may differ) and the samplers' draws equal
for the same ``np.random.Generator`` seed; the kernel reader over a
``kernels.npz`` the port's Trainer wrote; the embedding comparison; the
sweep's grid, names, dry run and resume, and the aggregation of the same
files; the monitors' sinks; the profiler region's trace; the prefetch
thread's order and error. Then the CLI with ``--balanced_batches`` on the
CPU, and a two-point sweep through the port's CLI in subprocesses.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.analyses import embedding_compare as t_emb
from molkgnn_torch.analyses import kernel_reader as t_reader
from molkgnn_torch.cli import entry as t_entry
from molkgnn_torch.data.dataset import make_synthetic_dataset
from molkgnn_torch.data.prefetch import prefetch_to_device as t_prefetch
from molkgnn_torch.experiments import aggregate as t_agg
from molkgnn_torch.experiments import cli as t_sweep_cli
from molkgnn_torch.experiments import sweep as t_sweep
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.training import contrastive as t_con
from molkgnn_torch.training import monitors as t_mon
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.analyses import embedding_compare as j_emb
from molkgnn_tpu.analyses import kernel_reader as j_reader
from molkgnn_tpu.data.prefetch import prefetch_to_device as j_prefetch
from molkgnn_tpu.experiments import aggregate as j_agg
from molkgnn_tpu.experiments import sweep as j_sweep
from molkgnn_tpu.training import contrastive as j_con
from molkgnn_tpu.training import monitors as j_mon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("euclidean", "euclidean_normalized", "manhattan", "cosine")


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


# ------------------------------------------------------------- contrastive
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_triplet_loss_matches_jax(metric, reduction):
    rng = np.random.default_rng(METRICS.index(metric))
    z = [rng.standard_normal((9, 6)) for _ in range(3)]
    z[1][0] = z[0][0]  # a positive equal to its anchor
    want = _x64(lambda: np.asarray(j_con.triplet_loss(
        *map(jnp.asarray, z), margin=0.7, reduction=reduction,
        distance_metric=metric)))
    got = t_con.triplet_loss(*map(torch.from_numpy, z), margin=0.7,
                             reduction=reduction, distance_metric=metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="not implemented"):
        t_con.triplet_loss(*map(torch.from_numpy, z), distance_metric="l3")


def test_mse_and_ranking_losses_match_jax():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.standard_normal(17) for _ in range(4))
    c[:3] = d[:3]  # equal targets: sign 0
    want = _x64(lambda: (np.asarray(j_con.mse_loss(jnp.asarray(a),
                                                   jnp.asarray(b))),
                         np.asarray(j_con.ranking_loss(
                             *map(jnp.asarray, (a, b, c, d)), margin=0.2))))
    got = (t_con.mse_loss(torch.from_numpy(a), torch.from_numpy(b)),
           t_con.ranking_loss(*map(torch.from_numpy, (a, b, c, d)),
                              margin=0.2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


def _stereo_records():
    """Records of 4 skeletons, each with 1-3 stereoisomers of 1-3
    conformers, shuffled."""
    rng = np.random.default_rng(4)
    smiles, nostereo = [], []
    for s in range(4):
        for iso in range(1 + s % 3):
            for _ in range(1 + (s + iso) % 3):
                smiles.append(f"S{s}@{iso}")
                nostereo.append(f"S{s}")
    order = rng.permutation(len(smiles))
    return [smiles[i] for i in order], [nostereo[i] for i in order]


def test_samplers_draw_what_the_jax_samplers_draw():
    smiles, nostereo = _stereo_records()
    for include in (False, True):
        t_pos = t_con.SampleMapToPositives(smiles, include_anchor=include)
        j_pos = j_con.SampleMapToPositives(smiles, include_anchor=include)
        assert t_pos.positives == j_pos.positives
    t_neg = t_con.SampleMapToNegatives(smiles, nostereo)
    j_neg = j_con.SampleMapToNegatives(smiles, nostereo)
    assert t_neg.negatives == j_neg.negatives
    for t_map, j_map in ((t_pos, j_pos), (t_neg, j_neg)):
        t_rng, j_rng = np.random.default_rng(9), np.random.default_rng(9)
        for i in range(len(smiles)):
            for n in (1, 4):
                assert t_map.sample(i, t_rng, n) == j_map.sample(i, j_rng, n)
    t_batches = t_con.StereoBatchSampler(nostereo, 5, seed=3)
    j_batches = j_con.StereoBatchSampler(nostereo, 5, seed=3)
    assert len(t_batches) == len(j_batches)
    for _ in range(2):  # two epochs from the sampler's own generator
        assert list(t_batches) == list(j_batches)
    np.testing.assert_array_equal(
        t_con.make_triplets(smiles, nostereo, 12, seed=2),
        j_con.make_triplets(smiles, nostereo, 12, seed=2))
    assert t_con.make_triplets(["a"], ["a"], 3).shape == (0, 3)


# --------------------------------------------------------------- analyses
def _small_trainer(tmp_path, **kw):
    ds = make_synthetic_dataset(seed=1, num_graphs=24)
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(MolKGNNNet(num_layers=1, kernels_1hop=(2, 3, 2, 3),
                                graph_embedding_dim=8, generator=gen, **kw),
                     generator=gen)
    return Trainer(model, ds, spec_for_graphs(ds.graphs, 8),
                   TrainConfig(batch_size=8, progress=False,
                               log_dir=str(tmp_path)), device="cpu")


def test_kernel_reader_decodes_a_port_kernels_file(tmp_path):
    """The port Trainer's kernels.npz (with a fixed set: its score weights
    beside the trainable kernels, as the JAX Trainer writes them) decodes
    alike through both readers."""
    rng = np.random.default_rng(0)
    fixed = (None, {"x_center": rng.standard_normal((2, 28)),
                    "x_support": rng.standard_normal((2, 2, 28)),
                    "edge_attr_support": rng.standard_normal((2, 2, 7)),
                    "p_support": rng.standard_normal((2, 2, 3))}, None, None)
    _small_trainer(tmp_path, fixed_kernels=fixed).save_kernels(
        str(tmp_path / "kernels"))
    path = str(tmp_path / "kernels" / "kernels.npz")
    with np.load(path) as z:
        keys = set(z.files)
    assert "kernelconv4/p_support" in keys
    assert "fixed_kernelconv2/support_attr_sc_weight" in keys
    assert "fixed_kernelconv2/x_center" not in keys  # a constant
    got, want = t_reader.decode_kernels(path), j_reader.decode_kernels(path)
    assert got == want and sorted(got) == [1, 2, 3, 4]
    for deg in range(1, 5):
        assert t_reader.interpret_kernel(path, deg, 1) == \
            j_reader.interpret_kernel(path, deg, 1)


def test_embedding_compare_matches_jax():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((4, 8))
    emb[3] = 0.0  # the 1e-12 floor
    labels = ["R", "S", "R2", "zero"]
    assert t_emb.compare_embeddings(emb, labels) == \
        j_emb.compare_embeddings(emb, labels)
    assert t_emb.cosine(emb[0], emb[0]) == pytest.approx(1.0)


# ------------------------------------------------------------- experiments
GRID = {"peak_lr": [5e-3, 1e-2], "num_layers": [1, 2], "scan_steps": [1]}


def test_sweep_grid_names_and_dry_run(tmp_path):
    """Grid points and names as the JAX package's; a dry run plans every
    point as a run of the port's CLI with the base flags (the device among
    them) and creates nothing; a finished run is skipped."""
    assert t_sweep.grid_points(GRID) == j_sweep.grid_points(GRID)
    for point in t_sweep.grid_points(GRID):
        assert t_sweep.experiment_name(point) == \
            j_sweep.experiment_name(point)
    base = {"dataset_name": "synthetic_motif", "device": "cpu",
            "train_metric": True, "autosave": False}
    cfg = t_sweep.SweepConfig(base_args=base, grid=GRID,
                              out_dir=str(tmp_path / "exp"))
    records = t_sweep.run_sweep(cfg, dry_run=True)
    assert [r["name"] for r in records] == [
        j_sweep.experiment_name(p) for p in j_sweep.grid_points(GRID)]
    for rec in records:
        assert rec["status"] == "planned"
        cmd = rec["cmd"]
        assert cmd[:3] == [sys.executable, "-m", "molkgnn_torch.cli.entry"]
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert "--train_metric" in cmd and "--autosave" not in cmd
        assert cmd[cmd.index("--default_root_dir") + 1] == rec["dir"]
    assert not (tmp_path / "exp").exists()
    done = tmp_path / "exp" / records[0]["name"] / "logs"
    done.mkdir(parents=True)
    (done / "test_result.log").write_text("[last]\nAUC: 0.5\n")
    again = t_sweep.run_sweep(cfg, dry_run=True)
    assert [r["status"] for r in again] == ["done"] + ["planned"] * 3


def _write_results(root):
    rng = np.random.default_rng(5)
    for name in ("b_run", "a_run", "c_empty"):
        logs = root / name / "logs"
        logs.mkdir(parents=True)
        if name == "c_empty":
            continue  # no test_result.log: not collected
        lines = []
        for tag in ("last", "best_AUC"):
            lines.append(f"[{tag}]")
            lines += [f"AUC: {rng.random()}", "ppv: nan",
                      "comment: not a number"]
        if name == "a_run":
            lines += ["[best_loss]", f"loss: {rng.random()}"]
        (logs / "test_result.log").write_text("\n".join(lines) + "\n")


def test_aggregate_results_match_jax(tmp_path):
    _write_results(tmp_path / "exp")
    exp = str(tmp_path / "exp")
    assert t_agg.collect(exp).keys() == {"a_run", "b_run"}
    got = t_agg.aggregate_results(exp, str(tmp_path / "t"))
    want = j_agg.aggregate_results(exp, str(tmp_path / "j"))
    assert got == want
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    assert t_agg.aggregate_results(exp, metrics=["AUC"]) == \
        j_agg.aggregate_results(exp, metrics=["AUC"])


def test_sweep_runs_the_port_cli_and_resumes(tmp_path):
    """Two runs of the port's CLI on the CPU, in parallel subprocesses;
    their results aggregate into two rows; a second call skips both."""
    config = {
        "base_args": {"dataset_name": "synthetic_motif", "device": "cpu",
                      "max_epochs": 1, "synthetic_graphs": 32,
                      "batch_size": 8, "num_layers": 1},
        "grid": {"peak_lr": [5e-3, 1e-2]},
        "out_dir": str(tmp_path / "exp"),
        "max_parallel": 2,
    }
    (tmp_path / "sweep.json").write_text(json.dumps(config))
    out = subprocess.run(
        [sys.executable, "-m", "molkgnn_torch.experiments.cli",
         "--config", str(tmp_path / "sweep.json")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    records = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["status"] for r in records] == ["ok", "ok"]
    table = t_agg.aggregate_results(str(tmp_path / "exp"))["AUC"]
    assert len(table) == 3  # the header and two experiments
    for rec in records:
        with open(os.path.join(rec["dir"], "params.log")) as f:
            assert json.load(f)["device"] == "cpu"
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the config's out_dir is absolute
    try:
        assert t_sweep_cli.main(["--config", "sweep.json"]) == 0
    finally:
        os.chdir(cwd)
    again = t_sweep.run_sweep(t_sweep.SweepConfig(
        base_args=config["base_args"], grid=config["grid"],
        out_dir=config["out_dir"]))
    assert [r["status"] for r in again] == ["done", "done"]


# ---------------------------------------------------------------- monitors
def test_monitor_sinks_write_the_jax_records(tmp_path, capsys):
    records = [
        (0, {"loss": 0.5, "AUC": 0.25, "epoch_time_s": 2.0, "n": 3}),
        (1, {"loss": float("nan"), "AUC": np.float32(0.75),
             "epoch_time_s": 0.0}),
    ]
    written = {}
    for name, mod in (("t", t_mon), ("j", j_mon)):
        path = str(tmp_path / name / "m.jsonl")
        monitor = mod.MetricMonitor([mod.throughput_sink(1000),
                                     mod.jsonl_sink(path), mod.stdout_sink])
        for epoch, metrics in records:
            monitor.on_epoch_end(epoch, dict(metrics))
        with open(path) as f:
            written[name] = (f.read(), monitor.history, capsys.readouterr())
    assert written["t"][0] == written["j"][0]
    assert json.loads(written["t"][0].splitlines()[0])["edges_per_s"] == 500
    assert str(written["t"][1]) == str(written["j"][1])
    assert written["t"][2].out == written["j"][2].out
    assert t_mon.MetricMonitor().sinks == []


def test_monitor_in_trainer_and_stopwatch(tmp_path):
    """A Trainer calls its monitor once an epoch with the epoch's
    results."""
    trainer = _small_trainer(tmp_path)
    trainer.monitor = t_mon.MetricMonitor()
    trainer.config.max_epochs = 2
    trainer.fit()
    assert [r["epoch"] for r in trainer.monitor.history] == [0, 1]
    assert trainer.monitor.history[1]["train_loss"] == \
        trainer.history[1]["train_loss"]
    watch = t_mon.Stopwatch()
    assert watch.elapsed() >= 0 and watch.formatted().endswith("s")


def test_profiler_trace_writes_a_cpu_trace(tmp_path):
    with t_mon.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with t_mon.profiler_trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()


# ---------------------------------------------------------------- prefetch
def test_prefetch_keeps_order_and_raises_the_producers_error():
    items = [np.full(3, i) for i in range(7)]
    got = list(t_prefetch(iter(items)))
    want = list(j_prefetch(iter(items)))
    assert [a.tolist() for a in got] == [a.tolist() for a in want] == [
        a.tolist() for a in items]

    def failing():
        yield 1
        yield 2
        raise KeyError("producer")

    seen = []
    with pytest.raises(KeyError, match="producer"):
        for item in t_prefetch(failing(), size=1):
            seen.append(item)
    assert seen == [1, 2]


# ---------------------------------------------------------------- the CLI
def test_cli_balanced_batches_trains_and_writes_artifacts(tmp_path):
    """--balanced_batches trains kgnn under the dealt tight spec and
    writes the run's artifacts; with --device_sampling it is refused."""
    root = tmp_path / "bal"
    argv = ["--device", "cpu", "--dataset_name", "synthetic_motif",
            "--synthetic_graphs", "64", "--batch_size", "8",
            "--num_layers", "1", "--max_epochs", "1",
            "--enable_oversampling_with_replacement"]
    assert t_entry.main(argv + ["--balanced_batches",
                                "--default_root_dir", str(root)]) == 0
    logs = root / "logs"
    assert "[last]" in (logs / "test_result.log").read_text()
    for name in ("history.json", "kernels/kernels.npz",
                 "graph_embedding.npy", "task_info.log"):
        assert (logs / name).exists(), name
    assert len(np.load(logs / "graph_embedding.npy")) == len(
        (logs / "smiles_for_graph_embedding.txt").read_text().splitlines())
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_entry.main(argv + ["--balanced_batches", "--device_sampling",
                             "--default_root_dir", str(tmp_path / "ds")])
