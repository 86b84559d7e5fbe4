"""The port's CLI (``molkgnn_torch.cli.entry``), on the CPU.

Against the JAX CLI (``molkgnn_tpu.cli.entry.main``) on the same AID-9999
SDF pair (37/226 records, one malformed): a 2-layer narrow model, 2 epochs,
host oversampling, dropout 0, the JAX run's initial weights carried over
(``from_jax_variables``). Both runs split and sample the same ids. Their
``history.json`` train losses agree within 1e-4 relative and their test
metrics within 1e-3 (fp32 in both; the two compute each sum in their own
order). The rest holds the port's CLI to itself: artifacts, ``--test`` and
``--validate``, the flags it refuses, and ``--scan_steps 4`` equal to
``--scan_steps 1`` bit for bit on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from molkgnn_torch.cli import entry as t_entry
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.trainer import Trainer as TTrainer
from molkgnn_tpu.cli import entry as j_entry
from molkgnn_tpu.training.trainer import Trainer as JTrainer
from test_torch_port_qsar import write_9999

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [
    "--num_layers", "2", "--hidden_dim", "8", "--batch_size", "16",
    *[f for i in range(1, 5) for f in (f"--num_kernel{i}_1hop", "3",
                                        f"--num_kernel{i}_Nhop", "3")],
    "--dropout_ratio", "0", "--ffn_dropout_rate", "0",
    "--warmup_iterations", "3", "--peak_lr", "1e-2",
]


def _parse_log(path):
    out, tag = {}, None
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith("["):
                tag = line.strip("[]")
                out[tag] = {}
            elif ":" in line:
                k, v = line.split(":", 1)
                out[tag][k.strip()] = float(v)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_data")
    write_9999(str(base / "qsar" / "clean_sdf" / "raw"))
    return str(base)


def _argv(dataset_path, root, *extra):
    return ["--dataset_name", "9999", "--dataset_path", dataset_path,
            "--default_root_dir", str(root), "--max_epochs", "2",
            "--enable_oversampling_with_replacement", *SMALL, *extra]


@pytest.fixture(scope="module")
def runs(dataset_path, tmp_path_factory):
    """The JAX CLI, then the port's (--device cpu) from the JAX run's
    initial weights; the ids each sampled and each trainer's split."""
    mp = pytest.MonkeyPatch()
    seen = {"jax": {}, "torch": {}}

    def recording_init(init, key):
        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            seen[key]["split"] = {k: np.asarray(v)
                                  for k, v in self.dataset.split.items()}
            if key == "jax":  # copied now: the train step donates them
                seen[key]["v0"] = {
                    "params": dict(_leaves(self.state.params)),
                    "batch_stats": dict(_leaves(self.state.batch_stats)),
                }
        return wrapped

    def recording_ids(fn, key):
        def wrapped(self, *a):
            for ids in fn(self, *a):
                seen[key].setdefault("ids", []).append(np.array(ids))
                yield ids
        return wrapped

    for cls, key in ((JTrainer, "jax"), (TTrainer, "torch")):
        mp.setattr(cls, "__init__", recording_init(cls.__init__, key))
        mp.setattr(cls, "_epoch_id_batches",
                   recording_ids(cls._epoch_id_batches, key))
    roots = {k: tmp_path_factory.mktemp(f"run_{k}") for k in seen}
    try:
        assert j_entry.main(_argv(dataset_path, roots["jax"])) == 0
        v0 = from_jax_variables(seen["jax"]["v0"])
        build = t_entry.build_model

        def build_from_jax(args):
            model = build(args)
            model.load_state_dict(v0, strict=True)
            return model

        mp.setattr(t_entry, "build_model", build_from_jax)
        assert t_entry.main(_argv(dataset_path, roots["torch"],
                                  "--device", "cpu")) == 0
    finally:
        mp.undo()
    return seen, roots


def _leaves(tree):
    """The tree as nested dicts of numpy arrays (flax FrozenDicts too)."""
    for k, v in tree.items():
        yield k, (dict(_leaves(v)) if hasattr(v, "items") else np.asarray(v))


def test_cli_matches_the_jax_cli(runs):
    seen, roots = runs
    for part in ("train", "valid", "test"):
        np.testing.assert_array_equal(seen["torch"]["split"][part],
                                      seen["jax"]["split"][part])
    assert len(seen["torch"]["ids"]) == len(seen["jax"]["ids"]) == 2 * 14
    for a, b in zip(seen["torch"]["ids"], seen["jax"]["ids"]):
        np.testing.assert_array_equal(a, b)
    hist = {}
    for k, root in roots.items():
        with open(root / "logs" / "history.json") as f:
            hist[k] = json.load(f)
    for got, want in zip(hist["torch"], hist["jax"]):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=1e-4)
    got = _parse_log(roots["torch"] / "logs" / "test_result.log")
    want = _parse_log(roots["jax"] / "logs" / "test_result.log")
    assert got.keys() == want.keys()
    for tag in want:
        assert got[tag].keys() == want[tag].keys()
        for k, w in want[tag].items():
            if np.isnan(w):
                assert np.isnan(got[tag][k]), (tag, k)
            else:
                np.testing.assert_allclose(got[tag][k], w, atol=1e-3,
                                           err_msg=f"{tag} {k}")


def test_cli_writes_every_artifact(runs, dataset_path):
    """The JAX CLI's log artifacts, a checkpoint for each of its tags (the
    port's .pt files), the ingest cache in processed/."""
    _, roots = runs
    got = _files(roots["torch"] / "logs")
    assert got == _files(roots["jax"] / "logs")
    assert "kernels/kernels.npz" in got and "task_info.log" in got
    tags = {t.removesuffix(".msgpack")
            for t in os.listdir(roots["jax"] / "checkpoints")}
    assert sorted(os.listdir(roots["torch"] / "checkpoints")) == sorted(
        f"{t}.pt" for t in tags)
    assert "last" in tags
    with open(roots["torch"] / "logs" / "task_info.log") as f:
        info = f.read()
    assert "gnn_type: kgnn" in info and "dataset: 9999" in info
    assert os.path.exists(os.path.join(
        dataset_path, "qsar", "clean_sdf", "processed",
        "kgnn-9999-3D-native.npz"))
    emb = np.load(roots["torch"] / "logs" / "graph_embedding.npy")
    assert emb.shape[1] == 8 and np.isfinite(emb).all()


def test_cli_test_mode_reproduces_the_fit(runs, dataset_path, capsys):
    _, roots = runs
    log = roots["torch"] / "logs" / "test_result.log"
    with open(log) as f:
        after_fit = f.read()
    assert t_entry.main(_argv(dataset_path, roots["torch"], "--device",
                              "cpu", "--test")) == 0
    with open(log) as f:
        assert f.read() == after_fit
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(_parse_log(log))


def test_cli_validate_and_test_without_checkpoints(tmp_path, dataset_path,
                                                   capsys):
    assert t_entry.main(_argv(dataset_path, tmp_path, "--device", "cpu",
                              "--validate")) == 0
    valid = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(valid["valid"]["loss"]) and "AUC" in valid["valid"]
    with pytest.raises(SystemExit, match="no checkpoints found"):
        t_entry.main(_argv(dataset_path, tmp_path / "none", "--device",
                           "cpu", "--test"))


@pytest.mark.parametrize("flags", [
    ["--gnn_type", "chironet", "--F_H", "8"],
    ["--gnn_type=chironet", "--F_H=8"],
])
def test_cli_runs_chironet(flags, tmp_path, dataset_path):
    """`--gnn_type chironet`, in both spellings, trains and tests on the
    SDF pair (one epoch, a narrow model)."""
    root = tmp_path / "chiro"
    assert t_entry.main([
        "--dataset_name", "9999", "--dataset_path", dataset_path,
        "--default_root_dir", str(root), "--max_epochs", "1", "--device",
        "cpu", "--batch_size", "32", "--F_H_EConv", "8", "--GAT_N_heads",
        "2", *flags]) == 0
    assert "[last]" in (root / "logs" / "test_result.log").read_text()
    assert "gnn_type: chironet" in (root / "logs" / "task_info.log"
                                    ).read_text()


@pytest.mark.parametrize("flags,message", [
    (["--model_parallel", "hybrid", "--num_devices", "3"],
     "--num_devices 3 not divisible by --num_data_shards 2"),
    (["--model_parallel", "hybrid"],
     "--num_devices 1 not divisible by --num_data_shards 2"),
    (["--model_parallel", "halo", "--gnn_type", "schnet"],
     "kgnn batch family only"),
    (["--balanced_batches", "--model_parallel", "halo"],
     "balanced_batches deals the device-data path"),
])
def test_cli_refuses_what_is_not_ported(flags, message, tmp_path):
    """Every flag the JAX CLI takes is ported; what the port still refuses
    is what it cannot run: a hybrid mesh the ranks do not fill, model
    parallelism outside kgnn, balanced batches under it."""
    with pytest.raises((SystemExit, ValueError), match=message):
        t_entry.main(["--dataset_name", "synthetic", "--device", "cpu",
                      "--synthetic_graphs", "24", "--default_root_dir",
                      str(tmp_path), *flags])


def test_cli_device_sampling_needs_oversampling():
    with pytest.raises(SystemExit, match="enable_oversampling"):
        t_entry.main(["--dataset_name", "synthetic", "--device", "cpu",
                      "--device_sampling"])


def test_cli_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_entry.main(["--dataset_name", "synthetic",
                      "--default_root_dir", str(tmp_path)])


def test_cli_parses_every_jax_flag():
    """Every option of the JAX parser, for every family, is the port's,
    with the same default; the port adds --device."""
    for family in ("kgnn", "schnet", "dimenet_pp", "spherenet", "chironet"):
        jp, tp = j_entry.build_parser(family), t_entry.build_parser(family)
        want = {a.dest: a.default for a in jp._actions}
        got = {a.dest: a.default for a in tp._actions}
        assert got.pop("device") == "cuda"
        assert got == want


@pytest.mark.parametrize("sampling", [[], ["--device_sampling"]])
def test_cli_scan_steps_equal_single_steps_on_cpu(tmp_path, sampling):
    """On the CPU, --scan_steps 4 runs the same steps as --scan_steps 1:
    the same losses, metrics and weights, bit for bit."""
    def run(k):
        root = tmp_path / f"k{k}"
        assert t_entry.main([
            "--dataset_name", "synthetic_motif", "--synthetic_graphs", "96",
            "--device", "cpu", "--default_root_dir", str(root),
            "--max_epochs", "2", "--enable_oversampling_with_replacement",
            "--scan_steps", str(k), "--dropout_ratio", "0.2", *SMALL,
            *sampling,
        ]) == 0
        with open(root / "logs" / "history.json") as f:
            hist = [{k2: v for k2, v in e.items() if not k2.endswith("_s")}
                    for e in json.load(f)]
        with open(root / "logs" / "test_result.log") as f:
            tested = f.read()
        return hist, tested, torch.load(root / "checkpoints" / "last.pt")

    one, four = run(1), run(4)
    assert one[0] == four[0] and one[1] == four[1]
    for k, v in one[2]["model"].items():
        assert torch.equal(v, four[2]["model"][k]), k


def test_cli_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "molkgnn_torch.cli.entry", "--device", "cpu",
         "--dataset_name", "synthetic_motif", "--max_epochs", "2",
         "--default_root_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(tmp_path / "logs" / "test_result.log")
    assert "jax" not in r.stderr


def test_enantiomer_builder_writes_mirror_pairs(tmp_path):
    """The SDF builder of molkgnn_torch/tools/enantiomer.py: each active
    is a + handed conformer and the inactive at the same position its
    mirror image (x negated, every distance kept)."""
    from molkgnn_torch.chem.sdf import parse_sdf
    from molkgnn_torch.tools import enantiomer

    plus, minus = enantiomer.chiral_pair("CC(F)Cl", seed=3)
    np.testing.assert_array_equal(minus.positions()[:, 0],
                                  -plus.positions()[:, 0])
    enantiomer.write_enantiomer_sdfs(str(tmp_path), n_active=5,
                                     n_inactive=7)
    act = [m for m, _ in parse_sdf(str(tmp_path / "1798_actives_new.sdf"))]
    ina = [m for m, _ in parse_sdf(str(tmp_path / "1798_inactives_new.sdf"))]
    assert len(act) == 5 and len(ina) == 7
    for a, b in zip(act, ina):
        pa, pb = a.positions(), b.positions()
        np.testing.assert_allclose(pb[:, 0], -pa[:, 0], atol=1e-4)
        np.testing.assert_allclose(pb[:, 1:], pa[:, 1:], atol=1e-4)


def test_enantiomer_tool_runs_on_cpu(tmp_path):
    from molkgnn_torch.tools import enantiomer

    result = enantiomer.run(str(tmp_path), n_inactive=300, epochs=1,
                            device="cpu")
    assert result["records"] == 487 and len(result["train_loss"]) == 1
    last = result["test"]["last"]
    assert np.isfinite(last["AUC"]) and np.isfinite(last["logAUC_0.001_0.1"])
    assert os.path.exists(os.path.join(result["run_dir"], "logs",
                                       "task_info.log"))
