"""The harness finds a configuration, a traffic mix, limits and a metric
by the names in ``BENCHMARK.json``, from files dropped into a copy of its
folder: adding a cell or a metric edits no file that is there."""

import json
import shutil
import subprocess
import sys

from bench_port import files

PROBE = """
import json
from bench_port import files
bench = files.benchmark()
cell = files.cell(bench, "new-cell")
print(json.dumps({
    "config": files.config(cell["config"])["encoder"],
    "traffic": files.traffic(cell["traffic"])["batch_size"],
    "limits": files.limits("new-cell")["loss_gap"],
    "family": files.reference(files.config(cell["config"])["family"]).__name__,
    "metrics": [m["name"] for m in files.cell_metrics(bench, "new-cell",
                                                      "per_layer")],
    "read": files.metric("new_metric.train").read({"x": 2.5}),
    "split": files.metric("new_metric.other").read({"x": 2.5}),
}))
"""


def test_files_dropped_into_a_copy_are_found(tmp_path):
    shutil.copytree(files.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = files.benchmark()
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-traffic", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({
        "name": "new_metric.train", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "fit loop",
        "moves": "train_graphs_per_s.schnet", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = tmp_path / "bench_port"
    cfg = json.loads((pkg / "configs" / "schnet-6x128.json").read_text())
    cfg["encoder"]["num_layers"] = 3
    (pkg / "configs" / "new-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "train-b1024.json").read_text())
    traffic["batch_size"] = 64
    (pkg / "traffic" / "new-traffic.json").write_text(json.dumps(traffic))
    limits = json.loads((pkg / "checks" / "kgnn-train-b1024.json").read_text())
    limits["loss_gap"] = 0.125
    (pkg / "checks" / "new-cell.json").write_text(json.dumps(limits))
    (pkg / "metrics" / "new_metric.train.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    (pkg / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 3\n")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"]["num_layers"] == 3
    assert got["traffic"] == 64
    assert got["limits"] == 0.125
    assert got["family"] == "bench_port.reference.schnet"
    assert "new_metric.train" in got["metrics"]
    assert "scorer_fwd_roofline.kgnn" not in got["metrics"]
    assert got["read"] == 5.0
    assert got["split"] == 7.5


def test_every_cell_has_its_files():
    bench = files.benchmark()
    for cell in bench["workloads"]:
        cfg = files.config(cell["config"])
        files.traffic(cell["traffic"])
        files.limits(cell["name"])
        files.reference(cfg["family"])
    for m in bench["per_layer"]:
        assert callable(files.metric(m["name"]).read)


def test_every_cell_reports_what_its_metrics_move():
    """Each cell reports ``setup_s``, one other end-to-end metric and a
    per-layer metric; each per-layer metric's cells report the end-to-end
    metric it moves; every end-to-end name's quantity is measured."""
    bench = files.benchmark()
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in files.cell_metrics(bench, cell["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = files.cell_metrics(bench, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (cell["name"], m["name"])
    for m in bench["end_to_end"]:
        assert files.stem(m["name"]) in ("train_graphs_per_s", "setup_s")
