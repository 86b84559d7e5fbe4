"""The readers of the program's spans and marks, against a synthetic
``Trainer.history``: what each reads, and nothing where the keys are
absent (a program without the spans) or null (the CPU, no replays)."""

import pytest

from bench_port import files
from bench_port.run import Context

STEMS = ("launch_ms_per_step", "replay_gap_ms_per_step",
         "gather_ms_per_step", "optimizer_ms_per_step", "eval_host_ms")

HISTORY = [
    {"epoch_time_s": 0.8, "eval_time_s": 0.05, "train_replays": 49,
     "train_launch_time_s": 0.049, "train_step_stream_ms": 14.0,
     "train_step_device_ms": 13.0, "step_gather_ms": 0.4,
     "step_optimizer_ms": 1.0, "eval_host_time_s": 0.020},
    {"epoch_time_s": 0.8, "eval_time_s": 0.05, "train_replays": 49,
     "train_launch_time_s": 0.098, "train_step_stream_ms": 15.5,
     "train_step_device_ms": 13.0, "step_gather_ms": 0.5,
     "step_optimizer_ms": 1.2, "eval_host_time_s": 0.010},
    {"epoch_time_s": 0.8, "eval_time_s": 0.05, "train_replays": 48,
     "train_launch_time_s": 0.051, "train_step_stream_ms": 13.2,
     "train_step_device_ms": 13.0, "step_gather_ms": 0.6,
     "step_optimizer_ms": 1.1, "eval_host_time_s": 0.030},
]
# A parent's record: no span keys; a CPU record: null device keys.
OLD = {"epoch_time_s": 0.8, "eval_time_s": 0.05}
CPU = {"epoch_time_s": 0.8, "eval_time_s": 0.05, "train_replays": 0,
       "train_launch_time_s": None, "train_step_stream_ms": None,
       "train_step_device_ms": None, "step_gather_ms": None,
       "step_optimizer_ms": None, "eval_host_time_s": None}


def _read(stem, history):
    ctx = Context(cfg={}, ref=None, counts={}, history=history, trace=None,
                  step_ms=None)
    return files.metric(f"{stem}.kgnn").read(ctx)


def test_readers_read_the_history():
    got = {stem: _read(stem, HISTORY) for stem in STEMS}
    assert got["launch_ms_per_step"] == pytest.approx(1e3 * 0.198 / 146)
    assert got["replay_gap_ms_per_step"] == pytest.approx(1.0)
    assert got["gather_ms_per_step"] == pytest.approx(0.5)
    assert got["optimizer_ms_per_step"] == pytest.approx(1.1)
    assert got["eval_host_ms"] == pytest.approx(20.0)
    # Records without a value are left out, not read as zero.
    assert _read("gather_ms_per_step", HISTORY + [CPU]) == pytest.approx(0.5)
    assert _read("launch_ms_per_step", [CPU] + HISTORY) == \
        pytest.approx(got["launch_ms_per_step"])


@pytest.mark.parametrize("history", [[], [OLD, OLD], [CPU, CPU]],
                         ids=["empty", "absent", "null"])
def test_readers_read_nothing_without_the_keys(history):
    for stem in STEMS:
        assert _read(stem, history) is None, stem


def test_every_new_metric_has_its_reader():
    names = [m["name"] for m in files.benchmark()["per_layer"]
             if files.stem(m["name"]) in STEMS]
    assert len(names) == 10
    for name in names:
        assert callable(files.metric(name).read)
