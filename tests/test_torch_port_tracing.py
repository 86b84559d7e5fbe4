"""The port's host spans (``monitors.SpanRecorder``) and the keys each
epoch's history record takes from them and from the step's device marks.

The recorder's parents, self time and reset; ``torch.profiler`` ranges
only while a profiler runs, each inside its span; then one 2-epoch fit of
the small CPU Trainer: every record has the new keys, the parts of an
epoch fit in it, and the device keys are null on the CPU. The marks
themselves are held on the card (``test_torch_port_cuda.py``).
"""

import pytest
import torch
from test_torch_port_side import _small_trainer

from molkgnn_torch.training.monitors import SpanRecorder
from molkgnn_torch.training.trainer import STEP_KEYS, TRACE_KEYS


def test_spans_record_parents_self_time_and_reset():
    rec = SpanRecorder()
    rec.reset(7)
    with rec.span("a"):
        with rec.span("b"):
            pass
        with rec.span("c"):
            with rec.span("d"):
                pass
    with rec.span("b"):
        pass
    names = [s.name for s in rec.records]
    assert names == ["a", "b", "c", "d", "b"]
    assert [s.parent for s in rec.records] == [-1, 0, 0, 2, -1]
    assert {s.trace for s in rec.records} == {7}
    assert all(s.start_ns <= s.end_ns for s in rec.records)
    a, b, c, d, _ = rec.records
    length = [s.end_ns - s.start_ns for s in rec.records]
    assert rec.self_ns(0) == length[0] - length[1] - length[2]
    assert rec.self_ns(2) == length[2] - length[3]
    assert rec.self_ns(3) == length[3]
    assert b.end_ns <= c.start_ns and c.start_ns <= d.start_ns <= d.end_ns
    assert d.end_ns <= c.end_ns <= a.end_ns
    totals = rec.totals()
    assert totals["b"][0] == 2
    assert totals["b"][1] == pytest.approx((length[1] + length[4]) / 1e9)
    rec.reset(8)
    assert rec.records == [] and rec.totals() == {}
    with rec.span("e"):
        rec.reset(9)  # a reset inside a span drops it without a fault
    assert rec.records == [] and rec.trace == 9


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = SpanRecorder()
    with rec.span("molkgnn.x"):
        pass
    assert [s.name for s in rec.records] == ["molkgnn.x"]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The small CPU Trainer after a 2-epoch fit."""
    trainer = _small_trainer(tmp_path_factory.mktemp("fit"))
    trainer.config.max_epochs = 2
    trainer.fit()
    return trainer


def test_spans_lie_inside_their_profiler_ranges(fitted):
    """Under a CPU profiler an evaluation's spans appear as user ranges,
    as many as were recorded, each no longer than its span and ending
    inside it, on clocks aligned by the least offset between the two
    starts (a range opens after its span's start, so that offset is the
    clocks' own plus the shortest such delay)."""
    from torch.profiler import ProfilerActivity, profile

    start = len(fitted.spans.records)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fitted.evaluate("valid")
    spans = fitted.spans.records[start:]
    names = {"molkgnn.eval.dispatch", "molkgnn.eval.readback",
             "molkgnn.eval.host"}
    assert {s.name for s in spans} == names
    ranges = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == [s.name for s in spans]
    offset = min(e.time_range.start - s.start_ns / 1e3
                 for e, s in zip(ranges, spans))
    for e, s in zip(ranges, spans):
        assert (e.time_range.end - e.time_range.start
                <= (s.end_ns - s.start_ns) / 1e3 + 1)
        assert e.time_range.end - offset <= s.end_ns / 1e3 + 50


def test_fit_records_carry_the_span_keys(fitted):
    for epoch, rec in enumerate(fitted.history):
        for key in TRACE_KEYS:
            assert key in rec, key
        assert rec["epoch"] == epoch and rec["train_replays"] == 0
        for key in ("eval_dispatch_time_s", "eval_readback_time_s",
                    "eval_host_time_s"):
            assert isinstance(rec[key], float) and rec[key] > 0
    assert {s.trace for s in fitted.spans.records} == {1}


def test_fit_parts_fit_in_the_epoch(fitted):
    for rec in fitted.history:
        parts = [rec["train_dispatch_time_s"], rec["train_readback_time_s"],
                 rec["eval_time_s"]]
        assert all(p > 0 for p in parts)
        assert sum(parts) <= rec["epoch_time_s"]
        assert (rec["eval_dispatch_time_s"] + rec["eval_readback_time_s"]
                + rec["eval_host_time_s"]) <= rec["eval_time_s"]


def test_device_keys_are_null_on_the_cpu(fitted):
    for rec in fitted.history:
        assert rec["train_launch_time_s"] is None
        for key in STEP_KEYS:
            assert rec[key] is None, key
