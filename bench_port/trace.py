"""The traced slice of a run: a few train steps and one validation under
``torch.profiler``, summed in memory (no trace file is written).

The benchmark marks the slice with spans of its own,
``bench.train_steps`` (ending in a synchronise, so that every kernel of
the steps ends inside it) and ``bench.validation``; the device's kernels
are attributed to the span in which they start. From the events:

  * ``busy_s``: the union of the device's kernel and copy intervals inside
    the slice; ``window_s``: the slice from the first span's start to the
    last one's end, on the profiler's clock;
  * ``train_kernels``: each kernel name's device seconds and launches in
    the train steps;
  * ``device_ops``: the ten device operations that took most time in the
    slice;
  * ``idle_gaps``: the slice's idle time on the device, grouped by what
    the host was doing (the innermost host event under the gap's middle,
    and the benchmark's span around it), the ten largest groups.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

TRAIN, VALID = "bench.train_steps", "bench.validation"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profile_slice(step: Callable[[], object], steps: int,
                  validate: Callable[[], object]) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRAIN):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        with record_function(VALID):
            validate()
            torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end)
             for e in events if e.name in (TRAIN, VALID)
             and e.device_type == DeviceType.CPU}
    t0, t1 = spans[TRAIN][0], spans[VALID][1]
    # The spans show on the device's timeline too, as annotations: they
    # are not device work.
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in (TRAIN, VALID)
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name not in (TRAIN, VALID)]
    busy = _union([(max(e.time_range.start, t0), min(e.time_range.end, t1))
                   for e in device if e.time_range.end > t0
                   and e.time_range.start < t1])
    busy_us = sum(e - s for s, e in busy)

    train: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    ops: Dict[str, float] = defaultdict(float)
    for e in device:
        ops[e.name] += e.time_range.end - e.time_range.start
        if spans[TRAIN][0] <= e.time_range.start < spans[TRAIN][1]:
            rec = train[e.name]
            rec[0] += (e.time_range.end - e.time_range.start) / 1e6
            rec[1] += 1

    # Idle gaps, named by the innermost host event under each gap's middle.
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        span = TRAIN if mid < spans[TRAIN][1] else VALID
        inner = None
        hi = bisect.bisect_right(starts, mid)
        for ev in (host[i] for i in range(hi - 1, max(hi - 400, 0) - 1, -1)):
            if ev.time_range.end >= mid and (
                    inner is None or ev.time_range.end - ev.time_range.start
                    < inner.time_range.end - inner.time_range.start):
                inner = ev
        gaps[f"{span}:{inner.name if inner else 'none'}"] += (e - s) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "busy_s": busy_us / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "train_kernels": {k: tuple(v) for k, v in train.items()},
        "device_ops": [[name, us / 1e6] for name, us in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(trace: dict, patterns) -> Tuple[float, int]:
    """Device seconds and launches, in the traced train steps, of the
    kernels whose name contains one of ``patterns``."""
    secs, n = 0.0, 0
    for name, (s, c) in trace["train_kernels"].items():
        if any(p in name for p in patterns):
            secs += s
            n += c
    return secs, n
