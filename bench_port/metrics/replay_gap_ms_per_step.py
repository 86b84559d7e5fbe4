"""Device: its wait before a replayed train step, with no profiler on.

Each epoch of ``Trainer.history`` times its last replay on the card: the
stream's time from the end of the replay before to its end
(``train_step_stream_ms``, T) and the step's own time between its first
and last device marks (``train_step_device_ms``, D). This is the median
over the window's epochs of T - D. Nothing is read where the program
records neither. Moves the cell's ``train_graphs_per_s.<family>``.
"""

import statistics


def read(ctx):
    gaps = [e["train_step_stream_ms"] - e["train_step_device_ms"]
            for e in ctx.history
            if e.get("train_step_stream_ms") is not None
            and e.get("train_step_device_ms") is not None]
    return statistics.median(gaps) if gaps else None
