"""Gather: device ms a train step in drawing its ids and assembling its
batch (``graphs/device_pack.py``, ``graphs/device_points.py``).

Each epoch of ``Trainer.history`` times its last replay's phases between
the step's device marks; this is the median over the window's epochs of
``step_gather_ms``. Nothing is read where the program records none. Moves
the cell's ``train_graphs_per_s.<family>``.
"""

import statistics


def read(ctx):
    values = [e["step_gather_ms"] for e in ctx.history
              if e.get("step_gather_ms") is not None]
    return statistics.median(values) if values else None
