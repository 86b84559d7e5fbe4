"""Optimizer: device ms a train step from the end of its backward to the
end of its update: the gradients' fill, the finite check, the clip and
AdamW (``training/optim.py``).

Each epoch of ``Trainer.history`` times its last replay's phases between
the step's device marks; this is the median over the window's epochs of
``step_optimizer_ms``. Nothing is read where the program records none.
Moves the cell's ``train_graphs_per_s.<family>``.
"""

import statistics


def read(ctx):
    values = [e["step_optimizer_ms"] for e in ctx.history
              if e.get("step_optimizer_ms") is not None]
    return statistics.median(values) if values else None
