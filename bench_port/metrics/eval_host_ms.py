"""Fit loop: validation's host work, ms an epoch: the labels, putting the
predictions back in order, the metrics and the loss.

``Trainer.history`` sums each epoch's spans ``molkgnn.eval.host``
(``eval_host_time_s``); this is the median over the window's epochs.
Nothing is read where the program records none. Moves the cell's
``train_graphs_per_s.<family>``.
"""

import statistics


def read(ctx):
    values = [1e3 * e["eval_host_time_s"] for e in ctx.history
              if e.get("eval_host_time_s") is not None]
    return statistics.median(values) if values else None
