"""Fit loop: the share of the window's wall time that validation took.

``Trainer.history`` times each epoch on the host clock; this is the sum of
its ``eval_time_s`` over the sum of its ``epoch_time_s``, over the
window's epochs. Moves the cell's
``train_graphs_per_s.<family>``.
"""


def read(ctx):
    total = sum(e["epoch_time_s"] for e in ctx.history)
    if not ctx.history or total <= 0:
        return None
    return 100.0 * sum(e["eval_time_s"] for e in ctx.history) / total
