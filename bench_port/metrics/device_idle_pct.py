"""Device: the share of the traced slice (train steps and one validation)
in which no kernel or copy ran on the card. Moves the cell's
``train_graphs_per_s.<family>``.
"""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
