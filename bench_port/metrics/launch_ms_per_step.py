"""Training step: the host's launch of the captured step, ms a replay.

``Trainer.history`` sums each epoch's host time inside
``CUDAGraph.replay()`` (``train_launch_time_s``, the program's spans
``molkgnn.train.replay``) and counts its replays (``train_replays``); this
is the window's launch time over its replays. Nothing is read where the
program records neither. Moves the cell's ``train_graphs_per_s.<family>``.
"""


def read(ctx):
    pairs = [(e.get("train_launch_time_s"), e.get("train_replays"))
             for e in ctx.history]
    pairs = [(t, n) for t, n in pairs if t is not None and n]
    if not pairs:
        return None
    return 1e3 * sum(t for t, _ in pairs) / sum(n for _, n in pairs)
