"""Kernels: the permutation scorer's backward (its four
``score_grad_*`` kernels), as a share of its roofline.

The least time of a train step's scorer work at a batch's expected real
rows (``roofline.scorer_backward_work`` over the family reference's
``scorer_shapes``), over the device time a traced train step spends in
kernels named ``score_grad_``. Nothing is read where the family has no
scorer or no such kernel ran; renaming the kernels silences it. Moves the cell's
``train_graphs_per_s.<family>``.
"""

from bench_port.roofline import least_seconds, scorer_backward_work
from bench_port.trace import kernel_seconds

PATTERNS = ("score_grad_",)


def bound(ctx):
    """What sets the least time: "operations" or "bytes"."""
    shapes = [s for layer in ctx.ref.scorer_shapes(ctx.cfg, ctx.counts)
              for s in layer]
    return least_seconds(*scorer_backward_work(shapes))


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.ref, "scorer_shapes"):
        return None
    secs, launches = kernel_seconds(ctx.trace, PATTERNS)
    if launches == 0 or secs <= 0:
        return None
    least, _ = bound(ctx)
    return 100.0 * least / (secs / ctx.trace["steps"])
