"""Training step: its model FLOPs over the card's TF32 peak.

The family's reference counts the operations of one train step's products
at a batch's expected real counts (``model_flops``); the step's time is a
block of replayed steps by CUDA events. Against 495 TFLOP/s, the dense
TF32 rate of the tensor cores (``roofline.py``). Moves the cell's
``train_graphs_per_s.<family>``.
"""

from bench_port.roofline import TF32_FLOPS


def read(ctx):
    if ctx.step_ms is None or not hasattr(ctx.ref, "model_flops"):
        return None
    flops = ctx.ref.model_flops(ctx.cfg, ctx.counts)
    return 100.0 * flops / (ctx.step_ms / 1e3) / TF32_FLOPS
