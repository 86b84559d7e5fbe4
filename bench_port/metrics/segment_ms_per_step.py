"""Kernels: device ms a train step in the fixed-order segment sums and
their plans (kernels named ``segment_sum_kernel`` and ``plan_*``), from the
traced train steps. Renaming the kernels silences it. Moves the cell's
``train_graphs_per_s.<family>``.
"""

from bench_port.trace import kernel_seconds

PATTERNS = ("segment_sum_kernel", "plan_keys_kernel", "plan_hist_kernel",
            "plan_scan_kernel", "plan_scatter_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    secs, launches = kernel_seconds(ctx.trace, PATTERNS)
    if launches == 0:
        return None
    return 1e3 * secs / ctx.trace["steps"]
