#!/usr/bin/env python3
"""Time and profile the support scorer's backward on one GPU.

Runs ``_SupportScore``'s backward (a scatter of the output gradient and
two products per group) at the flagship's grouped launches, layer 0
(F = 28) and an N-hop layer (F = 110), with the serving bucket capacities
of 8192 synthetic molecules at batch 1024. For each it prints the host's
dispatch time and the wall time per call (20 calls after 5 warm-up calls,
synchronised once), the profiler's device time by kernel for one call,
and the wall time again after that profiler session, which shows what a
finished profiler leaves on later launches.

    python3 -m molkgnn_torch.tools.backward_profile
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.ops.permutations import num_perms

CAPACITIES = (19232, 13640, 8144, 7064)  # rows for degrees 1-4
KERNELS = (10, 20, 30, 50)
REPS = 20


def per_call_ms(fn) -> tuple[float, float]:
    """(host dispatch, wall) ms per call of ``fn`` over REPS calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e3 * (t1 - t0) / REPS, 1e3 * (t2 - t0) / REPS


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, f in (("layer 0", 28), ("N-hop layer", 110)):
        ta, tb = [], []
        for d in range(1, 5):
            ta.append(torch.randn(CAPACITIES[d - 1], d * f, device="cuda",
                                  generator=gen).requires_grad_())
            tb.append(torch.randn(num_perms(d), d * f, KERNELS[d - 1],
                                  device="cuda", generator=gen)
                      .requires_grad_())
        flat = ss._SupportScore.apply(ss.grouped_support_score, 4, *ta, *tb)
        grads = [torch.randn_like(x) for x in flat[:4]]

        def backward():
            return torch.autograd.grad(flat[:4], ta + tb, grads,
                                       retain_graph=True)

        for _ in range(5):
            backward()
        host, wall = per_call_ms(backward)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            backward()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(e.self_device_time_total for e in rows) / 1e3
        launches = sum(e.count for e in rows)
        host_after, wall_after = per_call_ms(backward)
        print(f"{name}: host dispatch {host:.3f} ms, wall {wall:.3f} ms a "
              f"call; device {device:.3f} ms in {launches} kernels; after "
              f"the profiler: host {host_after:.3f} ms, wall "
              f"{wall_after:.3f} ms")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  "
                  f"x{e.count:<3d} {e.key[:90]}")


if __name__ == "__main__":
    main()
