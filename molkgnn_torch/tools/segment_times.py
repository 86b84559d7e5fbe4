"""The segment sum and its plan at the flagship's shapes, timed on the card.

Five cases of one batch of 1024 of ``chip_smoke.py``'s synthetic molecules
(``random_dataset(seed=0)``, the spec of 8192), fp32 and fp64: message
passing and its transpose at width 110, pooling at 32, the degree-4
neighbour gather's gradient at 110, and the gradient of one support
tensor's gather at ``perms`` (``models/kgnn.py::KernelConv.perm_support``:
an N-hop layer's degree-4 ``x_support``, 50 kernels of width 110, so 48
terms over 4 segments at width 5500). For each case:

  * the kernel's sum against its plain version on CPU copies, bit for bit,
    and the plan built on the card against the plan built on the CPU (the
    plain version), equal as integers; either failing raises;
  * the sum's and the plan's device time a call (``torch.profiler``: the
    sum's kernel by name, every kernel of the plan, and each of them
    alone), their time a call by CUDA events around 20 back-to-back calls
    (host dispatch included), the plain versions' event times,
    ``index_add_`` of the same terms, and ``torch.sort(stable=True)`` of
    the plan's keys;
  * the byte bounds: the sum reads each distinct row that the live terms
    gather once, writes each output once and reads the indices; the plan
    reads the ids, mask and gather and writes row, rowptr and the int64
    ids, each once.

Prints one JSON line. Run from the root of a checkout on a machine with an
NVIDIA GPU: ``python -m molkgnn_torch.tools.segment_times``. It uses only
names that the port has had since the segment sum came in, so a second
checkout can be timed by the same file: ``PYTHONPATH=<other checkout>
python <this file>``. ``chip_smoke.py`` phase 14(a) calls ``measure``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

HBM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3
BATCH = 1024
MOLECULES = 8192
WIDTH = 110  # the flagship's node width: 10 + 20 + 30 + 50 kernels
# The support tensor of the perms case: an N-hop layer's degree 4.
PERM_DEGREE, PERM_KERNELS = 4, 50


def profiled_kernels(fn, reps: int = 20):
    """[(device ms a call, kernel name)] of every kernel (and memset) that
    ``fn`` runs, from torch.profiler over ``reps`` calls after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(evt.self_device_time_total / 1e3 / reps, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0
            and not getattr(evt, "is_user_annotation", False)]


def profiled_ms(fn, reps: int = 20, name=None):
    """Device ms a call of ``fn``: the kernels whose name holds ``name``
    (every kernel for None), from torch.profiler; None where the profiler
    records no device time."""
    total = sum(ms for ms, key in profiled_kernels(fn, reps)
                if name is None or name in key)
    return total if total > 0 else None


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of one call of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def segment_cases(batch):
    """name: (ids, segments, mask, gather, rows of values, width) of the
    five cases on ``batch`` (a kgnn ``GraphBatch`` on the card)."""
    from molkgnn_torch.ops.permutations import perm_table

    n, nb = batch.x.shape[0], batch.num_graphs
    d4 = batch.buckets()[3]
    perms = torch.from_numpy(perm_table(PERM_DEGREE)).long().cuda()
    return {
        "message passing": (batch.edge_dst, n, batch.edge_mask,
                            batch.edge_src, n, WIDTH),
        "message passing, transposed (its gradient)": (
            batch.edge_src, n, batch.edge_mask, batch.edge_dst, n, WIDTH),
        "pooling": (batch.node_graph_id, nb, batch.node_mask, None, n, 32),
        "degree-4 neighbour gather's gradient": (
            d4.nei_index, n, d4.mask[:, None].expand(d4.nei_index.shape),
            None, d4.nei_index.numel(), WIDTH),
        "perms gather's gradient (degree 4, N-hop x_support)": (
            perms, PERM_DEGREE, None, None, perms.numel(),
            PERM_KERNELS * WIDTH),
    }


def _plain_plan(sg):
    """The plan's plain version: ``segment_plan_plain`` where the package
    has it, else ``segment_plan`` (whose body then is the torch chain)."""
    return getattr(sg, "segment_plan_plain", sg.segment_plan)


def _check_plan(sg, name, plan, ids, segs, mask, gather):
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    want = sg.segment_plan(cpu(ids), segs, cpu(mask), gather=cpu(gather))
    for field, got, ref in zip(plan._fields, plan, want):
        if not torch.equal(got.cpu(), ref):
            bad = int((got.cpu() != ref).nonzero()[0, 0])
            raise AssertionError(
                f"plan of {name}: {field} differs from the plain plan first "
                f"at {bad}: card {int(got[bad])}, plain {int(ref[bad])}")


def measure(batch, seed: int = 0, log=print):
    """Check and time the five cases on ``batch``, fp32 and fp64; returns
    {"<case>, <dtype>": {...}}."""
    from molkgnn_torch.ops import segment as sg

    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    plain_plan = _plain_plan(sg)
    record = {}
    for name, (ids, segs, mask, gather, rows, f) in segment_cases(
            batch).items():
        plan = sg.segment_plan(ids, segs, mask, gather=gather)
        _check_plan(sg, name, plan, ids, segs, mask, gather)
        live = int(plan.rowptr[segs])
        flat_ids = ids.reshape(-1).long()
        keys = plan.ids.int()
        id_bytes = ids.element_size() + (0 if mask is None else 1) + (
            0 if gather is None else gather.element_size())
        plan_bytes = ids.numel() * (id_bytes + 4 + 8) + (segs + 2) * 4
        kernels = profiled_kernels(lambda: sg.segment_plan(
            ids, segs, mask, gather=gather))
        plan_t = {
            "plan_ms": event_ms(lambda: sg.segment_plan(
                ids, segs, mask, gather=gather)),
            "plan_device_ms": sum(ms for ms, _ in kernels) or None,
            "plan_kernels": {key[:80]: ms for ms, key in sorted(
                kernels, reverse=True)},
            "plan_plain_ms": event_ms(lambda: plain_plan(
                ids, segs, mask, gather=gather)),
            "sort_ms": event_ms(lambda: torch.sort(keys, stable=True)),
            "plan_bound_ms": plan_bytes / HBM_RATE * 1e3,
        }
        for dtype in (torch.float32, torch.float64):
            values = torch.randn(rows, f, generator=gen, device="cuda",
                                 dtype=dtype)
            got = sg.segment_sum(values, plan).cpu()
            want = sg.segment_sum_plain(values.cpu(), plan.row.cpu(),
                                        plan.rowptr.cpu())
            if not torch.equal(got, want):
                diff = (got - want).abs()
                worst = np.unravel_index(int(diff.argmax()), diff.shape)
                raise AssertionError(
                    f"segment sum {name} {dtype}: not bit-equal to the "
                    f"plain version; worst element {tuple(worst)}: kernel "
                    f"{got[worst].item()!r}, plain {want[worst].item()!r}")
            # index_add_ of the gathered, masked terms: the atomics the port
            # does not call, timed as the yardstick.
            src = (gather if gather is not None
                   else torch.arange(rows, device="cuda"))
            terms = values.index_select(0, src.reshape(-1).long())
            if mask is not None:
                terms = torch.where(mask.reshape(-1, 1), terms, 0)
            item = values.element_size()
            distinct = int(plan.row[:live].unique().numel())
            nbytes = (distinct * f + segs * f) * item + (live + segs + 1) * 4
            t = {
                "kernel_ms": event_ms(lambda: sg.segment_sum(values, plan)),
                "kernel_device_ms": profiled_ms(
                    lambda: sg.segment_sum(values, plan),
                    name="segment_sum"),
                "plain_ms": event_ms(lambda: sg.segment_sum_plain(
                    values, plan.row, plan.rowptr)),
                "index_add_ms": event_ms(lambda: values.new_zeros(
                    (segs, f)).index_add_(0, flat_ids, terms)),
                "bound_ms": nbytes / HBM_RATE * 1e3,
                "bound_by": "bytes", "segments": segs, "terms": live,
                "ids": ids.numel(), "rows_read": distinct, "width": f,
                "max_abs_err": 0.0, **plan_t,
            }
            key = f"{name}, {str(dtype)[6:]}"
            record[key] = t
            fmt = lambda ms: ("not measured" if ms is None  # noqa: E731
                              else f"{ms:.4f} ms")
            log(f"  (a) {key}: {segs} segments, {live} live terms of "
                f"{ids.numel()} reading {distinct} distinct rows, width {f}: "
                f"bit-equal to the plain version, plan equal to the plain "
                f"plan; kernel {fmt(t['kernel_device_ms'])} device, "
                f"{t['kernel_ms']:.4f} ms events, bound "
                f"{t['bound_ms']:.4f} ms (bytes), index_add_ "
                f"{t['index_add_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; "
                f"plan {fmt(t['plan_device_ms'])} device, "
                f"{t['plan_ms']:.4f} ms events, bound "
                f"{t['plan_bound_ms']:.4f} ms (bytes), plain "
                f"{t['plan_plain_ms']:.4f} ms, torch.sort "
                f"{t['sort_ms']:.4f} ms; on {card}")
    return record


def main() -> None:
    import molkgnn_torch
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("segment_times: needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    graphs = random_dataset(seed=0, num_graphs=MOLECULES)
    spec = spec_for_graphs(graphs, BATCH)
    batch = batch_graphs(graphs[:BATCH], spec).to("cuda")
    out = {"package": molkgnn_torch.__file__,
           "card": torch.cuda.get_device_name(0),
           "cases": measure(batch)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
