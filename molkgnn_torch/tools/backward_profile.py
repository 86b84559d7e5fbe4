#!/usr/bin/env python3
"""Time and profile the support scorer's backward on one GPU.

Three measurements, in one process, fp32, TF32 off:

  1. The backward alone (``_SupportScore``'s backward, reached through
     ``torch.autograd.grad``) at the flagship's grouped launches, layer 0
     (F = 28) and an N-hop layer (F = 110), with the serving bucket
     capacities of 8192 synthetic molecules at batch 1024: CUDA events over
     20 back-to-back calls after 5, the profiler's device time of 20 calls
     by kernel, and the byte bound (each input read once, each output
     written once, over 3.35 TB/s). Where the package has the dense plain
     route as a function of its own (``support_score_backward_plain``: a
     scatter to [M, P, L] and two products a group), it is timed on the
     same tensors beside it. Where the package's kernels run on the tensor
     cores (it has ``support_score_backward_3xtf32``), the TF32 operations
     they issue (``tf32_work``), that work's time at 495 TFLOP/s and its
     share of the kernels' device time. Then each degree group of the
     layer alone (G = 1), da alone and db alone, device ms a call by
     replaying a CUDA graph of 10 captured calls (``graph_ms``).
  2. Two eager flagship train steps (batch 1024, device sampling) profiled,
     with every call of ``_SupportScore.backward`` inside a
     ``torch.profiler.record_function`` range that this tool adds for the
     profile only: the kernels under the range (device ms and launches a
     step), and the step's device ms.
  3. Two profiled replays of the flagship's captured step (``scan_steps=16``,
     device sampling): every kernel, device ms and launches a step.

Prints the card's name and power limit, a readable summary, and one JSON
line. It uses only names that the port had before its backward kernels
(and the backward op, its plain dense route and its 3xTF32 emulation
where the package has them), so another checkout's package is profiled
by the same file:

    python3 -m molkgnn_torch.tools.backward_profile
    PYTHONPATH=<checkout> python3 <this file>
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import molkgnn_torch
from molkgnn_torch.ops import _build
from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.ops.permutations import num_perms
from molkgnn_torch.tools.segment_times import event_ms, profiled_kernels

CAPACITIES = (19232, 13640, 8144, 7064)  # rows for degrees 1-4
KERNELS = (10, 20, 30, 50)
HBM_RATE = 3.35e12  # bytes/s, H100 SXM
FP32_PEAK = 67e12  # FLOP/s, fp32 outside the tensor cores
TF32_PEAK = 495e12  # FLOP/s, dense TF32 on the tensor cores
RANGE = "molkgnn::support_score_backward_range"
BATCH = 1024


def bound(shapes) -> dict:
    """The backward's least time: each of a, b, g, idx read once and da, db
    written once, over the memory rate, against 4*M*K*L operations (2 an
    FMA, da and db) over the fp32 peak. shapes: [(M, K, L, P)]."""
    nbytes = sum(4 * (2 * m * k + 2 * p * k * l + 2 * m * l)
                 for m, k, l, p in shapes)
    flops = sum(4 * m * k * l for m, k, l, _ in shapes)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / FP32_PEAK * 1e3
    return {"bytes": nbytes, "flops": flops, "ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def _ceil_to(x: int, step: int) -> int:
    return -(-x // step) * step


def tf32_work(shapes, need_a=None, need_b=None, device_ms=None) -> dict:
    """The TF32 tensor-core operations (2 a multiply-add) that the backward
    kernels of csrc/support_score_bwd.cu issue for groups of these
    (M, K, L, P), each taking da and db where needed (default: both): the
    dense one-hot products at the kernels' tiles, three times over for the
    3xTF32 split. da: 64-row warpgroup tiles (a tile's rows past M still
    issue), K in chunks of 32, N = P * L in stages of 32. db: 64-column
    warpgroup tiles of K (a tile wholly past K issues nothing), N in chunks
    of 32, M in chunks of 32.
    The one formula of this tool and of chip_smoke.py's phase 5; the tiles
    are the source's (kDaRows, kChunk, kDaSteps, kDbK, kDbRows), copied.
    Returns the operations, their time at 495 TFLOP/s and, given the
    kernels' device ms, that time's share of it (the tensor cores' share of
    their peak)."""
    need_a = [True] * len(shapes) if need_a is None else need_a
    need_b = [True] * len(shapes) if need_b is None else need_b
    fma = 0
    for (m, k, l, p), want_a, want_b in zip(shapes, need_a, need_b):
        n = p * l
        if want_a and m and k:
            fma += _ceil_to(m, 64) * _ceil_to(k, 32) * _ceil_to(n, 32)
        if want_b and m and k and n:
            fma += _ceil_to(k, 64) * _ceil_to(n, 32) * _ceil_to(m, 32)
    flops = 2 * 3 * fma
    ms = flops / TF32_PEAK * 1e3
    return {"flops": flops, "ms": ms,
            "share": ms / device_ms if device_ms else None}


def graph_ms(fn, calls=10, replays=5) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in a CUDA graph
    (after two on a side stream), replayed ``replays`` times by events
    (events around eager calls would time the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def group_times(a_list, b_list, g_list, idx_list) -> list:
    """[{shape, da_ms, db_ms}] of each group alone: the backward op with
    only da, then only db wanted, by ``graph_ms``."""
    out = []
    for a, b, g, idx in zip(a_list, b_list, g_list, idx_list):
        rec = {"shape": (a.shape[0], a.shape[1], b.shape[2], b.shape[0])}
        for what, need_a, need_b in (("da", True, False),
                                     ("db", False, True)):
            rec[f"{what}_ms"] = graph_ms(lambda: ss.support_score_backward(
                [a], [b], [g], [idx], [need_a], [need_b]))
        out.append(rec)
    return out


def layer_operands(f, gen):
    """(a_list, b_list, shapes) of one grouped launch with F features."""
    ta, tb, shapes = [], [], []
    for d in range(1, 5):
        m, k, l, p = CAPACITIES[d - 1], d * f, KERNELS[d - 1], num_perms(d)
        ta.append(torch.randn(m, k, device="cuda", generator=gen)
                  .requires_grad_())
        tb.append(torch.randn(p, k, l, device="cuda", generator=gen)
                  .requires_grad_())
        shapes.append((m, k, l, p))
    return ta, tb, shapes


def backward_alone() -> dict:
    """Measurement 1, per layer."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, f in (("layer 0", 28), ("N-hop layer", 110)):
        ta, tb, shapes = layer_operands(f, gen)
        flat = ss._SupportScore.apply(ss.grouped_support_score, 4, *ta, *tb)
        grads = [torch.randn(x.shape, device="cuda", generator=gen)
                 for x in flat[:4]]

        def backward():
            return torch.autograd.grad(flat[:4], ta + tb, grads,
                                       retain_graph=True)

        for _ in range(5):
            backward()
        rec = {"shapes": shapes, "event_ms": event_ms(backward),
               "kernels": sorted(profiled_kernels(backward), reverse=True),
               "bound": bound(shapes)}
        rec["device_ms"] = sum(ms for ms, _ in rec["kernels"])
        rec["tf32"] = (tf32_work(shapes, device_ms=rec["device_ms"])
                       if hasattr(ss, "support_score_backward_3xtf32")
                       else None)
        args = ([x.detach() for x in ta], [x.detach() for x in tb], grads,
                [x.detach() for x in flat[4:]])
        if hasattr(ss, "support_score_backward"):
            rec["groups"] = group_times(*args)
        plain = getattr(ss, "support_score_backward_plain", None)
        if plain is not None:

            def dense():
                return [plain(a, b, g, i, True, True)
                        for a, b, g, i in zip(*args)]

            rec["plain_event_ms"] = event_ms(dense)
            rec["plain_device_ms"] = sum(
                ms for ms, _ in profiled_kernels(dense))
        out[name] = rec
    return out


def flagship_trainer(scan_steps):
    from molkgnn_torch.data.dataset import make_synthetic_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    ds = make_synthetic_dataset(num_graphs=8192)
    spec = spec_for_graphs(ds.graphs, BATCH)
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(MolKGNNNet(num_layers=4, use_kernel=True,
                                generator=gen), generator=gen)
    return Trainer(model, ds, spec, TrainConfig(
        batch_size=BATCH, progress=False, scan_steps=scan_steps,
        device_sampling=True))


def kernels_under(prof, name) -> tuple[dict, int]:
    """({kernel: (device ms, launches)} of the kernels launched under every
    CPU range called ``name`` (its descendants' kernels), the ranges)."""
    out: dict = {}
    ranges = 0

    def walk(evt):
        for k in evt.kernels:
            ms, n = out.get(k.name, (0.0, 0))
            out[k.name] = (ms + k.duration / 1e3, n + 1)
        for child in evt.cpu_children:
            walk(child)

    for evt in prof.events():
        if evt.name == name and evt.device_type == DeviceType.CPU:
            ranges += 1
            walk(evt)
    return out, ranges


def step_rows(prof, n):
    """[(device ms a step, launches a step, name)] of every kernel."""
    return sorted(
        ((evt.self_device_time_total / 1e3 / n, evt.count / n, evt.key)
         for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA
         and evt.self_device_time_total > 0
         and not getattr(evt, "is_user_annotation", False)),
        reverse=True)


def eager_step() -> dict:
    """Measurement 2: the backward's kernels inside an eager train step."""
    trainer = flagship_trainer(1)
    for _ in range(3):
        trainer._device_step()
    torch.cuda.synchronize()
    original = ss._SupportScore.backward

    def ranged(ctx, *grads):
        with record_function(RANGE):
            return original(ctx, *grads)

    ss._SupportScore.backward = staticmethod(ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer._device_step()
            torch.cuda.synchronize()
    finally:
        ss._SupportScore.backward = staticmethod(original)
    under, ranges = kernels_under(prof, RANGE)
    rows = step_rows(prof, 2)
    return {
        "backward_ranges_a_step": ranges / 2,
        "backward_kernels": sorted(
            ([ms / 2, n / 2, k] for k, (ms, n) in under.items()),
            reverse=True),
        "backward_device_ms": sum(ms for ms, _ in under.values()) / 2,
        "step_device_ms": sum(ms for ms, _, _ in rows),
        "step_top": rows[:15],
    }


def replayed_step() -> dict:
    """Measurement 3: two profiled replays of the captured step."""
    trainer = flagship_trainer(16)
    for _ in range(20):
        trainer._graph_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer._graph_step()
        torch.cuda.synchronize()
    rows = step_rows(prof, 2)
    return {"device_ms": sum(ms for ms, _, _ in rows), "kernels": rows}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    out = {"package": molkgnn_torch.__file__, "card": card,
           "alone": backward_alone(), "eager_step": eager_step(),
           "replayed_step": replayed_step()}
    for name, rec in out["alone"].items():
        print(f"{name}: backward {rec['event_ms']:.4f} ms by events, "
              f"{rec['device_ms']:.4f} ms of device time, bound "
              f"{rec['bound']['ms']:.4f} ms ({rec['bound']['by']}); dense "
              f"plain route {rec.get('plain_event_ms')} ms by events, "
              f"{rec.get('plain_device_ms')} ms of device time")
        if rec["tf32"] is not None:
            print(f"    issued TF32 work {rec['tf32']['flops'] / 1e9:.3f} "
                  f"GFLOP, {rec['tf32']['ms']:.4f} ms at 495 TFLOP/s: "
                  f"{rec['tf32']['share']:.3f} of the kernels' device time")
        for ms, key in rec["kernels"][:8]:
            print(f"    {ms:8.4f} ms  {key[:100]}")
        for grp in rec.get("groups", []):
            print(f"    alone {grp['shape']}: da {grp['da_ms']:.4f} ms, db "
                  f"{grp['db_ms']:.4f} ms by graph replay")
    step = out["eager_step"]
    print(f"eager step: device {step['step_device_ms']:.3f} ms, the "
          f"scorer's backward {step['backward_device_ms']:.4f} ms a step "
          f"({step['backward_ranges_a_step']:g} backward calls a step):")
    for ms, n, key in step["backward_kernels"]:
        print(f"    {ms:8.4f} ms  x{n:<5g} {key[:100]}")
    rep = out["replayed_step"]
    print(f"replayed step: device {rep['device_ms']:.3f} ms a step; top:")
    for ms, n, key in rep["kernels"][:15]:
        print(f"    {ms:8.4f} ms  x{n:<5g} {key[:100]}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
