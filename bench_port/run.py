"""Run one cell of the benchmark once.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``) names a configuration and a traffic mix;
the run:

  1. makes the traffic and the initial weights from ``--seed``;
  2. builds the program's Trainer on them (``program.py``), runs its first
     train steps through the window's own call (the readings the check
     compares; the call captures the train step as a CUDA graph) and one
     validation (which captures the evaluation's graph): the set-up,
     ``setup_s``, counted from the start of the process;
  3. measures: ``Trainer.fit`` one epoch at a time until ``--seconds``
     have passed, every epoch whole (its steps, its readback, its
     validation); ``train_graphs_per_s`` is the molecules trained (steps x
     batch) over the window's wall time. ``nvidia-smi`` samples the card's
     clocks and power meanwhile;
  4. with ``--trace 1``, times a block of replayed steps by CUDA events and
     profiles a slice of train steps and one validation (``trace.py``),
     and reports the cell's per-layer metrics (``metrics/<name>.py``)
     instead of the end-to-end ones;
  5. reads the peak memory, takes the program's validation predictions
     and state, frees the program, and runs the plain reference
     (``check.py``); ``correct`` holds when every number is within its
     limit (``checks/<workload>.json``).

Prints a line of details, then the compared numbers with their limits as
the last lines of standard error, then the result as the last line of
standard output. Exits non-zero with no result without the cards, and
where ``jax``, ``jaxlib``, ``flax`` or ``molkgnn_tpu`` has been loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import check, files, traffic as traffic_mod  # noqa: E402
from bench_port.power import PowerLog  # noqa: E402
from bench_port.reference.common import (  # noqa: E402
    make_weights,
    oversampling_weights,
)

FORBIDDEN = ("jax", "jaxlib", "flax", "molkgnn_tpu")
# Build and kernel caches of the program, at fixed paths in the checkout.
CACHE = files.ROOT / ".bench_cache"


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cfg: dict
    ref: object  # the family's reference module (work counters)
    counts: dict  # expected real counts of a batch
    history: list  # the window's epochs (Trainer.history)
    trace: Optional[dict]  # trace.profile_slice, or None
    step_ms: Optional[float]  # a replayed step by CUDA events


def expected_counts(ref, cfg, data, batch: int) -> dict:
    """A batch's real counts under the sampler: each molecule's own counts
    (``ref.counts``), weighted by the chance of drawing each train entry,
    times the batch."""
    train = data.split["train"]
    w = oversampling_weights(data.labels[train])
    w = w / w.sum()
    per = [ref.counts(m, cfg) for m in data.molecules]
    mols = data.mol_of_entry[train]
    out = {k: batch * float(np.dot(w, np.array([c[k] for c in per])[mols]))
           for k in per[0]}
    out["graphs"] = float(batch)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event_ms(step: Callable, n: int) -> float:
    """ms a call of ``step`` over ``n`` calls, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", traffic_over: Optional[dict] = None,
             tamper: Optional[Callable] = None) -> dict:
    """One run of ``workload``: the result, the checks and the details.
    ``traffic_over`` replaces entries of the traffic file and ``tamper(tr)``
    is called on the built Trainer (tests)."""
    from bench_port import program  # the program, imported only to run it

    bench = files.benchmark()
    cell = files.cell(bench, workload)
    cfg = files.config(cell["config"])
    tspec = dict(files.traffic(cell["traffic"]), **(traffic_over or {}))
    limits = files.limits(workload)
    ref = files.reference(cfg["family"])
    seed = int(seed) % 2 ** 63
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
        program.build_kernels()
    marks = {"start": time.time() - PROCESS_START}
    batch = tspec["batch_size"]
    data = traffic_mod.make_traffic(tspec, seed)
    weights = make_weights(ref.param_specs(cfg), seed, dev)
    marks["traffic"] = time.time() - PROCESS_START
    tmp = tempfile.TemporaryDirectory(prefix="bench_port_")
    ds = program.dataset(data, cfg, batch)
    tr = program.trainer(cfg, tspec, ds, weights, seed, dev, tmp.name)
    marks["trainer"] = time.time() - PROCESS_START
    if tamper is not None:
        tamper(tr)

    # The check's readings: the first steps, through the window's call.
    step = program.step_call(tr)
    losses = []
    for k in range(tspec["check_steps"]):
        losses.append(step())
        if k == 0:
            first = check.leaf_norms(program.first_gradients(tr))
    params = dict(tr.model.named_parameters())
    prog = {"losses": [float(x) for x in losses], "first": first,
            "change": check.leaf_norms({n: params[n].detach() - weights[n]
                                        for n in params})}
    marks["check_steps"] = time.time() - PROCESS_START
    # The check steps captured the train step; one validation captures
    # the evaluation's graph. Nothing else in an epoch compiles.
    tr.evaluate("valid")
    _sync(dev)
    setup_s = time.time() - PROCESS_START
    marks["warm"] = setup_s

    power = PowerLog(os.path.join(tmp.name, "power.csv"))
    h0, s0 = len(tr.history), len(tr.step_losses)
    epochs = 0
    t0 = time.perf_counter()
    while True:
        tr.fit()
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    clocks = power.stop()
    history = tr.history[h0:]
    window_losses = tr.step_losses[s0:]
    steps = len(window_losses)
    rate = steps * batch / window_s

    traced, step_ms = None, None
    if trace:
        from bench_port import trace as tracing

        step_ms = _event_ms(step, tspec["mfu_steps"])
        traced = tracing.profile_slice(step, tspec["trace_steps"],
                                       lambda: tr.evaluate("valid"))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    valid_ids, valid_pred = program.valid_predictions(tr)
    state = program.state(tr)
    failed = sum(1 for x in window_losses if not math.isfinite(x))
    del tr, ds, params, losses, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    r_losses, r_first, r_change, _ = check.reference_steps(
        ref, cfg, tspec, data, weights, seed, dev, tspec["check_steps"])
    r_valid, r_margin = check.reference_valid(ref, cfg, data, valid_ids,
                                              state, dev)
    numbers = check.compare(
        dict(prog, valid=valid_pred),
        {"losses": r_losses, "first": r_first, "change": r_change,
         "valid": r_valid, "margins": r_margin},
        limits)
    verdict = check.verdict(numbers, limits)
    reference_s = time.perf_counter() - t_ref
    tmp.cleanup()

    if trace:
        ctx = Context(cfg=cfg, ref=ref,
                      counts=expected_counts(ref, cfg, data, batch),
                      history=history, trace=traced, step_ms=step_ms)
        metrics = {}
        for m in files.cell_metrics(bench, workload, "per_layer"):
            value = files.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"train_graphs_per_s": rate, "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[files.stem(m["name"])],
                               "unit": m["unit"]}
                   for m in files.cell_metrics(bench, workload, "end_to_end")}
    info = {"workload": workload, "seed": seed, "epochs": epochs,
            "steps": steps, "window_s": window_s, "setup_s": setup_s,
            "reference_s": reference_s, "setup_marks": marks,
            "clocks": clocks,
            "epoch_s": [h["epoch_time_s"] for h in history],
            "numbers": numbers, "prog_losses": prog["losses"],
            "ref_losses": r_losses,
            "leaves": {n: [prog["first"][n], r_first[n], prog["change"][n],
                           r_change[n]] for n in sorted(r_first)}}
    if dev.type == "cuda":
        info["card"] = torch.cuda.get_device_name(dev)
    if traced is not None:
        info["step_ms"] = step_ms
        info["counts"] = ctx.counts
        info["train_kernels"] = {k: list(v) for k, v in
                                 traced["train_kernels"].items()}
    result = {
        "correct": (all(v["ok"] for v in verdict.values()) and failed == 0),
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": info.get("card", str(dev)), "count": 1,
                   "memory_peak_bytes": int(peak)},
    }
    if traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in verdict.items()}
    return {"result": result, "info": info}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = files.cell(files.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        path = CACHE / name.lower()
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(out["info"]), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
