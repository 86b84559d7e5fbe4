#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MolKGNN (``molkgnn_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device:  require CUDA; print the card's name and power limit.
  2. build:   compile every CUDA source of molkgnn_torch/csrc with nvcc.
  3. kernels: hold the support-score kernel against its plain PyTorch
              version at the flagship serving shapes (buckets of 8192
              synthetic molecules at batch 1024) and at the shapes of
              tests/test_pallas.py; time kernel, plain version, a library
              yardstick, and the card's bound for the same work.
  4. serve:   the main path. Serve 8192 synthetic molecules at batch 1024
              through Predictor.predict_graphs with the flagship
              GNNModel(MolKGNNNet(use_kernel=True)) (4 layers, 10/20/30/50
              kernels, hidden 32, random weights from a seed); the grouped
              scorer must launch 4 times per chunk. Then the per-degree
              KernelConv(use_kernel=True) path, which launches the fused
              scorer once per degree. Then the kernel path against the
              plain-product form (use_kernel=False): at 1 layer on the
              synthetic molecules and at 4 layers on tie-free ones. Then
              the throughput of both forms and a profile of where the
              device time goes.

The last lines are the kernel record ({"kernels": [...]}), the card's
name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

FP32_PEAK = 67e12  # FLOP/s, H100 SXM fp32 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3
REPLACES = {
    "fused_support_score": "molkgnn_tpu/ops/pallas_kernels.py:295",
    "grouped_support_score": "molkgnn_tpu/ops/pallas_kernels.py:223",
}
KERNEL_SOURCE = "molkgnn_torch/csrc/support_score.cu"
FLAGSHIP_KERNELS = (10, 20, 30, 50)
NUM_MOLECULES = 8192
BATCH = 1024
SEED = 0


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
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


def bound_ms(shapes):
    """Least time for the scorer's work on this card: the larger of the
    operations over the fp32 peak and the bytes (each input read once, each
    output written once) over the memory rate. shapes: [(M, K, L, P)]."""
    flops = sum(2 * m * k * l * p for m, k, l, p in shapes)
    nbytes = sum((m * k + p * k * l) * 4 + m * l * 8 for m, k, l, p in shapes)
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"
    )


class Smoke:
    def __init__(self, torch):
        self.torch = torch

    # ------------------------------------------------------------ phase 3
    def operands(self, m, d, f, l, gen):
        """Row-normalized operands of one degree bucket, as
        KernelConv.support_operands builds them."""
        from molkgnn_torch.ops.permutations import perm_table
        from molkgnn_torch.ops.similarity import normalize_rows

        torch = self.torch
        p = len(perm_table(d))
        x = torch.randn(m, d, f, generator=gen, device="cuda")
        s = torch.randn(l, p, d, f, generator=gen, device="cuda")
        a = normalize_rows(x).reshape(m, d * f)
        b = normalize_rows(s).reshape(l, p, d * f).permute(1, 2, 0)
        return a, b.contiguous()

    def check_against_plain(self, name, outs, a_list, b_list):
        """best within rtol/atol 1e-5 of the plain version; idx equal where
        the plain scores' top-2 gap exceeds 1e-4. Returns max |err|."""
        from molkgnn_torch.ops.support_score import support_score_plain

        torch = self.torch
        torch.cuda.synchronize()
        worst, excluded = 0.0, 0
        for (best, idx), a, b in zip(outs, a_list, b_list):
            want_best, want_idx = support_score_plain(a, b)
            torch.testing.assert_close(best, want_best, rtol=1e-5, atol=1e-5)
            worst = max(worst, (best - want_best).abs().max().item())
            sc = torch.einsum("mk,pkl->mlp", a, b)
            if sc.shape[2] > 1:
                top2 = sc.topk(2, dim=2).values
                clear = (top2[..., 0] - top2[..., 1]) > 1e-4
            else:
                clear = torch.ones_like(want_idx, dtype=torch.bool)
            excluded += int((~clear).sum())
            bad = int(((idx != want_idx) & clear).sum())
            if bad:
                raise AssertionError(f"{name}: {bad} argmax mismatches")
        log(f"  {name}: max |best - plain| = {worst:.3e}; "
            f"idx equal where top-2 gap > 1e-4 "
            f"({excluded} entries excluded)")
        return worst

    def time_launch(self, kernel_fn, a_list, b_list):
        """(kernel, plain, library) ms for one launch over these groups."""
        from molkgnn_torch.ops.support_score import support_score_plain

        torch = self.torch

        def plain():
            for a, b in zip(a_list, b_list):
                support_score_plain(a, b)

        def library():  # one product per group, then max/argmax over p
            for a, b in zip(a_list, b_list):
                p, k, l = b.shape
                sc = torch.matmul(a, b.permute(1, 0, 2).reshape(k, p * l))
                sc.reshape(-1, p, l).max(dim=1)

        return (
            time_ms(torch, kernel_fn),
            time_ms(torch, plain),
            time_ms(torch, library),
        )

    def phase_kernels(self, spec):
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.ops.permutations import num_perms

        torch = self.torch
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        caps = spec.deg_capacity
        nhop_f = sum(FLAGSHIP_KERNELS)
        layer_shapes = {
            "layer 0": [(caps[d - 1], d, 28, FLAGSHIP_KERNELS[d - 1])
                        for d in range(1, 5)],
            "N-hop layer": [(caps[d - 1], d, nhop_f, FLAGSHIP_KERNELS[d - 1])
                            for d in range(1, 5)],
        }
        # (kernel, layer) -> ((kernel, plain, library) ms, shapes, max err)
        self.per_request = {}
        for layer, dims in layer_shapes.items():
            ops = [self.operands(m, d, f, l, gen) for m, d, f, l in dims]
            a_list, b_list = [a for a, _ in ops], [b for _, b in ops]
            shapes = [(m, d * f, l, num_perms(d)) for m, d, f, l in dims]
            outs = ss.grouped_support_score(a_list, b_list)
            err = self.check_against_plain(
                f"grouped {layer} {shapes}", outs, a_list, b_list
            )
            ms = self.time_launch(
                lambda: ss.grouped_support_score(a_list, b_list),
                a_list, b_list,
            )
            self.per_request[("grouped_support_score", layer)] = (
                ms, shapes, err
            )
            # The per-degree KernelConv path launches the fused scorer once
            # per degree bucket at the layer-0 shapes.
            if layer == "layer 0":
                errs = []
                for a, b, shape in zip(a_list, b_list, shapes):
                    out = ss.fused_support_score(a, b)
                    errs.append(self.check_against_plain(
                        f"fused {shape}", [out], [a], [b]
                    ))
                fused_ms = [
                    self.time_launch(
                        lambda a=a, b=b: ss.fused_support_score(a, b), [a], [b]
                    )
                    for a, b in zip(a_list, b_list)
                ]
                self.per_request[("fused_support_score", layer)] = (
                    tuple(sum(t[i] for t in fused_ms) for i in range(3)),
                    shapes, max(errs),
                )
            b_ms, by = bound_ms(shapes)
            log(f"  grouped {layer}: kernel {ms[0]:.4f} ms, plain "
                f"{ms[1]:.4f} ms, library {ms[2]:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by})")

        # The shapes of tests/test_pallas.py. Operands are unit vectors
        # along k, so every score is a cosine in [-1, 1], as on the model's
        # path, and the 1e-5 tolerance is against values of order 1.
        from molkgnn_torch.ops.similarity import normalize_rows

        test_pallas_shapes = [(37, 112, 50, 12), (8, 28, 3, 2), (200, 440, 30, 6)]
        for m, k, l, p in test_pallas_shapes:
            a = normalize_rows(torch.randn(m, k, generator=gen, device="cuda"))
            b = normalize_rows(
                torch.randn(p, l, k, generator=gen, device="cuda")
            ).transpose(1, 2).contiguous()
            out = ss.fused_support_score(a, b)
            self.check_against_plain(f"fused {(m, k, l, p)}", [out], [a], [b])
            t = self.time_launch(
                lambda: ss.fused_support_score(a, b), [a], [b]
            )
            b_ms, by = bound_ms([(m, k, l, p)])
            log(f"  fused {(m, k, l, p)}: kernel {t[0]:.4f} ms, plain "
                f"{t[1]:.4f} ms, library {t[2]:.4f} ms, bound {b_ms:.4f} ms "
                f"({by})")
        ones_a = torch.ones(4, 8, device="cuda")
        ones_b = torch.ones(5, 8, 3, device="cuda")
        for _, idx in [ss.fused_support_score(ones_a, ones_b),
                       *ss.grouped_support_score([ones_a] * 2, [ones_b] * 2)]:
            if not bool((idx == 0).all()):
                raise AssertionError("tie case: argmax is not the first p")
        log("  tie case: every idx is 0")

    # ------------------------------------------------------------ phase 4
    def phase_serve(self, graphs, spec):
        from molkgnn_torch.data.synthetic import tie_free_molgraph
        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
        from molkgnn_torch.models.kgnn import KernelConv, MolKGNNNet
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.serving.predictor import Predictor
        from molkgnn_torch.training.model import GNNModel

        import numpy as np

        torch = self.torch
        card = torch.cuda.get_device_name(0)

        def flagship(num_layers, use_kernel, seed=SEED):
            gen = torch.Generator().manual_seed(seed)
            enc = MolKGNNNet(
                num_layers=num_layers, use_kernel=use_kernel, generator=gen
            )
            return GNNModel(enc, generator=gen)

        # --- the main path, counted -------------------------------------
        model = flagship(4, True)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        served = Predictor(model, sd, spec, device="cuda")
        chunks = -(-len(graphs) // spec.num_graphs)
        ss.grouped_support_score.launches = 0
        ss.fused_support_score.launches = 0
        scores = served.predict_graphs(graphs)
        launches = {
            "grouped_support_score": ss.grouped_support_score.launches,
            "fused_support_score": ss.fused_support_score.launches,
        }
        log(f"  main path: {chunks} chunks, launches {launches}")
        if launches["grouped_support_score"] != 4 * chunks:
            raise AssertionError(
                f"grouped scorer launched {launches['grouped_support_score']}"
                f" times, want 4 x {chunks}"
            )
        if scores.shape != (len(graphs),) or not np.isfinite(scores).all():
            raise AssertionError("scores are not finite or misshapen")
        self.main_launches = launches

        # --- the per-degree KernelConv path, counted ----------------------
        batch = batch_graphs(graphs[:BATCH], spec).to("cuda")
        gen = torch.Generator().manual_seed(SEED)
        convs = [
            KernelConv(d, FLAGSHIP_KERNELS[d - 1], 28, 7, use_kernel=True,
                       generator=gen).cuda()
            for d in range(1, 5)
        ]
        ss.grouped_support_score.launches = 0
        ss.fused_support_score.launches = 0
        with torch.inference_mode():
            for conv, b in zip(convs, batch.buckets()):
                out = conv(batch.x[b.focal_index], batch.p[b.focal_index],
                           batch.x[b.nei_index], batch.p[b.nei_index],
                           b.nei_edge_attr, b.mask, is_last_layer=True)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("KernelConv scores are not finite")
        self.conv_launches = ss.fused_support_score.launches
        log(f"  KernelConv path: fused launches {self.conv_launches}")
        if self.conv_launches != 4:
            raise AssertionError("KernelConv path did not launch 4 times")

        # --- kernel path against the plain-product form -------------------
        def compare(name, num_layers, mols, mspec, rtol, atol):
            m_k = flagship(num_layers, True, seed=1)
            sd_k = m_k.state_dict()
            got = Predictor(m_k, sd_k, mspec, "cuda").predict_graphs(
                mols, return_embeddings=True
            )
            want = Predictor(
                flagship(num_layers, False, seed=1), sd_k, mspec, "cuda"
            ).predict_graphs(mols, return_embeddings=True)
            for what, g, w in zip(("scores", "embeddings"), got, want):
                diff = float(np.abs(g - w).max())
                log(f"  {name} {what}: max |kernel - plain form| = "
                    f"{diff:.3e} (max |value| {float(np.abs(w).max()):.3e})")
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)

        compare("1 layer, synthetic", 1, graphs, spec, 1e-4, 1e-4)
        rng = np.random.default_rng(SEED)
        tie_free = [tie_free_molgraph(rng) for _ in range(2048)]
        compare("4 layers, tie-free", 4, tie_free,
                spec_for_graphs(tie_free, 512), 1e-4, 1e-4)

        # --- throughput of both forms -------------------------------------
        n_edges = sum(g.num_edges for g in graphs)
        models = {True: served}
        models[False] = Predictor(flagship(4, False), sd, spec, device="cuda")
        batches = [
            batch_graphs(graphs[s:s + BATCH], spec).to("cuda")
            for s in range(0, len(graphs), BATCH)
        ]
        results = {True: {"e2e": [], "device": []},
                   False: {"e2e": [], "device": []}}
        for use_kernel in (True, False, False, True, True, False):
            pred = models[use_kernel]
            t0 = time.perf_counter()
            pred.predict_graphs(graphs)
            results[use_kernel]["e2e"].append(time.perf_counter() - t0)
            with torch.inference_mode():
                pred.model(batches[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    pred.model(b)
                torch.cuda.synchronize()
            results[use_kernel]["device"].append(time.perf_counter() - t0)
        self.throughput = {}
        for use_kernel, r in results.items():
            row = {}
            for kind, secs in r.items():
                best = min(secs)
                row[kind] = {
                    "seconds": secs,
                    "graphs_per_s": len(graphs) / best,
                    "edges_per_s": n_edges / best,
                }
            self.throughput[f"use_kernel={use_kernel}"] = row
            log(f"  use_kernel={use_kernel} on {card}: "
                f"predict_graphs {row['e2e']['graphs_per_s']:.1f} graphs/s, "
                f"{row['e2e']['edges_per_s']:.1f} edges/s; forward only "
                f"{row['device']['graphs_per_s']:.1f} graphs/s, "
                f"{row['device']['edges_per_s']:.1f} edges/s "
                f"({len(graphs)} molecules, {n_edges} edges, batch {BATCH}; runs "
                f"{r['e2e']} s and {r['device']} s)")
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        log(f"  peak device memory {peak_mib:.1f} MiB")
        self.profile(models, batches)

    def profile(self, models, batches):
        """Device time by kernel over one forward pass of all chunks."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for use_kernel, pred in models.items():
            with torch.inference_mode():
                pred.model(batches[0])
                torch.cuda.synchronize()
                with profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                ) as prof:
                    t0 = time.perf_counter()
                    for b in batches:
                        pred.model(b)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
            rows = [
                (evt.self_device_time_total / 1e3, evt.count, evt.key)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and evt.self_device_time_total > 0
            ]
            busy = sum(r[0] for r in rows)
            if not rows:
                log(f"  profile use_kernel={use_kernel}: no device time "
                    "recorded (not measured)")
                continue
            log(f"  profile use_kernel={use_kernel}: device busy "
                f"{busy:.3f} ms of {wall_ms:.3f} ms wall "
                f"(idle share {1 - busy / wall_ms:.3f}, profiler on)")
            for ms, count, key in sorted(rows, reverse=True)[:10]:
                log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")

    # ------------------------------------------------------------ record
    def kernel_record(self):
        entries = []
        launches = {
            "grouped_support_score": self.main_launches[
                "grouped_support_score"
            ],
            "fused_support_score": self.conv_launches,
        }
        paths = {
            "grouped_support_score": "serving: Predictor.predict_graphs, "
            "per request 1 launch at layer 0 + 3 at N-hop layers",
            "fused_support_score": "KernelConv(use_kernel=True), one "
            "launch per degree bucket at layer-0 shapes",
        }
        for name in ("grouped_support_score", "fused_support_score"):
            if name == "grouped_support_score":
                (l0, s0, e0) = self.per_request[(name, "layer 0")]
                (ln, sn, en) = self.per_request[(name, "N-hop layer")]
                ms = [l0[i] + 3 * ln[i] for i in range(3)]
                shapes = s0 + sn * 3
                err = max(e0, en)
            else:
                (t, shapes, err) = self.per_request[(name, "layer 0")]
                ms = list(t)
            b_ms, by = bound_ms(shapes)
            entries.append({
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err,
                "ms": ms[0],
                "plain_ms": ms[1],
                "bound_ms": b_ms,
                "bound_by": by,
                "library_ms": ms[2],
                "path": paths[name],
            })
        return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import molkgnn_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: molkgnn_torch not found; run this from the root "
              "of a checkout of the repository", file=sys.stderr)
        return 1
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.ops import _build

    smoke = Smoke(torch)
    smi = None
    phase = "device"
    try:
        log("[1] device")
        smi = nvidia_smi_line()
        log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        phase = "build"
        log("[2] build")
        secs = _build.build_all()
        log(f"  built in {secs:.2f} s")
        for stem, text in _build.build_log.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {stem}: {line.strip()}")

        phase = "kernels"
        log("[3] kernels against their plain versions")
        t0 = time.perf_counter()
        graphs = random_dataset(seed=SEED, num_graphs=NUM_MOLECULES)
        spec = spec_for_graphs(graphs, BATCH)
        log(f"  {NUM_MOLECULES} synthetic molecules in "
            f"{time.perf_counter() - t0:.1f} s; spec {spec}")
        smoke.phase_kernels(spec)

        phase = "serve"
        log("[4] serving path")
        smoke.phase_serve(graphs, spec)
        record = smoke.kernel_record()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1

    print(json.dumps({"throughput": smoke.throughput}), flush=True)
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
