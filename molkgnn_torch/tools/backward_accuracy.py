#!/usr/bin/env python3
"""The support scorer backward's accuracy against fp64, and db's range cap.

At the flagship's grouped launches (layer 0, F = 28, and an N-hop layer,
F = 110, at the serving bucket capacities of 8192 synthetic molecules at
batch 1024), with operands as on the model's path (a and b unit vectors
along k, g standard normal, idx uniform in [0, P), from seed 0), one call
of the backward op for all four groups, as a train step makes it. For each
degree group: max |x - x64| of da and db from the kernels and from the
plain dense route in fp32 (``support_score_backward_plain``: cuBLAS, TF32
off), x64 being the plain route in fp64 on the same operands.

The kernels are run as built from ``csrc/support_score_bwd.cu`` and as
variants whose db ranges hold at most 32 c P rows (``kDbRangeChunks = c``,
one text substitution, built with the flags of ``ops/_build.py`` into
``molkgnn_torch/build/variants/``); c = 1 << 20 never binds, and the
ranges then follow the blocks' share of the work alone. Each is timed too:
device ms of the layer's call by replaying a CUDA graph of 10 calls.

    python3 -m molkgnn_torch.tools.backward_accuracy

Prints the card's name and power limit, a table, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from molkgnn_torch.ops import _build
from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.ops.permutations import num_perms
from molkgnn_torch.ops.similarity import normalize_rows
from molkgnn_torch.tools.backward_profile import CAPACITIES, KERNELS, graph_ms

SOURCE = "constexpr int kDbRangeChunks = 4;"
CHUNKS = (4, 1, 2, 8, 16, 1 << 20)  # the source's own first


def build_variants() -> dict:
    """{c: library path} of the source with kDbRangeChunks = c, every nvcc
    started at once (the source's own c is the package's library)."""
    src = (_build.CSRC / "support_score_bwd.cu").read_text()
    if SOURCE not in src:
        raise RuntimeError(f"{SOURCE!r} is not in support_score_bwd.cu")
    _build.build_all()
    out = {CHUNKS[0]: _build._target(_build.CSRC / "support_score_bwd.cu")}
    folder = _build.BUILD / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    jobs = []
    for c in CHUNKS[1:]:
        cu = folder / f"support_score_bwd_chunks{c}.cu"
        cu.write_text(src.replace(SOURCE, f"constexpr int kDbRangeChunks = "
                                          f"{c};"))
        lib = folder / f"libsupport_score_bwd_chunks{c}.so"
        jobs.append((c, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for c, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kDbRangeChunks = {c}:\n{log}")
        out[c] = lib
    return out


def use(path) -> None:
    """Route the backward op to the library at ``path``."""
    _build._loaded["support_score_bwd"] = ctypes.CDLL(str(path))
    ss._backward_scratch.cache_clear()


def layer_operands(f, rng):
    """(a, b, g, idx) lists of the layer's grouped call, on the card."""
    a, b, g, idx = [], [], [], []
    for d in range(1, 5):
        m, k, l, p = CAPACITIES[d - 1], d * f, KERNELS[d - 1], num_perms(d)
        a.append(normalize_rows(torch.from_numpy(
            rng.standard_normal((m, k)))).float().cuda())
        b.append(normalize_rows(torch.from_numpy(
            rng.standard_normal((p, l, k)))).float().transpose(1, 2)
            .contiguous().cuda())
        g.append(torch.from_numpy(rng.standard_normal((m, l))).float().cuda())
        idx.append(torch.from_numpy(
            rng.integers(0, p, (m, l), dtype=np.int32)).cuda())
    return a, b, g, idx


def errors(got, exact) -> list:
    """[max |da - da64|, max |db - db64|] of one group."""
    return [(x.double() - y).abs().max().item() for x, y in zip(got, exact)]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    libs = build_variants()
    rng = np.random.default_rng(0)
    out = {}
    for layer, f in (("layer 0", 28), ("N-hop layer", 110)):
        a, b, g, idx = layer_operands(f, rng)
        n = len(a)
        exact = [ss.support_score_backward_plain(
            a[i].double(), b[i].double(), g[i].double(), idx[i])
            for i in range(n)]
        rec = {"shapes": [(x.shape[0], x.shape[1], y.shape[2], y.shape[0])
                          for x, y in zip(a, b)],
               "max_abs": [max(t.abs().max().item() for t in e)
                           for e in exact],
               "plain": [errors(ss.support_score_backward_plain(
                   a[i], b[i], g[i], idx[i]), exact[i]) for i in range(n)]}
        for c, path in libs.items():
            use(path)
            das, dbs = ss.support_score_backward(a, b, g, idx, [True] * n,
                                                 [True] * n)
            rec[f"chunks {c}"] = {
                "errors": [errors((das[i], dbs[i]), exact[i])
                           for i in range(n)],
                "device_ms": graph_ms(lambda: ss.support_score_backward(
                    a, b, g, idx, [True] * n, [True] * n)),
            }
        use(libs[CHUNKS[0]])
        out[layer] = rec
        print(f"{layer}: max |x - x64| of (da, db) a group; plain fp32 "
              f"first, then the kernels with db ranges of at most 32 c P "
              f"rows", flush=True)
        for i, shape in enumerate(rec["shapes"]):
            cells = [f"plain {rec['plain'][i][0]:.2e} {rec['plain'][i][1]:.2e}"]
            cells += [f"c={c}: {rec[f'chunks {c}']['errors'][i][0]:.2e} "
                      f"{rec[f'chunks {c}']['errors'][i][1]:.2e}"
                      for c in CHUNKS]
            print(f"  {shape} max|x64| {rec['max_abs'][i]:.3g}: "
                  + "; ".join(cells), flush=True)
        print("  device ms of the call: " + ", ".join(
            f"c={c} {rec[f'chunks {c}']['device_ms']:.4f}" for c in CHUNKS),
            flush=True)
    print(json.dumps({"card": card, "layers": out}), flush=True)


if __name__ == "__main__":
    main()
