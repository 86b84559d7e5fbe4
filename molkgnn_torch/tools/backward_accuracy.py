#!/usr/bin/env python3
r"""The support scorer backward's accuracy against fp64, and its variants.

At the flagship's grouped launches (layer 0, F = 28, and an N-hop layer,
F = 110, at the serving bucket capacities of 8192 synthetic molecules at
batch 1024), with operands made as ``tests/test_torch_port_cuda.py``'s
``_backward_operands`` makes them (a and b unit vectors along k, then g
standard normal, then idx uniform in [0, P), from each seed of ``SEEDS``),
one call of the backward op for all four groups, as a train step makes it.
For each degree group: max |x - x64| of da and db from the kernels and from
the plain dense route in fp32 (``support_score_backward_plain``: cuBLAS,
TF32 off), x64 being the plain route in fp64 on the same operands; and the
limit 2 max |plain - x64| + 2^-23 max |x64|, which a variant "meets" where
every group and gradient of both layers at every seed stays within it.

The kernels run as built from ``csrc/support_score_bwd.cu`` ("source") and
as the variants of ``VARIANTS``, each a set of the source's constants set
to other values (text substitutions, built with the flags of
``ops/_build.py`` into ``molkgnn_torch/build/variants/``, every nvcc at
once): the promotion intervals (``kDaPromoteSteps``, ``kDbPromoteChunks``;
1 << 20 never promotes before the end), da's k8 steps a stage, db's layout
(warpgroups a block, chunks of 32 columns n a block, a^T fragments in
registers) and db's ranges (``kDbRangeChunks``, 1 << 20 never binds;
``kDbBlocks``). ``--other NAME=PATH`` adds another source with the same C
interface, such as a parent checkout's. For each: the da and db kernels'
registers and local bytes (spills) on the card, and the device ms of each
layer's call, of its da alone and of its db alone, by replaying a CUDA
graph of 10 calls.

    python3 -m molkgnn_torch.tools.backward_accuracy
    python3 -m molkgnn_torch.tools.backward_accuracy --other \
        "parent=<checkout>/molkgnn_torch/csrc/support_score_bwd.cu"

Prints the card's name and power limit, a table a layer and seed (each
variant's distances as multiples of the fp32 route's), a line a variant
(whether it meets the limit, its times and registers), and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from molkgnn_torch.ops import _build
from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.ops.permutations import num_perms
from molkgnn_torch.ops.similarity import normalize_rows
from molkgnn_torch.tools.backward_profile import CAPACITIES, KERNELS, graph_ms

NEVER = 1 << 20
VARIANTS = {
    "source": {},
    "da T=2": {"kDaPromoteSteps": 2, "kDaSteps": 2},
    "da T=8": {"kDaPromoteSteps": 8},
    "da 2 steps a stage": {"kDaSteps": 2},
    "db 2 chunks": {"kDbPromoteChunks": 2},
    "db unpromoted": {"kDbPromoteChunks": NEVER},
    "db 2 fragments": {"kDbFragments": 2},
    "db 2 wg x 128 n": {"kDbWarpgroups": 2, "kMaxChunks": 4},
    "db cap 2": {"kDbRangeChunks": 2},
    "db cap 8": {"kDbRangeChunks": 8},
    "db no cap": {"kDbRangeChunks": NEVER},
    "db 264 blocks": {"kDbBlocks": 264},
}
SEEDS = (17, 18)
LAYERS = (("layer 0", 28), ("N-hop layer", 110))


def variant_source(src: str, values: dict) -> str:
    """``src`` with each ``constexpr int NAME = ...;`` of ``values`` set to
    its value; raises where a name is not defined exactly once."""
    for name, value in values.items():
        pattern = re.compile(rf"constexpr int {name} = [^;]+;")
        if len(pattern.findall(src)) != 1:
            raise RuntimeError(f"{name} is not defined once in the source")
        src = pattern.sub(f"constexpr int {name} = {value};", src)
    return src


def build_variants(others=()) -> dict:
    """{variant: library path}; the source's own is the package's library.
    ``others``: (name, path of a source with the same C interface) pairs,
    built beside the variants (another checkout's kernels)."""
    src = (_build.CSRC / "support_score_bwd.cu").read_text()
    _build.build_all()
    out = {"source": _build._target(_build.CSRC / "support_score_bwd.cu")}
    folder = _build.BUILD / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    texts = [(name, variant_source(src, values))
             for name, values in VARIANTS.items() if values]
    texts += [(name, Path(path).read_text()) for name, path in others]
    jobs = []
    for i, (name, text) in enumerate(texts):
        cu = folder / f"support_score_bwd_v{i}.cu"
        cu.write_text(text)
        lib = folder / f"libsupport_score_bwd_v{i}.so"
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = lib
    return out


def use(path) -> None:
    """Route the backward op to the library at ``path``."""
    _build._loaded["support_score_bwd"] = ctypes.CDLL(str(path))
    ss._backward_scratch.cache_clear()


def layer_operands(f, seed):
    """(a, b, g, idx) lists of the layer's grouped call, on the card, drawn
    in ``_backward_operands``'s order."""
    rng = np.random.default_rng(seed)
    shapes = [(CAPACITIES[d - 1], d * f, KERNELS[d - 1], num_perms(d))
              for d in range(1, 5)]
    a = [normalize_rows(torch.from_numpy(rng.standard_normal((m, k))))
         .float().cuda() for m, k, _, _ in shapes]
    b = [normalize_rows(torch.from_numpy(rng.standard_normal((p, l, k))))
         .float().transpose(1, 2).contiguous().cuda()
         for _, k, l, p in shapes]
    g = [torch.from_numpy(rng.standard_normal((m, l))).float().cuda()
         for m, _, l, _ in shapes]
    idx = [torch.from_numpy(rng.integers(0, p, (m, l), dtype=np.int32))
           .cuda() for m, _, l, p in shapes]
    return a, b, g, idx


def errors(got, exact) -> list:
    """[max |da - da64|, max |db - db64|] of one group."""
    return [(x.double() - y).abs().max().item() for x, y in zip(got, exact)]


def references(operands) -> dict:
    """The fp64 route, its largest values, the fp32 route's distance from
    it and the limit, a group."""
    a, b, g, idx = operands
    exact = [ss.support_score_backward_plain(
        a[i].double(), b[i].double(), g[i].double(), idx[i])
        for i in range(len(a))]
    plain = [errors(ss.support_score_backward_plain(a[i], b[i], g[i], idx[i]),
                    exact[i]) for i in range(len(a))]
    top = [[t.abs().max().item() for t in e] for e in exact]
    limit = [[2 * p + 2.0 ** -23 * t for p, t in zip(pg, tg)]
             for pg, tg in zip(plain, top)]
    return {"exact": exact, "plain": plain, "max_abs": top, "limit": limit}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--other", action="append", default=[], metavar="NAME=PATH",
        help="also run the kernels of another support_score_bwd.cu (the "
             "same C interface), e.g. a parent checkout's")
    args = parser.parse_args()
    others = [tuple(o.rsplit("=", 1)) for o in args.other]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    libs = build_variants(others)
    cases = {(layer, seed): layer_operands(f, seed)
             for layer, f in LAYERS for seed in SEEDS}
    refs = {key: references(ops) for key, ops in cases.items()}
    out = {"card": card, "seeds": SEEDS, "variants": {}}
    for name, path in libs.items():
        use(path)
        facts = ss.backward_facts()
        rec = {"values": VARIANTS.get(name, dict(others).get(name)),
               "facts": {k: facts[k] for k in ("da", "db")},
               "errors": {}, "device_ms": {}, "meets": True}
        for (layer, seed), (a, b, g, idx) in cases.items():
            n = len(a)
            das, dbs = ss.support_score_backward(a, b, g, idx, [True] * n,
                                                 [True] * n)
            errs = [errors((das[i], dbs[i]), refs[layer, seed]["exact"][i])
                    for i in range(n)]
            rec["errors"][f"{layer}, seed {seed}"] = errs
            rec["meets"] &= all(
                e <= lim for eg, lg in zip(errs, refs[layer, seed]["limit"])
                for e, lim in zip(eg, lg))
            if seed == SEEDS[0]:
                rec["device_ms"][layer] = [graph_ms(
                    lambda: ss.support_score_backward(
                        a, b, g, idx, [want_a] * n, [want_b] * n))
                    for want_a, want_b in ((True, True), (True, False),
                                           (False, True))]
        out["variants"][name] = rec
    use(libs["source"])
    for (layer, seed), ref in refs.items():
        a, b = cases[layer, seed][:2]
        print(f"{layer}, seed {seed}: max |x - x64| of (da, db) a group as a "
              f"multiple of the fp32 route's (plain, cuBLAS TF32 off; "
              f"limit 2x + 2^-23 max |x64|)", flush=True)
        for i in range(len(a)):
            shape = (a[i].shape[0], a[i].shape[1], b[i].shape[2],
                     b[i].shape[0])
            cells = []
            for name, rec in out["variants"].items():
                da, db = rec["errors"][f"{layer}, seed {seed}"][i]
                cells.append(f"{name} {da / ref['plain'][i][0]:.2f} "
                             f"{db / ref['plain'][i][1]:.2f}")
            print(f"  {shape} plain {ref['plain'][i][0]:.2e} "
                  f"{ref['plain'][i][1]:.2e}, limit {ref['limit'][i][0]:.2e} "
                  f"{ref['limit'][i][1]:.2e}: " + "; ".join(cells),
                  flush=True)
    for name, rec in out["variants"].items():
        f = rec["facts"]
        print(f"{name}: meets {rec['meets']}; device ms (call, da alone, "
              f"db alone) " + "; ".join(
                  f"{k} " + ", ".join(f"{v:.4f}" for v in ms)
                  for k, ms in rec["device_ms"].items())
              + f"; da {f['da']['registers']} registers, "
              f"{f['da']['local_bytes']} local bytes; db "
              f"{f['db']['registers']}, {f['db']['local_bytes']}",
              flush=True)
    for ref in refs.values():
        del ref["exact"]
    out["references"] = {f"{layer}, seed {seed}": ref
                         for (layer, seed), ref in refs.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
