#!/usr/bin/env python3
"""Time diagnostic variants of the support-score kernel on one GPU.

Each variant is ``molkgnn_torch/csrc/support_score.cu`` with a few text
substitutions (``VARIANTS``), built with the flags of ``ops/_build.py``
into ``molkgnn_torch/build/variants/`` and called through its C entry
point, so that the Python wrapper's host cost stays out of the times. Each
is held against the plain version (``max |err|``; the diagnostic variants
skip work and are wrong on purpose) and timed with CUDA events (best of 3
runs of 50 back-to-back launches) at the flagship serving shapes: the
layer-0 and N-hop grouped launches, degrees 3 and 4 alone, and degree 4
with 7.5 times the rows, where the grid is many waves deep and the launch's
tail no longer weighs.

    python3 -m molkgnn_torch.tools.scorer_variants [name ...]

With no names it runs every variant. It prints the card's name and power
limit, and the SM clock and power sampled while it ran.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from molkgnn_torch.ops._build import BUILD, CSRC, NVCC_FLAGS, _nvcc
from molkgnn_torch.ops.support_score import block_order, support_score_plain

# name -> [(text in support_score.cu, replacement)]
VARIANTS = {
    "kernel": [],
    # Compute only: no copies after the first; the chunks hold stale data.
    "compute_only": [
        ("    if (next < chunks) {", "    if (false) {"),
        ("if (s < chunks) load_chunk", "if (false) load_chunk"),
    ],
    # Copies only: the FMAs are skipped.
    "copies_only": [
        ("      if (computes) {\n        const float* as",
         "      if (false) {\n        const float* as"),
    ],
    "no_b_copies": [("  load_b<T>(g, t, pass, chunk, stage);\n}", "}")],
    "no_a_copies": [
        ("    case 4: load_a<T, 4>(g, m0, k0, stage); break;",
         "    case 4: break;"),
    ],
    # More warps an SM, for fewer rows a thread.
    "two_blocks_per_sm": [
        ("using Tile12 = Tile<12, 8, 1, 10, 25>;",
         "using Tile12 = Tile<12, 4, 1, 10, 25>;"),
        ("using Tile6 = Tile<6, 8, 2, 15, 17>;",
         "using Tile6 = Tile<6, 4, 2, 15, 17>;"),
        ("using Tile2 = Tile<2, 8, 4, 5, 51>;",
         "using Tile2 = Tile<2, 4, 4, 5, 51>;"),
        ("using Tile1 = Tile<1, 4, 5, 2, 128>;",
         "using Tile1 = Tile<1, 2, 5, 2, 128>;"),
        ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)"),
    ],
    "threads_384": [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 384;"),
        ("using Tile12 = Tile<12, 8, 1, 10, 25>;",
         "using Tile12 = Tile<12, 6, 1, 10, 38>;"),
        ("using Tile6 = Tile<6, 8, 2, 15, 17>;",
         "using Tile6 = Tile<6, 6, 2, 15, 25>;"),
        ("using Tile2 = Tile<2, 8, 4, 5, 51>;",
         "using Tile2 = Tile<2, 4, 4, 5, 76>;"),
        ("using Tile1 = Tile<1, 4, 5, 2, 128>;",
         "using Tile1 = Tile<1, 4, 5, 2, 192>;"),
    ],
    "k_loop_unrolled_4": [
        ("#pragma unroll 2\n        for (int k4 = 0;",
         "#pragma unroll 4\n        for (int k4 = 0;"),
    ],
    "k_loop_unrolled_fully": [
        ("#pragma unroll 2\n        for (int k4 = 0;",
         "#pragma unroll\n        for (int k4 = 0;"),
    ],
}

FLAGSHIP = {  # degree: (rows at batch 1024, kernels L, permutations P)
    1: (19232, 10, 1), 2: (13640, 20, 2), 3: (8144, 30, 6), 4: (7064, 50, 12),
}


def build(names):
    src = (CSRC / "support_score.cu").read_text()
    out = BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.molkgnn_support_score.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.molkgnn_support_score_scratch.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.molkgnn_support_score_scratch.restype = ctypes.c_int64
        libs[name] = lib
        spills = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {spills[-1] if spills else 'built'}", flush=True)
    return libs


def operand_sets():
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    sets = {}
    for layer, f in (("layer 0", 28), ("N-hop", 110)):
        a, b = [], []
        for d, (m, l, p) in FLAGSHIP.items():
            a.append(unit(torch.randn(m, d, f, generator=gen, device="cuda"))
                     .reshape(m, d * f))
            b.append(unit(torch.randn(l, p, d, f, generator=gen,
                                      device="cuda"))
                     .reshape(l, p, d * f).permute(1, 2, 0).contiguous())
        sets[f"{layer} grouped"] = (a, b)
        sets[f"{layer} degree 4"] = (a[3:], b[3:])
        sets[f"{layer} degree 3"] = (a[2:3], b[2:3])
    deep = unit(torch.randn(52800, 440, generator=gen, device="cuda"))
    sets["N-hop degree 4, 52800 rows"] = ([deep], sets["N-hop degree 4"][1])
    return sets


def time_variant(lib, a, b, stream):
    shapes = [(x.shape[0], x.shape[1], y.shape[2], y.shape[0])
              for x, y in zip(a, b)]
    outs = [(torch.full((m, l), float("nan"), device="cuda"),
             torch.empty(m, l, dtype=torch.int32, device="cuda"))
            for m, _, l, _ in shapes]
    args = []
    for i in block_order(shapes):
        args += [a[i].data_ptr(), b[i].data_ptr(), outs[i][0].data_ptr(),
                 outs[i][1].data_ptr(), *shapes[i]]
    arr = (ctypes.c_int64 * len(args))(*args)
    n = lib.molkgnn_support_score_scratch(len(shapes), arr)
    scratch = torch.empty(n + 4, device="cuda")

    def call():
        err = lib.molkgnn_support_score(
            len(shapes), arr, scratch.data_ptr(), n, stream
        )
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    call()
    torch.cuda.synchronize()
    err = max(float((o[0] - support_score_plain(x, y)[0]).abs().max())
              for o, x, y in zip(outs, a, b))
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 50)
    flops = sum(2 * m * k * l * p for m, k, l, p in shapes)
    return best, flops / best / 1e9, err


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("scorer_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    smi = ["nvidia-smi", "--format=csv,noheader"]
    print(subprocess.run(smi + ["--query-gpu=name,power.limit"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(names)
    sets = operand_sets()
    stream = torch.cuda.current_stream().cuda_stream
    monitor = subprocess.Popen(
        smi + ["--query-gpu=clocks.sm,power.draw", "-lms", "250"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        for what, (a, b) in sets.items():
            cells = []
            for name, lib in libs.items():
                ms, tflops, err = time_variant(lib, a, b, stream)
                cells.append(f"{name} {ms:.4f} ms {tflops:.1f} TFLOP/s "
                             f"err {err:.1e}")
            print(f"{what}: " + " | ".join(cells), flush=True)
    finally:
        monitor.terminate()
        samples = monitor.communicate()[0].split("\n")
    print("SM clock, power while timing:",
          sorted({s.strip() for s in samples if s.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
