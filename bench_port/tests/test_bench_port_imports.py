"""What the harness and the reference load, each in a fresh interpreter.

Names are compared by their top-level module, the part before the first
dot, whole: ``molkgnn_torch`` is not ``molkgnn_tpu``.
"""

import json
import subprocess
import sys

from bench_port import files

JAX = {"jax", "jaxlib", "flax", "molkgnn_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=files.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _top_level(
        "import bench_port.run, bench_port.program, bench_port.control, "
        "bench_port.trace, bench_port.check")
    assert "molkgnn_torch" in loaded
    assert not loaded & JAX


def test_reference_loads_neither_jax_nor_the_program():
    loaded = _top_level(
        "import bench_port.reference.kgnn, bench_port.reference.schnet, "
        "bench_port.check, bench_port.traffic, bench_port.roofline")
    assert not loaded & (JAX | {"molkgnn_torch"})


def test_metric_readers_load_neither():
    names = [m["name"] for m in files.benchmark()["per_layer"]]
    loaded = _top_level(
        "from bench_port import files\n"
        + "".join(f"files.metric({n!r})\n" for n in names))
    assert not loaded & (JAX | {"molkgnn_torch"})


def test_forbidden_modules_compares_whole_top_level_names():
    from bench_port import run

    before = dict(sys.modules)
    try:
        sys.modules["molkgnn_tpu_like.x"] = sys
        sys.modules["molkgnn_torch_extra"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in before} & JAX)
        sys.modules["jaxlib.xla"] = sys
        assert "jaxlib" in run.forbidden_modules()
    finally:
        for k in ("molkgnn_tpu_like.x", "molkgnn_torch_extra", "jaxlib.xla"):
            if k not in before:
                sys.modules.pop(k, None)
