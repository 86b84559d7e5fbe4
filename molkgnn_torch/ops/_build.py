"""Build the CUDA sources of ``molkgnn_torch/csrc`` and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``molkgnn_torch/build/``
(resolved from this file, never from the working directory). A library is
named after a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. All sources compile in parallel, one
``nvcc`` each. Nothing is built at import time: ``library`` builds on its
first call, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME (default /usr/local/cuda)"
    )


def _target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD / f"lib{src.stem}_{digest}.so"


def build_all() -> float:
    """Compile every stale ``csrc/*.cu`` at once; returns the seconds taken."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    lib = _loaded.get(stem)
    if lib is None:
        src = CSRC / f"{stem}.cu"
        if not _target(src).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(src)))
        _loaded[stem] = lib
    return lib
