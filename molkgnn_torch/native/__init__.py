"""Native (C++) host-side graph utilities, with their plain numpy versions.

Port of ``molkgnn_tpu/native``:

  * ``floyd_warshall`` / ``gen_edge_input``: all-pairs shortest paths and
    edge-feature sequences along them, as the reference implementation's
    Cython module computes them (LanceKnight/MolKGNN, ``algos.pyx``). No
    model uses them; they are utilities.
  * ``ranges_gather_f32`` / ``ranges_gather_offset_i32`` of the C file
    (expand per-graph ``[start, start + len)`` ranges and gather rows, the
    second adding a per-range offset): ``library()`` declares their
    argument types; as in the JAX module, no Python function wraps them.

``src/graph_ops.cpp`` is compiled by ``g++ -O3 -shared -fPIC`` into
``molkgnn_torch/build/`` (resolved from this file, never from the working
directory), under a name carrying a hash of the source and the flags, on
first use, never at import. A failed build raises: unlike the JAX module,
which falls back to numpy in silence, the library functions here always
run the library. The numpy versions are kept under their own names
(``floyd_warshall_numpy``, ``gen_edge_input_numpy``), as the plain versions
the tests hold the library against. ``have_native()`` says whether the
library built, and does not raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "graph_ops.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

UNREACHABLE = 510

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD / f"libgraph_ops_{digest}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build graph_ops")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing; raises
    ``RuntimeError`` if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        for name, args in {
            "floyd_warshall": [i64p, i64, i64p, i64p],
            "gen_edge_input": [i64p, i64p, f32p, i64, i64, i64, f32p],
            "ranges_gather_f32": [f32p, i64, i64p, i64p, i64, f32p],
            "ranges_gather_offset_i32": [i32p, i64, i64p, i64p, i32p, i64,
                                         i32p],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, None
        _lib = lib
        return lib


def have_native() -> bool:
    """Whether the library builds and loads (never raises)."""
    try:
        library()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def _square(a: np.ndarray, what: str) -> int:
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{what} must be [n, n], got {a.shape}")
    return a.shape[0]


def floyd_warshall(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs shortest paths of a dense adjacency (nonzero = edge):
    (dist, pred), int64 [n, n]; dist is 510 where a pair cannot be reached
    (the reference's sentinel), pred the intermediate vertex (-1: a direct
    edge or none)."""
    adj = np.ascontiguousarray(adj, np.int64)
    n = _square(adj, "adj")
    dist = np.empty((n, n), np.int64)
    pred = np.empty((n, n), np.int64)
    library().floyd_warshall(adj, n, dist, pred)
    return dist, pred


def floyd_warshall_numpy(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain numpy version of ``floyd_warshall``."""
    adj = np.asarray(adj)
    n = _square(adj, "adj")
    dist = np.where(adj > 0, 1, UNREACHABLE).astype(np.int64)
    np.fill_diagonal(dist, 0)
    pred = np.full((n, n), -1, np.int64)
    for k in range(n):
        cand = dist[:, k][:, None] + dist[k, :][None, :]
        better = cand < dist
        dist[better] = cand[better]
        pred[better] = k
    return dist, pred


def _max_dist(dist: np.ndarray, max_dist: Optional[int]) -> int:
    if max_dist is None:
        finite = dist[dist < UNREACHABLE]
        max_dist = int(finite.max()) if finite.size else 1
    return max(int(max_dist), 1)


def gen_edge_input(
    dist: np.ndarray,
    pred: np.ndarray,
    edge_feat: np.ndarray,
    max_dist: Optional[int] = None,
) -> np.ndarray:
    """Edge-feature sequences along the shortest paths:
    ``out[i, j, h]`` is ``edge_feat`` of the path's h-th edge from i to j,
    float32 [n, n, max_dist, f] (0 past the path's end, on the diagonal and
    where j cannot be reached). ``max_dist`` defaults to the longest finite
    distance."""
    dist = np.ascontiguousarray(dist, np.int64)
    pred = np.ascontiguousarray(pred, np.int64)
    edge_feat = np.ascontiguousarray(edge_feat, np.float32)
    n = _square(dist, "dist")
    if pred.shape != dist.shape or edge_feat.ndim != 3 or (
            edge_feat.shape[:2] != (n, n)):
        raise ValueError(
            f"want dist, pred [n, n] and edge_feat [n, n, f]; got "
            f"{dist.shape}, {pred.shape}, {edge_feat.shape}")
    fdim, max_dist = edge_feat.shape[-1], _max_dist(dist, max_dist)
    out = np.empty((n, n, max_dist, fdim), np.float32)
    library().gen_edge_input(dist, pred, edge_feat, n, fdim, max_dist, out)
    return out


def _walk_path(pred: np.ndarray, i: int, j: int) -> list:
    k = pred[i, j]
    if k < 0:
        return [i, j]
    left = _walk_path(pred, i, k)
    right = _walk_path(pred, k, j)
    return left + right[1:]


def gen_edge_input_numpy(
    dist: np.ndarray,
    pred: np.ndarray,
    edge_feat: np.ndarray,
    max_dist: Optional[int] = None,
) -> np.ndarray:
    """The plain numpy version of ``gen_edge_input``."""
    n, fdim = dist.shape[0], edge_feat.shape[-1]
    max_dist = _max_dist(dist, max_dist)
    out = np.zeros((n, n, max_dist, fdim), np.float32)
    for i in range(n):
        for j in range(n):
            if i == j or dist[i, j] >= UNREACHABLE:
                continue
            path = _walk_path(pred, i, j)
            for h in range(min(len(path) - 1, max_dist)):
                out[i, j, h] = edge_feat[path[h], path[h + 1]]
    return out
