"""Peaks of the card and the work of the permutation scorer.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit). A kernel's share of its roofline is the least time the
card could take for its work, the larger of operations over the compute
peak and bytes over the memory rate, over the kernel's measured time.

The scorer's compute peak is the TF32 tensor cores' 495 TFLOP/s, not
fp32's 67 outside them: its backward runs on the tensor cores (3xTF32),
and a forward there would be the same work. Against 67, a correct
tensor-core kernel would read above 100%; against 495 no implementation
with fp32 inputs can, and a lower precision is the check's to catch.
"""

from __future__ import annotations

from typing import Iterable, Tuple

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

Shape = Tuple[float, float, float, float]  # (M, K, L, P)


def scorer_forward_work(shapes: Iterable[Shape]) -> Tuple[float, float]:
    """(operations, bytes) of the scorer's forward over groups (M, K, L,
    P): every (row, kernel, ordering) score, a K-long dot product, then the
    max over orderings; A [M, K] and B [P, K, L] read once, the best score
    and its ordering [M, L] (4 bytes each) written once."""
    ops = sum(2 * m * k * l * p for m, k, l, p in shapes)
    nbytes = sum((m * k + p * k * l) * 4 + m * l * 8 for m, k, l, p in shapes)
    return ops, nbytes


def scorer_backward_work(shapes: Iterable[Shape]) -> Tuple[float, float]:
    """(operations, bytes) of the scorer's backward through the best
    ordering: dA and dB, an FMA a term each; a, b, the output gradient
    and the ordering read once, da and db written once."""
    ops = sum(4 * m * k * l for m, k, l, _ in shapes)
    nbytes = sum(4 * (2 * m * k + 2 * p * k * l + 2 * m * l)
                 for m, k, l, p in shapes)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float,
                  flops: float = TF32_FLOPS) -> Tuple[float, str]:
    """(least time, what sets it: "operations" or "bytes")."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
