"""Cosine-similarity scoring as matrix products.

Port of ``molkgnn_tpu/ops/similarity.py``. Cosine similarity of
row-normalized tensors is a plain dot product, so scoring every
(neighborhood, kernel, permutation) is one [M, d*F] x [d*F, L*P] product.

Row normalization divides by ``max(|v|, 1e-12)``; this is not the eps of
torch's ``CosineSimilarity`` (``dot / max(|a|*|b|, 1e-8)``). The two agree
except when both norms are ~1e-8 (true zero rows give 0 in both).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def normalize_rows(t: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2-normalize along ``axis`` with zero-safe clamping."""
    n = torch.linalg.vector_norm(t, dim=axis, keepdim=True)
    return t / torch.clamp(n, min=_EPS)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32/bf16 operands, fp64 for fp64 operands."""
    return torch.promote_types(dtype, torch.float32)


def cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity: a [M, F], b [L, F] -> [M, L]."""
    acc = _acc_dtype(a.dtype)
    return normalize_rows(a).to(acc) @ normalize_rows(b).to(acc).T


def neighborhood_similarity(
    nei: torch.Tensor,
    support_perm: torch.Tensor,
    matmul_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Mean-over-neighbors cosine score for every (node, kernel, permutation).

    Args:
      nei: [M, d, F] neighborhood attributes (node or edge features).
      support_perm: [L, P, d, F] permuted kernel supports.
      matmul_dtype: optional reduced precision (e.g. ``torch.bfloat16``) for
        the operands of the product; normalization and accumulation stay in
        fp32 (fp64 for fp64 inputs). The operands are rounded to
        ``matmul_dtype`` and the product runs on the rounded values in the
        accumulation type, whose products of bf16 values are exact.

    Returns:
      [M, L, P] scores: mean_d cos(nei[m, d], support_perm[l, p, d]).
    """
    m, d, f = nei.shape
    l, p = support_perm.shape[0], support_perm.shape[1]
    acc = _acc_dtype(nei.dtype)
    a = normalize_rows(nei).reshape(m, d * f)
    b = normalize_rows(support_perm).reshape(l * p, d * f)
    if matmul_dtype is not None:
        a = a.to(matmul_dtype)
        b = b.to(matmul_dtype)
    sc = (a.to(acc) @ b.to(acc).T) / d
    return sc.reshape(m, l, p)
