"""Interpretability as validation: enantiomer embedding comparison.

Copied from ``molkgnn_tpu/analyses/embedding_compare.py`` (its numpy part):
cosine-compare the graph embeddings of stereoisomers; a chirality-aware
model must separate mirror molecules (cosine < 1) while achiral duplicates
stay identical.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    denom = max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    return float(np.dot(a, b) / denom)


def compare_embeddings(
    embeddings: np.ndarray, labels: Sequence[str]
) -> Dict[str, float]:
    """Pairwise cosine table over labeled embeddings ({"A-B": cos, ...})."""
    out = {}
    for i in range(len(labels)):
        for j in range(i + 1, len(labels)):
            out[f"{labels[i]}-{labels[j]}"] = cosine(
                embeddings[i], embeddings[j]
            )
    return out
