"""Interpretability as validation: enantiomer embedding comparison.

Port of ``molkgnn_tpu/analyses/embedding_compare.py``: cosine-compare the
graph embeddings of stereoisomers; a chirality-aware model must separate
mirror molecules (cosine < 1) while achiral duplicates stay identical.
``enantiomer_separation`` serves the kgnn ``GraphBatch`` only, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch


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


def enantiomer_separation(model, batch_for, mirror_pairs) -> Dict[str, float]:
    """Cosine between the graph embeddings of each molecule and its mirror
    image, ``{name: cos}`` for ``mirror_pairs`` of ``(name, molecule)``.

    ``model`` is an ``nn.Module`` mapping a kgnn ``GraphBatch`` to
    ``[B, D]`` embeddings (e.g. ``MolKGNNNet``); ``batch_for(graph)`` builds
    a one-molecule batch on the CPU. The mirror image negates the batch's
    ``p`` (a proper enantiomer for tetrahedral centres). Both run under
    ``torch.no_grad()`` on the device of the model's parameters.
    """
    device = next(model.parameters()).device
    out = {}
    with torch.no_grad():
        for name, g in mirror_pairs:
            b = batch_for(g).to(device)
            bm = dataclasses.replace(b, p=-b.p)
            e = model(b).double().cpu().numpy()
            em = model(bm).double().cpu().numpy()
            out[name] = cosine(e[0], em[0])
    return out
