"""Contrastive / triplet training utilities (the ChIRo standalone harness).

Port of ``molkgnn_tpu/training/contrastive.py``: the losses as torch
functions of tensors (differentiable, on any device), the host-side
samplers copied. Losses: the triplet margin loss with four distance
metrics, the mean squared error and the margin ranking loss over
stereoisomer pairs. Samplers: Siamese positive/negative maps over
stereoisomer groups and the stereoisomer-grouped batch sampler; they draw
from the ``np.random.Generator`` they are given, so the same seed draws
what the JAX package's samplers draw.

Stereoisomer grouping keys on a stereo-stripped SMILES
(``smiles_nostereo``): molecules sharing it are stereoisomers of each
other; positives for the anchor are *other conformers/records of the same
isomer*, negatives are *different stereoisomers of the same skeleton*.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _distance(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    if metric in ("euclidean", "euclidean_normalized"):
        # torch's PairwiseDistance adds its eps inside the difference.
        return torch.linalg.vector_norm(a - b + 1e-6, dim=-1)
    if metric == "manhattan":
        return (a - b).abs().sum(-1)
    if metric == "cosine":
        num = (a * b).sum(-1)
        den = torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1),
            min=1e-8,
        )
        return 1.0 - num / den
    raise ValueError(f"distance metric {metric} is not implemented")


def triplet_loss(
    z_anchor: torch.Tensor,
    z_positive: torch.Tensor,
    z_negative: torch.Tensor,
    margin: float = 1.0,
    reduction: str = "mean",
    distance_metric: str = "euclidean",
) -> torch.Tensor:
    """max(d(a,p) - d(a,n) + margin, 0) with the reference's metric set.

    ``euclidean_normalized`` L2-normalizes all three embeddings first.
    """
    if distance_metric == "euclidean_normalized":
        def norm(z):
            return z / torch.linalg.vector_norm(z + 1e-10, dim=1,
                                                keepdim=True)

        z_anchor, z_positive, z_negative = (
            norm(z_anchor), norm(z_positive), norm(z_negative),
        )
    d_pos = _distance(z_anchor, z_positive, distance_metric)
    d_neg = _distance(z_anchor, z_negative, distance_metric)
    per = torch.clamp(d_pos - d_neg + margin, min=0.0)
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def mse_loss(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    return ((y - y_hat) ** 2).mean()


def ranking_loss(
    pred_i: torch.Tensor,
    pred_j: torch.Tensor,
    target_i: torch.Tensor,
    target_j: torch.Tensor,
    margin: float = 0.3,
) -> torch.Tensor:
    """Margin ranking over stereoisomer pairs: the prediction gap must
    agree in sign with the target gap by at least ``margin``."""
    sign = torch.sign(target_i - target_j)
    return torch.clamp(-sign * (pred_i - pred_j) + margin, min=0.0).mean()


# ---------------------------------------------------------------------------
# Samplers (host-side), copied
# ---------------------------------------------------------------------------
class SampleMapToPositives:
    """index -> other records of the SAME stereoisomer (same full smiles)."""

    def __init__(self, smiles: Sequence[str], include_anchor: bool = False):
        groups: Dict[str, List[int]] = defaultdict(list)
        for i, s in enumerate(smiles):
            groups[s].append(i)
        self.positives = {
            i: [j for j in groups[s] if include_anchor or j != i]
            for i, s in enumerate(smiles)
        }

    def sample(self, i: int, rng: np.random.Generator, n: int = 1) -> List[int]:
        pool = self.positives[i]
        if not pool:
            return [i] * n
        return list(rng.choice(pool, size=n, replace=len(pool) < n))


class SampleMapToNegatives:
    """index -> records of DIFFERENT stereoisomers sharing the stereo-
    stripped smiles."""

    def __init__(self, smiles: Sequence[str], smiles_nostereo: Sequence[str]):
        skeleton: Dict[str, List[int]] = defaultdict(list)
        for i, s in enumerate(smiles_nostereo):
            skeleton[s].append(i)
        self.negatives = {
            i: [
                j
                for j in skeleton[smiles_nostereo[i]]
                if smiles[j] != smiles[i]
            ]
            for i in range(len(smiles))
        }

    def sample(self, i: int, rng: np.random.Generator, n: int = 1) -> List[int]:
        pool = self.negatives[i]
        if not pool:
            return [i] * n
        return list(rng.choice(pool, size=n, replace=len(pool) < n))


class StereoBatchSampler:
    """Batches of whole stereoisomer groups: groups (by stereo-stripped
    smiles) are shuffled, then packed whole into batches of at most
    ``batch_size`` records."""

    def __init__(
        self,
        smiles_nostereo: Sequence[str],
        batch_size: int,
        seed: int = 0,
    ):
        groups: Dict[str, List[int]] = defaultdict(list)
        for i, s in enumerate(smiles_nostereo):
            groups[s].append(i)
        self.groups = list(groups.values())
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        order = self.rng.permutation(len(self.groups))
        batch: List[int] = []
        for gi in order:
            group = self.groups[gi]
            if batch and len(batch) + len(group) > self.batch_size:
                yield batch
                batch = []
            batch.extend(group)
        if batch:
            yield batch

    def __len__(self):
        total = sum(len(g) for g in self.groups)
        return -(-total // self.batch_size)


def make_triplets(
    smiles: Sequence[str],
    smiles_nostereo: Sequence[str],
    num: int,
    seed: int = 0,
):
    """(anchor, positive, negative) index triples for contrastive
    training, [num, 3] int64."""
    rng = np.random.default_rng(seed)
    pos_map = SampleMapToPositives(smiles, include_anchor=True)
    neg_map = SampleMapToNegatives(smiles, smiles_nostereo)
    anchors = [i for i in range(len(smiles)) if neg_map.negatives[i]]
    if not anchors:
        return np.zeros((0, 3), np.int64)
    out = []
    for _ in range(num):
        a = int(rng.choice(anchors))
        p = pos_map.sample(a, rng)[0]
        n = neg_map.sample(a, rng)[0]
        out.append((a, p, n))
    return np.array(out, np.int64)
