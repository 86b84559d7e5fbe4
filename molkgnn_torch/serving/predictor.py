"""Inference / serving path: trained weights -> batched predictor.

Port of ``molkgnn_tpu/serving/predictor.py::Predictor``: chunked batching
of any number of molecules through one fixed-shape ``BatchSpec`` (the last
partial chunk is padded and its padding masked out), raw logits or sigmoid
probabilities, and optional graph embeddings.

On the card, float32 products run in full float32: TF32 is switched off
for matrix products and cuDNN, because the permutation argmax of the score
products would otherwise move with the lost digits.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from molkgnn_torch.graphs.batch import BatchSpec, batch_graphs
from molkgnn_torch.graphs.molgraph import MolGraph


def sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically stable two-branch sigmoid (exp only sees x <= 0)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``device`` or, when None, the card. Raises when the card is asked for
    (explicitly or by default) and CUDA is absent: there is no silent CPU
    fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


class Predictor:
    """Wraps a GNNModel and its weights for fixed-shape batched inference."""

    def __init__(
        self,
        model: nn.Module,
        state_dict: Mapping[str, torch.Tensor],
        spec: BatchSpec,
        device: Optional[str | torch.device] = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.spec = spec

    @torch.inference_mode()
    def predict_graphs(
        self,
        graphs: Sequence[MolGraph],
        probabilities: bool = False,
        return_embeddings: bool = False,
    ):
        b = self.spec.num_graphs
        scores: List[torch.Tensor] = []
        embs: List[torch.Tensor] = []
        masks: List[np.ndarray] = []
        for start in range(0, len(graphs), b):
            batch = batch_graphs(list(graphs[start : start + b]), self.spec)
            masks.append(batch.graph_mask.numpy())
            pred, emb = self.model(batch.to(self.device))
            scores.append(pred)
            if return_embeddings:
                embs.append(emb)
        # One device -> host readback.
        mask = np.concatenate(masks) if masks else np.zeros((0,), bool)
        out = (
            torch.cat(scores).cpu().numpy()[mask]
            if scores
            else np.zeros((0,))
        )
        if probabilities:
            out = sigmoid(out)
        if return_embeddings:
            emb_out = (
                torch.cat(embs).cpu().numpy()[mask]
                if embs
                else np.zeros((0, 0))
            )
            return out, emb_out
        return out
