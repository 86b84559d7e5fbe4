"""GNNModel (encoder wrapper + prediction head) and the training losses.

Port of ``molkgnn_tpu/training/model.py``: any graph encoder producing a
[B, out_dim] graph embedding (out_dim from the family's ``out_dim_field``,
``models/registry.py``), followed by dropout and a single linear FFN to
``task_dim`` logits. The encoder sits under ``gnn_model`` and the head under
``ffn``, the names of the reference checkpoint. The losses take
(prediction, labels, graph mask) and count real graphs only.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from molkgnn_torch.models.common import Dropout, TorchLinear
from molkgnn_torch.models.registry import embedding_width


class GNNModel(nn.Module):
    def __init__(
        self,
        encoder: nn.Module,
        task_dim: int = 1,
        ffn_dropout_rate: float = 0.25,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.gnn_model = encoder
        self.dropout = Dropout(ffn_dropout_rate)
        self.ffn = TorchLinear(
            embedding_width(encoder), task_dim, generator=generator
        )

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """(prediction [B] for task 0, graph embedding [B, H]) of a batch of
        the encoder's family (``GraphBatch``, ``PointBatch``)."""
        graph_embedding = self.gnn_model(batch)
        prediction = self.ffn(self.dropout(graph_embedding))
        return prediction[..., 0], graph_embedding


def bce_with_logits_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean BCEWithLogitsLoss over real graphs, in the stable form
    max(x, 0) - x*y + log1p(exp(-|x|))."""
    per = (
        torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    m = mask.to(per.dtype)
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def mse_sum_loss(
    pred: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """MSELoss(reduction='sum') over real graphs (the D4DCHP regression)."""
    m = mask.to(pred.dtype)
    return torch.sum(((pred - labels) ** 2) * m)


LOSSES: Dict[str, Callable] = {
    "bce_with_logits": bce_with_logits_loss,
    "mse_sum": mse_sum_loss,
}
