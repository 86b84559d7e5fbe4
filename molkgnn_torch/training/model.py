"""GNNModel: encoder wrapper + prediction head.

Port of ``molkgnn_tpu/training/model.py``: any graph encoder producing a
[B, out_dim] graph embedding, followed by dropout and a single linear FFN to
``task_dim`` logits. The encoder sits under ``gnn_model`` and the head under
``ffn``, the names of the reference checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from molkgnn_torch.graphs.batch import GraphBatch
from molkgnn_torch.models.common import TorchLinear


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
        self.dropout = nn.Dropout(ffn_dropout_rate)
        self.ffn = TorchLinear(
            encoder.graph_embedding_dim, task_dim, generator=generator
        )

    def forward(
        self, batch: GraphBatch
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (prediction [B] for task 0, graph embedding [B, H])."""
        graph_embedding = self.gnn_model(batch)
        prediction = self.ffn(self.dropout(graph_embedding))
        return prediction[..., 0], graph_embedding
