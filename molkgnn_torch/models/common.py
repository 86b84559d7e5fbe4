"""Shared model building blocks."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (PyG's ``swish``/SiLU)."""
    return x * torch.sigmoid(x)


class TorchLinear(nn.Module):
    """Dense layer with PyTorch ``nn.Linear`` default initialization, drawn
    from an explicit ``generator``.

    weight [out, in] and bias [out] ~ U(-1/sqrt(in), 1/sqrt(in)), the
    distribution of ``nn.Linear``'s kaiming_uniform(a=sqrt(5)) init.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(
                -bound, bound, generator=generator
            )
        )
        self.bias = nn.Parameter(
            torch.empty(out_features).uniform_(
                -bound, bound, generator=generator
            )
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
