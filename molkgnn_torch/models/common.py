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
    distribution of ``nn.Linear``'s kaiming_uniform(a=sqrt(5)) init;
    ``bias=False`` leaves the bias out.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        generator: torch.Generator | None = None,
        bias: bool = True,
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
        ) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """Inverted dropout whose mask draws from an explicit generator.

    ``nn.Dropout`` draws from the global RNG; here the owner of the run (the
    ``Trainer``) sets ``generator``, seeded from its config, so a run's
    masks depend on its seed alone. In train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; in eval mode,
    or at rate 0, the input passes unchanged. The module holds no state.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout in train mode needs its generator set (the Trainer "
                "sets it)"
            )
        keep = 1.0 - self.rate
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class Linear(nn.Module):
    """Dense layer ``x W^T + b`` from a given initial weight [out, in], with
    a zero bias (or none): the layers whose init is not torch's default."""

    def __init__(self, weight: torch.Tensor, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = (nn.Parameter(torch.zeros(weight.shape[0])) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
