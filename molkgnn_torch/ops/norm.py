"""Masked batch normalization with PyTorch ``BatchNorm1d`` semantics.

Port of ``molkgnn_tpu/ops/norm.py``. Batches carry padded rows, so the
statistics are computed over real rows only; with a full mask this reduces
exactly to ``BatchNorm1d``:

  * train: normalize with the biased batch variance; update the running
    stats with the *unbiased* variance, momentum 0.1
    (new = (1-m)*old + m*batch).
  * eval:  normalize with the running stats.
  * eps = 1e-5, learnable affine (weight init 1, bias init 0).
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    eps = 1e-5
    momentum = 0.1

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                # A fill on the device: no host-to-device copy, so the
                # branch can be captured in a CUDA graph.
                count = x.new_full((), float(x.shape[0]))
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                m = mask.to(x.dtype)[:, None]
                count = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(dim=0) / count
                var = (((x - mean) ** 2) * m).sum(dim=0) / count
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean
                )
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased
                )

        inv_std = torch.reciprocal(torch.sqrt(var + self.eps))
        y = (x - mean) * inv_std * self.weight + self.bias
        if mask is not None:
            y = torch.where(mask[:, None], y, 0.0)
        return y
