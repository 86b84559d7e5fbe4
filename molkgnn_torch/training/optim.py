"""AdamW with the kernel-parameter no-decay partition, and gradient hygiene.

Port of ``molkgnn_tpu/training/optim.py`` (optax.adamw with a decay mask,
optionally after ``clip_by_global_norm``) on ``torch.optim.AdamW``:

  * Parameters whose name holds ``x_center``, ``p_support``,
    ``edge_attr_support`` or ``x_support`` get no weight decay, except
    ``edge_attr_support_sc_weight``, which decays. Everything else decays.
  * torch's AdamW decays decoupled, ``p *= 1 - lr * wd``, which is optax's
    ``-lr * wd * p`` term; Adam's moments and bias corrections are the same.
  * A parameter that never reaches the loss gets a zero gradient from
    ``jax.grad`` and still decays under optax, while torch leaves its
    ``.grad`` at None and AdamW would skip it: ``fill_missing_grads`` gives
    it zeros.
  * ``clip_by_global_norm`` is optax's formula: unchanged below the norm,
    else ``g / norm * max_norm`` (not ``clip_grad_norm_``'s
    ``max_norm / (norm + 1e-6)``).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch
from torch import nn

NO_DECAY_NAMES = ("x_center", "p_support", "edge_attr_support", "x_support")


def _decays(name: str) -> bool:
    """True if the parameter named ``name`` should be weight-decayed."""
    for part in name.split("."):
        if "edge_attr_support_sc" in part:
            return True
        if any(nd in part for nd in NO_DECAY_NAMES):
            return False
    return True


def decay_partition(model: nn.Module) -> Tuple[List[str], List[str]]:
    """(names that decay, names that do not), in ``named_parameters`` order."""
    names = [n for n, _ in model.named_parameters()]
    return (
        [n for n in names if _decays(n)],
        [n for n in names if not _decays(n)],
    )


def make_optimizer(
    model: nn.Module, weight_decay: float = 0.0
) -> torch.optim.AdamW:
    """AdamW (torch's defaults: betas (0.9, 0.999), eps 1e-8) over two
    parameter groups, decayed first. The learning rate is set per update by
    the caller (``schedule.py``)."""
    params = dict(model.named_parameters())
    decay, no_decay = decay_partition(model)
    return torch.optim.AdamW(
        [
            {"params": [params[n] for n in decay],
             "weight_decay": weight_decay},
            {"params": [params[n] for n in no_decay], "weight_decay": 0.0},
        ],
        lr=0.0,
        betas=(0.9, 0.999),
        eps=1e-8,
    )


def fill_missing_grads(params: Iterable[torch.Tensor]) -> None:
    """Give every parameter without a gradient a zero one."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def grads_finite(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor on the parameters' device: every gradient finite."""
    return torch.stack([torch.isfinite(p.grad).all() for p in params]).all()


def clip_by_global_norm(
    params: Iterable[torch.Tensor], max_norm: float
) -> torch.Tensor:
    """Scale the gradients in place by optax's global-norm rule; returns the
    norm before clipping. Runs on the device with no host readback."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
