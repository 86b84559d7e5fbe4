"""Polynomial warmup-decay learning-rate schedule.

Port of ``molkgnn_tpu/training/schedule.py`` (Graphormer's
PolynomialDecayLR, stepped per optimizer update). The schedule is called
with the 0-based count of updates already applied and evaluates the
1-indexed torch formula at ``count + 1``: the first update runs at
``lr(step=1)``. The ``Trainer`` sets each parameter group's ``lr`` to
``schedule(count)`` right before every update, so no ``LambdaLR`` (which
would be one step off) is involved.

``polynomial_warmup_decay_tensor`` is the same schedule on a 0-dim count
tensor, evaluated on the count's device in float64 with the same operations
in the same order (so bit-equal to the float form): the train step reads
its learning rate without a host scalar, as a captured CUDA graph needs.
"""

from __future__ import annotations

from typing import Callable

import torch


def polynomial_warmup_decay(
    peak_lr: float,
    end_lr: float,
    warmup_iterations: int,
    tot_iterations: int,
    power: float = 1.0,
) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        step = count + 1
        if step <= warmup_iterations:
            return peak_lr * step / max(warmup_iterations, 1)
        if step >= tot_iterations:
            return end_lr
        pct_remaining = 1.0 - (step - warmup_iterations) / max(
            tot_iterations - warmup_iterations, 1
        )
        return (peak_lr - end_lr) * pct_remaining**power + end_lr

    return schedule


def polynomial_warmup_decay_tensor(
    peak_lr: float,
    end_lr: float,
    warmup_iterations: int,
    tot_iterations: int,
    power: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    warm_div = max(warmup_iterations, 1)
    span = max(tot_iterations - warmup_iterations, 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        step = count.to(torch.float64) + 1
        warm = peak_lr * step / warm_div
        pct_remaining = 1.0 - (step - warmup_iterations) / span
        decay = (peak_lr - end_lr) * pct_remaining**power + end_lr
        return torch.where(
            step <= warmup_iterations,
            warm,
            torch.where(step >= tot_iterations, end_lr, decay),
        )

    return schedule
