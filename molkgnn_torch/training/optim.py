"""AdamW with the kernel-parameter no-decay partition, and gradient hygiene.

Port of ``molkgnn_tpu/training/optim.py`` (optax.adamw with a decay mask,
optionally after ``clip_by_global_norm``):

  * Parameters whose name holds ``x_center``, ``p_support``,
    ``edge_attr_support`` or ``x_support`` get no weight decay, except
    ``edge_attr_support_sc_weight``, which decays. Everything else decays.
  * ``AdamW`` is torch's AdamW (decoupled decay ``p *= 1 - lr * wd``, which
    is optax's ``-lr * wd * p`` term; the same moments and bias
    corrections) with its whole state on the parameters' device: the
    moments, the count of updates applied and, per update, the learning
    rate and an optional "apply" flag are tensors there. A step reads
    nothing back to the host, so it can be captured in a CUDA graph.
  * A parameter that never reaches the loss gets a zero gradient from
    ``jax.grad`` and still decays under optax, while torch leaves its
    ``.grad`` at None: ``fill_missing_grads`` gives it zeros. After the
    first step every ``.grad`` exists and ``AdamW.zero_grad`` zeroes them
    in place, so their storage stays put from step to step.
  * ``clip_by_global_norm`` is optax's formula: unchanged below the norm,
    else ``g / norm * max_norm`` (not ``clip_grad_norm_``'s
    ``max_norm / (norm + 1e-6)``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

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


class AdamW:
    """AdamW over parameter groups ``[(params, weight_decay)]`` with its
    state on the parameters' device (see the module doc).

    ``step(lr, apply)`` applies one update from the parameters' ``.grad``:
    ``lr`` is a 0-dim float64 tensor; ``apply`` (a 0-dim bool tensor, or
    None for always) leaves parameters, moments and ``count`` exactly as
    they were when false. ``count`` (0-dim int64) is Adam's step count and
    the schedule's position.
    """

    def __init__(
        self,
        groups: List[Tuple[List[nn.Parameter], float]],
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
    ):
        self.groups = [(list(ps), float(wd)) for ps, wd in groups if ps]
        self.params = [p for ps, _ in self.groups for p in ps]
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def zero_grad(self) -> None:
        """Zero every existing gradient in place."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    @torch.no_grad()
    def step(self, lr: torch.Tensor, apply: Optional[torch.Tensor] = None):
        t = (self.count + 1).to(torch.float64)
        bc1 = 1.0 - torch.pow(self.beta1, t)
        bc2_sqrt = torch.sqrt(1.0 - torch.pow(self.beta2, t))
        start = 0
        for params, wd in self.groups:
            n = len(params)
            m = self.exp_avg[start:start + n]
            v = self.exp_avg_sq[start:start + n]
            start += n
            dtype = params[0].dtype
            grads = [p.grad for p in params]
            decay = (1.0 - lr * wd).to(dtype) if wd else 1.0
            # In place when every update applies; else into new tensors
            # that are selected against the old ones at the end.
            if apply is None:
                torch._foreach_lerp_(m, grads, 1.0 - self.beta1)
                torch._foreach_mul_(v, self.beta2)
                m_new, v_new = m, v
            else:
                m_new = torch._foreach_lerp(m, grads, 1.0 - self.beta1)
                v_new = torch._foreach_mul(v, self.beta2)
            torch._foreach_addcmul_(v_new, grads, grads, value=1.0 - self.beta2)
            denom = torch._foreach_sqrt(v_new)
            torch._foreach_div_(denom, bc2_sqrt.to(dtype))
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m_new, denom)
            torch._foreach_mul_(upd, (lr / bc1).to(dtype))
            if apply is None:
                if wd:
                    torch._foreach_mul_(params, decay)
                torch._foreach_sub_(params, upd)
                continue
            p_new = torch._foreach_mul(params, decay)
            torch._foreach_sub_(p_new, upd)
            for old, new in ((params, p_new), (m, m_new), (v, v_new)):
                torch._foreach_copy_(
                    old, [torch.where(apply, b, a) for a, b in zip(old, new)]
                )
        self.count += 1 if apply is None else apply.to(torch.int64)

    def state_dict(self) -> Dict[str, object]:
        return {
            "exp_avg": [t.detach().clone() for t in self.exp_avg],
            "exp_avg_sq": [t.detach().clone() for t in self.exp_avg_sq],
            "count": self.count.detach().clone(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a ``state_dict`` in place (the tensors keep their storage,
        so a captured step stays valid)."""
        for mine, theirs in ((self.exp_avg, state["exp_avg"]),
                             (self.exp_avg_sq, state["exp_avg_sq"])):
            if len(mine) != len(theirs):
                raise ValueError("optimizer state of another model")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count.copy_(state["count"])


def make_optimizer(model: nn.Module, weight_decay: float = 0.0) -> AdamW:
    """AdamW (torch's defaults: betas (0.9, 0.999), eps 1e-8) over two
    parameter groups, decayed first. The learning rate is given per update
    by the caller (``schedule.py``)."""
    params = dict(model.named_parameters())
    decay, no_decay = decay_partition(model)
    return AdamW([
        ([params[n] for n in decay], weight_decay),
        ([params[n] for n in no_decay], 0.0),
    ])


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
