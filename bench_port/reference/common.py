"""Plain PyTorch pieces the references of every family share.

A frozen copy of what the training step of ``molkgnn_torch`` does around
its model, written from the equations and imported from nowhere in the
program: the device sampler (an alias table over the train entries and its
draws), the head's dropout masks, the BCE loss, the warm-up and decay of
the learning rate, and AdamW with its no-decay partition. The initial
weights of both sides come from ``make_weights``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# The device sampler's salt (the program folds it into its seed the same
# way, so that its id stream never meets the dropout stream).
SAMPLE_SALT = 0x5A17
# The weights' own stream, apart from the traffic's and the program's.
WEIGHT_SALT = 0x3E16
# Names whose parameters take no weight decay, except
# ``edge_attr_support_sc_weight``, which decays (the reference's AdamW
# partition).
NO_DECAY = ("x_center", "p_support", "edge_attr_support", "x_support")


def sampler_seed(seed: int, salt: int) -> int:
    """The device sampler's generator seed on one device."""
    return int(np.random.SeedSequence([seed, salt]).generate_state(
        1, np.uint64)[0])


def alias_table(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(prob float32 [n], alias int32 [n]): Walker's alias table of the
    unnormalised ``weights``, by Vose's algorithm in float64."""
    w = np.asarray(weights, np.float64)
    n = w.size
    p = w / w.sum() * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, big = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = big
        p[big] = (p[big] + p[s]) - 1.0
        (small if p[big] < 1.0 else large).append(big)
    return prob, alias


def oversampling_weights(labels: np.ndarray) -> np.ndarray:
    """Inverse class counts: each class drawn as often as the other."""
    n_active = int((labels == 1).sum())
    n_inactive = int(labels.shape[0]) - n_active
    return np.where(labels == 1, 1.0 / max(n_active, 1),
                    1.0 / max(n_inactive, 1))


class IdSampler:
    """Batches of train entry ids drawn with replacement in proportion to
    ``oversampling_weights``: position i ~ U{0..n-1} and u ~ U[0, 1) from a
    generator on ``device``; i is kept if u < prob[i], else alias[i]."""

    def __init__(self, seed: int, train_ids: np.ndarray,
                 train_labels: np.ndarray, device):
        prob, alias = alias_table(oversampling_weights(train_labels))
        self.prob = torch.from_numpy(prob).to(device)
        self.alias = torch.from_numpy(alias).to(device).long()
        self.train_ids = torch.from_numpy(
            np.asarray(train_ids, np.int64)).to(device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(sampler_seed(seed, SAMPLE_SALT))

    def draw(self, batch_size: int) -> torch.Tensor:
        n = self.prob.shape[0]
        dev = self.prob.device
        i = torch.randint(0, n, (batch_size,), generator=self.gen,
                          device=dev)
        u = torch.rand((batch_size,), generator=self.gen, device=dev,
                       dtype=torch.float32)
        return self.train_ids[torch.where(u < self.prob[i], i,
                                          self.alias[i])]


def dropout_keep(gen: torch.Generator, shape, rate: float, dtype,
                 device) -> torch.Tensor:
    """The inverted-dropout factor (mask / keep) of one draw from ``gen``
    (Bernoulli(1 - rate) elements)."""
    keep = 1.0 - rate
    mask = torch.empty(shape, dtype=dtype, device=device).bernoulli_(
        keep, generator=gen)
    return mask / keep


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits (the stable form)."""
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return per.mean()


def learning_rate(count: int, peak: float, end: float, warmup: int,
                  total: int) -> float:
    """The polynomial (power 1) warm-up and decay at update ``count + 1``."""
    step = count + 1
    if step <= warmup:
        return peak * step / max(warmup, 1)
    if step >= total:
        return end
    remaining = 1.0 - (step - warmup) / max(total - warmup, 1)
    return (peak - end) * remaining + end


def decays(name: str) -> bool:
    """Whether the parameter ``name`` takes weight decay."""
    for part in name.split("."):
        if "edge_attr_support_sc" in part:
            return True
        if any(nd in part for nd in NO_DECAY):
            return False
    return True


class AdamW:
    """AdamW (betas 0.9, 0.999, eps 1e-8, decoupled decay ``p *= 1 - lr *
    wd``) over a dict of leaves; a leaf without a gradient takes a zero
    one."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.wd = {n: (weight_decay if decays(n) else 0.0) for n in params}
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        t = self.count + 1
        bc1 = 1.0 - self.b1 ** t
        bc2 = math.sqrt(1.0 - self.b2 ** t)
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = m / (v.sqrt() / bc2 + self.eps) * (lr / bc1)
            if self.wd[n]:
                p.mul_(1.0 - lr * self.wd[n])
            p.sub_(update)
        self.count += 1


def make_weights(specs: Sequence[Tuple[str, tuple, tuple]], seed: int,
                 device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The initial weights of ``specs`` [(name, shape, init)], from
    ``seed``, on ``device``, in two draws: one normal, one uniform.

    ``init`` is ``("normal", std)``, ``("uniform", bound)`` (U(-bound,
    bound)), ``("const", value)``, or ``("normal_rows", std)``: N(0, std^2)
    drawn once for each index of axes 0 and 2.. and repeated along axis 1.
    """
    def drawn(shape, kind):
        if kind == "normal_rows":
            return math.prod(shape) // shape[1]
        return math.prod(shape)

    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in specs:
        if init[0] == "normal_rows":
            sizes["normal"] += drawn(shape, "normal_rows")
        elif init[0] in sizes:
            sizes[init[0]] += drawn(shape, init[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(sampler_seed(seed, WEIGHT_SALT))
    pools = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device,
                              dtype=dtype),
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device,
                              dtype=dtype) * 2 - 1,
    }
    used = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, (kind, scale) in specs:
        if kind == "const":
            out[name] = torch.full(shape, float(scale), device=device,
                                   dtype=dtype)
            continue
        pool = "normal" if kind == "normal_rows" else kind
        n = drawn(shape, kind)
        flat = pools[pool][used[pool]:used[pool] + n] * scale
        used[pool] += n
        if kind == "normal_rows":
            rows = flat.reshape(shape[0], 1, *shape[2:])
            out[name] = rows.expand(shape).clone()
        else:
            out[name] = flat.reshape(shape).clone()
    return out


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = x @ w.T
    return y if b is None else y + b


def concat_offsets(counts: List[int]) -> np.ndarray:
    """Exclusive prefix sums of ``counts`` (int64)."""
    c = np.asarray(counts, np.int64)
    return np.cumsum(c) - c
