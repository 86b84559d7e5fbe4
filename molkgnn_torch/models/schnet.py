"""SchNet baseline.

Port of ``molkgnn_tpu/models/schnet.py``: an atomic-number embedding, a
Gaussian basis of radius-graph distances, per layer a filter MLP gated by a
cosine cutoff (update_e), a scatter-sum and residual MLP (update_v), and an
MLP and graph sum as readout (update_u), with shifted-softplus activations.
Padded edges take the cutoff distance, where the gate vanishes, and are
masked in the scatter as well.

The modules carry the reference checkpoint's names (``init_v``,
``update_es.{l}.mlp.{0,2}``, ``update_es.{l}.lin``, ``update_vs.{l}.lin1/2``,
``update_u.lin1/2``). Init: xavier-uniform weights and zero biases, the
embedding N(0, 1), all drawn from ``generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from molkgnn_torch.graphs.geometric import PointBatch
from molkgnn_torch.models.common import Linear
from molkgnn_torch.ops.segment import (
    global_add_pool,
    segment_sum_nodes,
    take_rows,
)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) - log 2 (``logaddexp``, as ``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def xavier_linear(in_features, out_features, generator=None, bias=True):
    """A ``Linear`` with xavier-uniform weight and zero bias."""
    a = math.sqrt(6.0 / (in_features + out_features))
    w = torch.empty(out_features, in_features).uniform_(
        -a, a, generator=generator)
    return Linear(w, bias)


class ShiftedSoftplus(nn.Module):
    def forward(self, x):
        return shifted_softplus(x)


class Embedding(nn.Module):
    """A lookup table ``weight`` [num, dim]."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return take_rows(self.weight, torch.clamp(z, 0,
                                                  self.weight.shape[0] - 1))


class GaussianSmearing(nn.Module):
    """``num_gaussians`` Gaussians of distance, centred on a uniform grid
    over [start, stop]. The centres are ``np.linspace``'s float64 values
    (k * step + start, the last one stop), made on the distances' device
    and rounded to their dtype: a constant, not a weight, so not in the
    state_dict (the importers skip the reference's ``offset`` buffer)."""

    def __init__(self, start=0.0, stop=5.0, num_gaussians=50):
        super().__init__()
        self.start, self.stop, self.num = start, stop, num_gaussians
        self.step = (stop - start) / (num_gaussians - 1)
        self.coeff = -0.5 / float(np.linspace(start, stop, num_gaussians)[1]
                                  - start) ** 2

    def forward(self, dist):
        k = torch.arange(self.num, dtype=torch.float64, device=dist.device)
        offset = torch.where(k == self.num - 1, self.stop,
                             k * self.step + self.start).to(dist.dtype)
        return torch.exp(self.coeff * (dist[:, None] - offset[None, :]) ** 2)


class _UpdateE(nn.Module):
    def __init__(self, hidden, filters, gaussians, gen):
        super().__init__()
        self.mlp = nn.Sequential(
            xavier_linear(gaussians, filters, gen), ShiftedSoftplus(),
            xavier_linear(filters, filters, gen))
        self.lin = xavier_linear(hidden, filters, gen, bias=False)


class _MLP2(nn.Module):
    """lin2(ssp(lin1(x)))."""

    def __init__(self, dims, gen):
        super().__init__()
        self.lin1 = xavier_linear(dims[0], dims[1], gen)
        self.lin2 = xavier_linear(dims[1], dims[2], gen)

    def forward(self, x):
        return self.lin2(shifted_softplus(self.lin1(x)))


class SchNet(nn.Module):
    def __init__(
        self,
        cutoff: float = 10.0,
        num_layers: int = 6,
        hidden_channels: int = 128,
        num_filters: int = 128,
        num_gaussians: int = 50,
        out_channels: int = 32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.cutoff = cutoff
        self.out_channels = out_channels
        gen = generator
        self.dist_emb = GaussianSmearing(0.0, cutoff, num_gaussians)
        self.init_v = Embedding(
            torch.empty(100, hidden_channels).normal_(generator=gen))
        self.update_es = nn.ModuleList(
            _UpdateE(hidden_channels, num_filters, num_gaussians, gen)
            for _ in range(num_layers))
        self.update_vs = nn.ModuleList(
            _MLP2((num_filters, hidden_channels, hidden_channels), gen)
            for _ in range(num_layers))
        self.update_u = _MLP2(
            (hidden_channels, hidden_channels // 2, out_channels), gen)

    def forward(self, batch: PointBatch) -> torch.Tensor:
        j, i = batch.edge_src, batch.edge_dst
        dist = torch.linalg.norm(
            take_rows(batch.pos, j) - take_rows(batch.pos, i), dim=-1)
        dist = torch.where(batch.edge_mask, dist, self.cutoff)
        dist_emb = self.dist_emb(dist)
        gate = 0.5 * (torch.cos(dist * math.pi / self.cutoff) + 1.0)
        v = self.init_v(batch.z)
        for upd_e, upd_v in zip(self.update_es, self.update_vs):
            w = upd_e.mlp(dist_emb) * gate[:, None]
            e = take_rows(upd_e.lin(v), j) * w
            agg = segment_sum_nodes(e, i, batch.num_nodes,
                                    mask=batch.edge_mask)
            v = v + upd_v(agg)
        return global_add_pool(self.update_u(v), batch.node_graph_id,
                               batch.num_graphs, node_mask=batch.node_mask)
