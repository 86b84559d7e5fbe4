"""DimeNet++ baseline.

Port of ``molkgnn_tpu/models/dimenetpp.py``: messages live on the directed
edges of the radius graph; a Bessel radial basis of edge lengths and a
spherical basis of the k -> j -> i triplet angles (``ops/basis.py``) feed
InteractionPPBlocks (rbf/sbf projections, a triplet scatter, residual
layers); every block's OutputPPBlock adds a per-node contribution, summed
per graph. The angle is atan2(|cross|, dot).

The modules carry the reference checkpoint's names (``rbf.freq``,
``emb.{emb,lin_rbf,lin}``, ``output_blocks.{b}``, ``interaction_blocks.{b}``,
``layers_before_skip``/``layers_after_skip``, ``lins.{k}``). Init:
glorot-orthogonal (scale 2) in the interaction blocks, torch's Linear
default in the embedding and output blocks (the reference never resets
them), the embedding uniform(-sqrt 3, sqrt 3); all drawn from
``generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from molkgnn_torch.graphs.geometric import PointBatch
from molkgnn_torch.models.common import Linear, TorchLinear, swish
from molkgnn_torch.models.schnet import Embedding
from molkgnn_torch.ops.basis import bessel_rbf, spherical_sbf
from molkgnn_torch.ops.segment import (
    global_add_pool,
    segment_sum_nodes,
    take_rows,
)


def glorot_linear(in_features, out_features, generator=None, bias=True,
                  scale=2.0):
    """A ``Linear`` with a glorot-orthogonal weight: an orthogonal matrix
    rescaled to the variance scale * 2 / (in + out), and zero bias."""
    rows, cols = in_features, out_features  # the JAX kernel's [in, out]
    a = torch.empty(max(rows, cols), min(rows, cols)).normal_(
        generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    w = q if rows >= cols else q.T
    target = scale * 2.0 / (in_features + out_features)
    w = w * math.sqrt(target / max(float(torch.var(w, correction=0)), 1e-12))
    return Linear(w.T.contiguous(), bias)


def uniform_embedding(num, dim, generator=None):
    s = math.sqrt(3)
    return Embedding(torch.empty(num, dim).uniform_(-s, s,
                                                    generator=generator))


class ResidualLayer(nn.Module):
    def __init__(self, hidden, gen):
        super().__init__()
        self.lin1 = glorot_linear(hidden, hidden, gen)
        self.lin2 = glorot_linear(hidden, hidden, gen)

    def forward(self, x):
        return x + swish(self.lin2(swish(self.lin1(x))))


def residual_stack(n, hidden, gen):
    return nn.ModuleList(ResidualLayer(hidden, gen) for _ in range(n))


class InteractionPPBlock(nn.Module):
    def __init__(self, hidden, int_emb, basis_emb, num_spherical,
                 num_radial, before_skip, after_skip, gen):
        super().__init__()
        g = lambda i, o, bias=True: glorot_linear(i, o, gen, bias)
        self.lin_rbf1 = g(num_radial, basis_emb, False)
        self.lin_rbf2 = g(basis_emb, hidden, False)
        self.lin_sbf1 = g(num_spherical * num_radial, basis_emb, False)
        self.lin_sbf2 = g(basis_emb, int_emb, False)
        self.lin_kj = g(hidden, hidden)
        self.lin_ji = g(hidden, hidden)
        self.lin_down = g(hidden, int_emb, False)
        self.lin_up = g(int_emb, hidden, False)
        self.layers_before_skip = residual_stack(before_skip, hidden, gen)
        self.lin = g(hidden, hidden)
        self.layers_after_skip = residual_stack(after_skip, hidden, gen)

    def forward(self, x, rbf, sbf, idx_kj, idx_ji, tri_mask):
        x_ji = swish(self.lin_ji(x))
        x_kj = swish(self.lin_kj(x))
        x_kj = x_kj * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = swish(self.lin_down(x_kj))
        t = take_rows(x_kj, idx_kj) * self.lin_sbf2(self.lin_sbf1(sbf))
        x_kj = segment_sum_nodes(t, idx_ji, x.shape[0], mask=tri_mask)
        x_kj = swish(self.lin_up(x_kj))
        out = x_ji + x_kj
        for layer in self.layers_before_skip:
            out = layer(out)
        out = swish(self.lin(out)) + x
        for layer in self.layers_after_skip:
            out = layer(out)
        return out


class OutputPPBlock(nn.Module):
    def __init__(self, num_radial, hidden, out_emb, out_channels,
                 num_layers, gen):
        super().__init__()
        self.lin_rbf = TorchLinear(num_radial, hidden, gen, bias=False)
        self.lin_up = TorchLinear(hidden, out_emb, gen)
        self.lins = nn.ModuleList(
            TorchLinear(out_emb, out_emb, gen) for _ in range(num_layers))
        self.lin = TorchLinear(out_emb, out_channels, gen, bias=False)

    def forward(self, x, rbf, i, num_nodes, edge_mask):
        x = self.lin_rbf(rbf) * x
        x = segment_sum_nodes(x, i, num_nodes, mask=edge_mask)
        x = self.lin_up(x)
        for lin in self.lins:
            x = swish(lin(x))
        return self.lin(x)


class BesselBasis(nn.Module):
    """The learnable frequencies of the radial basis (init n pi)."""

    def __init__(self, num_radial):
        super().__init__()
        self.freq = nn.Parameter(
            torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)


class EmbeddingBlock(nn.Module):
    def __init__(self, num_radial, hidden, gen):
        super().__init__()
        self.emb = uniform_embedding(95, hidden, gen)
        self.lin_rbf = TorchLinear(num_radial, hidden, gen)
        self.lin = TorchLinear(3 * hidden, hidden, gen)

    def forward(self, z, rbf, i, j):
        """Edge messages from cat(x_i, x_j, rbf): the target's embedding
        first."""
        xz = self.emb(z)
        rbf_h = swish(self.lin_rbf(rbf))
        return swish(self.lin(torch.cat(
            [take_rows(xz, i), take_rows(xz, j), rbf_h], dim=-1)))


def triplet_nodes(batch: PointBatch):
    """(j, i, k) node ids of each triplet k -> j -> i."""
    t_j = take_rows(batch.edge_src, batch.tri_edge_ji)
    t_i = take_rows(batch.edge_dst, batch.tri_edge_ji)
    return t_j, t_i, batch.tri_k


def triplet_angles(batch: PointBatch):
    """The angle of each triplet, atan2(|cross|, dot) of pos_j - pos_i and
    pos_k - pos_j (DimeNet++'s vectors); 0 on padded triplets."""
    t_j, t_i, t_k = triplet_nodes(batch)
    p_j = take_rows(batch.pos, t_j)
    pos_ji = p_j - take_rows(batch.pos, t_i)
    pos_kj = take_rows(batch.pos, t_k) - p_j
    a = torch.sum(pos_ji * pos_kj, dim=-1)
    b = torch.linalg.norm(torch.linalg.cross(pos_ji, pos_kj, dim=-1), dim=-1)
    return torch.where(batch.tri_mask, torch.atan2(b, a), 0.0)


def edge_lengths(batch: PointBatch, cutoff: float):
    """|pos_i - pos_j| per edge, the cutoff on padded edges."""
    d = torch.linalg.norm(take_rows(batch.pos, batch.edge_dst)
                          - take_rows(batch.pos, batch.edge_src), dim=-1)
    return torch.where(batch.edge_mask, d, cutoff)


class DimeNetPP(nn.Module):
    def __init__(
        self,
        hidden_channels: int = 128,
        out_channels: int = 32,
        num_blocks: int = 4,
        int_emb_size: int = 64,
        basis_emb_size: int = 8,
        out_emb_channels: int = 256,
        num_spherical: int = 7,
        num_radial: int = 6,
        cutoff: float = 5.0,
        envelope_exponent: int = 5,
        num_before_skip: int = 1,
        num_after_skip: int = 2,
        num_output_layers: int = 3,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = generator
        self.out_channels = out_channels
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.cutoff, self.envelope_exponent = cutoff, envelope_exponent
        self.rbf = BesselBasis(num_radial)
        self.emb = EmbeddingBlock(num_radial, hidden_channels, gen)
        self.output_blocks = nn.ModuleList(
            OutputPPBlock(num_radial, hidden_channels, out_emb_channels,
                          out_channels, num_output_layers, gen)
            for _ in range(num_blocks + 1))
        self.interaction_blocks = nn.ModuleList(
            InteractionPPBlock(hidden_channels, int_emb_size, basis_emb_size,
                               num_spherical, num_radial, num_before_skip,
                               num_after_skip, gen)
            for _ in range(num_blocks))

    def forward(self, batch: PointBatch) -> torch.Tensor:
        j, i = batch.edge_src, batch.edge_dst
        dist = edge_lengths(batch, self.cutoff)
        angle = triplet_angles(batch)
        idx_kj, idx_ji = batch.tri_edge_kj, batch.tri_edge_ji
        rbf = bessel_rbf(dist, self.rbf.freq, self.cutoff,
                         self.envelope_exponent)
        sbf = spherical_sbf(
            torch.where(batch.tri_mask, take_rows(dist, idx_kj), self.cutoff),
            angle, self.num_spherical, self.num_radial, self.cutoff,
            self.envelope_exponent)
        x = self.emb(batch.z, rbf, i, j)
        n = batch.num_nodes
        out = self.output_blocks[0](x, rbf, i, n, batch.edge_mask)
        for inter, output in zip(self.interaction_blocks,
                                 self.output_blocks[1:]):
            x = inter(x, rbf, sbf, idx_kj, idx_ji, batch.tri_mask)
            out = out + output(x, rbf, i, n, batch.edge_mask)
        return global_add_pool(out, batch.node_graph_id, batch.num_graphs,
                               node_mask=batch.node_mask)
