"""ChIRoNet baseline.

Port of ``molkgnn_tpu/models/chironet.py``. The graph node embedder is an
edge-conditioned convolution (PyG NNConv: add aggregation, root weight)
followed by GAT layers (PyG GATConv: self-loops, mean over heads); the
internal-coordinate encoder encodes bond lengths (Encoder_D), bond angles
(Encoder_phi, on their cosine and sine) and torsions, whose learned
phase shifts (Encoder_sinusoidal_shift) and coefficients c (Encoder_c,
sigmoid- or softmax-normalised per central bond) are pooled per local
structure into the radii that Encoder_alpha reads. Optional chiral message
passing feeds the alpha encodings back into the node graph (an NNConv over
the central bonds, then GAT layers). The output is the pooled node
embedding (``output_mode="molecule"``, the reference's main path), the
encoder's latent (``"conformer"``), or both concatenated (``"both"``).

The modules carry the reference checkpoint's names under ``encoder``
(``Graph_Embedder.EConv.nn.linear_layers.{k}``, ``EConv.lin`` the root
weight, ``EConv.bias``, ``Graph_Embedder.GAT_layers.{g}.{lin, att_src,
att_dst, bias}``, ``InternalCoordinateEncoder.Encoder_*.linear_layers.{k}``,
``ChiralMessagePassingEncoder.{ChiralEConv, ChiralGATLayers.{g}}``). Init:
torch ``nn.Linear``'s for the MLPs, glorot-uniform for the root, GAT and
attention weights, zero biases, all drawn from ``generator``.

Where nothing reads the internal-coordinate encoder (``"molecule"`` without
chiral message passing) its forward is skipped: its output reaches nothing,
as under the JAX package's ``jit``. Its parameters stay (the checkpoint
holds them); they get no gradient, and the optimizer's
``fill_missing_grads`` gives them the zero that ``jax.grad`` gives.

The softmaxes (GAT attention over each node's in-edges and self-loop, and
softmax c over each central bond's dihedrals) subtract a segment maximum
for range; the maximum cancels from the softmax, so it is held constant
(detached) in the backward. Padded rows are masked with ``torch.where``
on both sides of the ``exp``, so no masked ``exp`` can overflow into a
gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from molkgnn_torch.graphs.chiro import ChiroBatch
from molkgnn_torch.models.common import Dropout, Linear, TorchLinear
from molkgnn_torch.ops.segment import (
    global_add_pool,
    segment_max,
    segment_sum_nodes,
    take_rows,
)

OUTPUT_MODES = ("molecule", "conformer", "both")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def glorot(shape: Tuple[int, ...], fan_in: int, fan_out: int,
           generator=None) -> torch.Tensor:
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-a, a, generator=generator)


class MLP(nn.Module):
    """The reference MLP: LeakyReLU(0.01) after each hidden layer, dropout
    after each hidden layer but the first, identity output."""

    def __init__(self, in_size: int, out_size: int,
                 hidden: Sequence[int], dropout: float = 0.0,
                 generator=None):
        super().__init__()
        sizes = [in_size, *hidden, out_size]
        self.linear_layers = nn.ModuleList(
            TorchLinear(a, b, generator=generator)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.linear_layers
        for k, lin in enumerate(hidden):
            x = leaky_relu(lin(x))
            if k > 0:
                x = self.dropout(x)
        return last(x)


class NNConv(nn.Module):
    """PyG NNConv (aggr='add', root_weight=True): h'_i = W x_i + b +
    sum_{(j->i)} x_j Theta(e_ji), Theta an MLP to [F_in, F_out]."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int,
                 mlp_hidden: Sequence[int], dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.nn = MLP(edge_dim, in_channels * out_channels, mlp_hidden,
                      dropout, generator)
        self.lin = Linear(glorot((out_channels, in_channels), in_channels,
                                 out_channels, generator), bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_mask):
        theta = self.nn(edge_attr).view(-1, self.in_channels,
                                        self.out_channels)
        msgs = torch.bmm(take_rows(x, edge_src)[:, None, :], theta)[:, 0]
        agg = segment_sum_nodes(msgs, edge_dst, x.shape[0], mask=edge_mask)
        return agg + self.lin(x) + self.bias


class GATConv(nn.Module):
    """PyG GATConv with add_self_loops=True, concat=False (head mean): a
    masked segment softmax over each node's in-edges and an analytic
    self-loop term, LeakyReLU(0.2) attention logits."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 dropout: float = 0.0, generator=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        hc = heads * out_channels
        self.lin = Linear(glorot((hc, in_channels), in_channels, hc,
                                 generator), bias=False)
        self.att_src = nn.Parameter(glorot((1, heads, out_channels), heads,
                                           out_channels, generator))
        self.att_dst = nn.Parameter(glorot((1, heads, out_channels), heads,
                                           out_channels, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.dropout = Dropout(dropout)

    def forward(self, x, edge_src, edge_dst, edge_mask):
        n, H, C = x.shape[0], self.heads, self.out_channels
        xh = self.lin(x).view(n, H, C)
        a_src = (xh * self.att_src).sum(-1)  # [N, H]
        a_dst = (xh * self.att_dst).sum(-1)
        e_logit = F.leaky_relu(take_rows(a_src, edge_src)
                               + take_rows(a_dst, edge_dst), 0.2)  # [E, H]
        s_logit = F.leaky_relu(a_src + a_dst, 0.2)  # [N, H]

        # Softmax over {in-edges} U {self}; an empty segment's -inf max
        # takes the self-loop logit. Padded edges point at node 0, whose
        # max is at least their own logit.
        m = edge_mask[:, None]
        with torch.no_grad():
            seg_max = torch.maximum(
                segment_max(torch.where(m, e_logit, float("-inf")),
                            edge_dst, n), s_logit)
        shifted = e_logit - take_rows(seg_max, edge_dst)
        e_exp = torch.where(m, torch.exp(torch.where(m, shifted, 0.0)), 0.0)
        s_exp = torch.exp(s_logit - seg_max)
        denom = segment_sum_nodes(e_exp, edge_dst, n) + s_exp
        alpha_e = e_exp / torch.clamp(take_rows(denom, edge_dst), min=1e-16)
        alpha_s = s_exp / torch.clamp(denom, min=1e-16)
        alpha_e, alpha_s = self.dropout(alpha_e), self.dropout(alpha_s)

        msgs = take_rows(xh, edge_src) * alpha_e[:, :, None]  # [E, H, C]
        out = segment_sum_nodes(msgs.reshape(-1, H * C), edge_dst, n,
                                mask=edge_mask).view(n, H, C)
        out = out + xh * alpha_s[:, :, None]
        return out.mean(dim=1) + self.bias


class InternalCoordinateEncoder(nn.Module):
    """Bond lengths, bond angles and torsions -> (latent [B, sum(f_z)] or
    None, z_alpha [A, f_z[2]]); the latent only when asked for."""

    def __init__(self, f_z, f_h, hidden_d, hidden_phi, hidden_c,
                 hidden_shift, hidden_alpha, c_normalization="sigmoid",
                 reduction="sum", dropout=0.0, generator=None):
        super().__init__()
        self.c_normalization, self.reduction = c_normalization, reduction
        g = generator
        self.Encoder_D = MLP(2 * f_h + 1, f_z[0], hidden_d, dropout, g)
        self.Encoder_phi = MLP(3 * f_h + 2, f_z[1], hidden_phi, dropout, g)
        self.Encoder_c = MLP(4 * f_h, 1, hidden_c, dropout, g)
        self.Encoder_sinusoidal_shift = MLP(4 * f_h, 2, hidden_shift,
                                            dropout, g)
        self.Encoder_alpha = MLP(2 * f_h + 1, f_z[2], hidden_alpha, dropout,
                                 g)

    def forward(self, h: torch.Tensor, batch: ChiroBatch, latent: bool):
        def rows(*idx):
            return torch.cat([take_rows(h, i) for i in idx], dim=1)

        def both_ways(enc, fwd, rev):
            return enc(fwd) + enc(rev)

        i, j, k, l = batch.dih_i, batch.dih_j, batch.dih_k, batch.dih_l
        fwd, rev = rows(i, j, k, l), rows(l, k, j, i)
        c_tensor = both_ways(self.Encoder_c, fwd, rev)
        shift = both_ways(self.Encoder_sinusoidal_shift, fwd, rev)
        shift = shift / torch.clamp(
            torch.linalg.vector_norm(shift, dim=1, keepdim=True), min=1e-12)
        phase_cos, phase_sin = shift[:, 0:1], shift[:, 1:2]

        num_alpha = batch.alpha_mask.shape[0]
        dmask = batch.dih_mask
        if self.c_normalization == "softmax":
            c = c_tensor[:, 0]
            with torch.no_grad():
                mx = segment_max(torch.where(dmask, c, float("-inf")),
                                 batch.ls_map, num_alpha)
            shifted = torch.where(dmask, c - take_rows(mx, batch.ls_map),
                                  0.0)
            ex = torch.where(dmask, torch.exp(shifted), 0.0)
            den = segment_sum_nodes(ex, batch.ls_map, num_alpha)
            c_norm = (ex / torch.clamp(take_rows(den, batch.ls_map),
                                       min=1e-16))[:, None]
        else:
            c_norm = torch.sigmoid(c_tensor)

        cp = torch.cos(batch.dihedrals)[:, None]
        sp = torch.sin(batch.dihedrals)[:, None]
        scaled = torch.cat([cp * phase_cos - sp * phase_sin,
                            sp * phase_cos + cp * phase_sin], dim=1) * c_norm
        pooled = segment_sum_nodes(scaled, batch.ls_map, num_alpha,
                                   mask=dmask)
        radii = torch.linalg.vector_norm(pooled, dim=1, keepdim=True)
        ax, ay = batch.alpha_x, batch.alpha_y
        z_alpha = both_ways(self.Encoder_alpha,
                            torch.cat([rows(ax, ay), radii], dim=1),
                            torch.cat([rows(ay, ax), radii], dim=1))
        if not latent:
            return None, z_alpha

        d = batch.distances[:, None]
        di, dj = batch.dist_i, batch.dist_j
        z_d = both_ways(self.Encoder_D, torch.cat([rows(di, dj), d], dim=1),
                        torch.cat([rows(dj, di), d], dim=1))
        cs = torch.cos(batch.angles)[:, None]
        sn = torch.sin(batch.angles)[:, None]
        ai, aj, ak = batch.ang_i, batch.ang_j, batch.ang_k
        z_phi = both_ways(self.Encoder_phi,
                          torch.cat([rows(ai, aj, ak), cs, sn], dim=1),
                          torch.cat([rows(ak, aj, ai), cs, sn], dim=1))

        B = batch.num_graphs
        gid = batch.node_graph_id
        pooled_parts = []
        for v, idx, m in ((z_d, di, batch.dist_mask),
                          (z_phi, ai, batch.ang_mask),
                          (z_alpha, ax, batch.alpha_mask)):
            seg = take_rows(gid, idx)
            p = segment_sum_nodes(v, seg, B, mask=m)
            if self.reduction in ("mean", "average"):
                cnt = segment_sum_nodes(m.to(v.dtype)[:, None], seg, B)
                p = p / torch.clamp(cnt, min=1.0)
            pooled_parts.append(p)
        return torch.cat(pooled_parts, dim=1), z_alpha


class GraphEmbedder(nn.Module):
    """EConv (NNConv over the bonds), then the GAT layers."""

    def __init__(self, node_dim, edge_dim, f_h_econv, econv_mlp_hidden,
                 dims, heads, dropout, generator):
        super().__init__()
        self.EConv = NNConv(node_dim, f_h_econv, edge_dim, econv_mlp_hidden,
                            dropout, generator)
        ins = [f_h_econv, *dims[:-1]]
        self.GAT_layers = nn.ModuleList(
            GATConv(a, b, heads, dropout, generator)
            for a, b in zip(ins, dims))

    def forward(self, batch: ChiroBatch) -> torch.Tensor:
        src, dst, m = batch.edge_src, batch.edge_dst, batch.edge_mask
        h = self.EConv(batch.x, src, dst, batch.edge_attr, m)
        for gat in self.GAT_layers:
            h = gat(h, src, dst, m)
        return h


class ChiralMessagePassing(nn.Module):
    """ChiralEConv (NNConv over the central bonds, conditioned on
    z_alpha), then GAT layers over the bonds."""

    def __init__(self, f_h, f_z_alpha, econv_hidden, gat_layers, gat_heads,
                 dropout, generator):
        super().__init__()
        self.ChiralEConv = NNConv(f_h, f_h, f_z_alpha, econv_hidden,
                                  dropout, generator)
        self.ChiralGATLayers = nn.ModuleList(
            GATConv(f_h, f_h, gat_heads, dropout, generator)
            for _ in range(gat_layers))

    def forward(self, h, z_alpha, batch: ChiroBatch) -> torch.Tensor:
        h = self.ChiralEConv(h, batch.alpha_x, batch.alpha_y, z_alpha,
                             batch.alpha_mask)
        for gat in self.ChiralGATLayers:
            h = gat(h, batch.edge_src, batch.edge_dst, batch.edge_mask)
        return h


class _Encoder(nn.Module):
    """The reference's ``encoder`` container (its checkpoint's layout)."""


class ChIRoNet(nn.Module):
    def __init__(
        self,
        f_z: Tuple[int, int, int] = (8, 8, 8),
        f_h: int = 64,
        f_h_econv: int = 64,
        econv_mlp_hidden: Tuple[int, ...] = (32, 32),
        gat_hidden: Tuple[int, ...] = (64,),
        gat_heads: int = 4,
        hidden_d: Tuple[int, ...] = (64, 64),
        hidden_phi: Tuple[int, ...] = (64, 64),
        hidden_c: Tuple[int, ...] = (64, 64),
        hidden_shift: Tuple[int, ...] = (256, 256),
        hidden_alpha: Tuple[int, ...] = (64, 64),
        c_normalization: str = "sigmoid",
        reduction: str = "sum",
        chiral_message_passing: bool = False,
        cmp_econv_hidden: Tuple[int, ...] = (256, 256),
        cmp_gat_layers: int = 3,
        cmp_gat_heads: int = 2,
        dropout: float = 0.0,
        output_mode: str = "molecule",
        node_dim: int = 52,
        edge_dim: int = 14,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if output_mode not in OUTPUT_MODES:
            raise ValueError(f"unknown output_mode {output_mode!r}")
        self.f_h = f_h
        self.output_mode = output_mode
        self.chiral_message_passing = chiral_message_passing
        # The graph-embedding width (models/registry.py's out_dim_field).
        self.out_dim = {"molecule": f_h, "conformer": sum(f_z),
                        "both": f_h + sum(f_z)}[output_mode]
        gen = generator
        self.encoder = _Encoder()
        self.encoder.Graph_Embedder = GraphEmbedder(
            node_dim, edge_dim, f_h_econv, econv_mlp_hidden,
            (*gat_hidden, f_h), gat_heads, dropout, gen)
        self.encoder.InternalCoordinateEncoder = InternalCoordinateEncoder(
            f_z, f_h, hidden_d, hidden_phi, hidden_c, hidden_shift,
            hidden_alpha, c_normalization, reduction, dropout, gen)
        if chiral_message_passing:
            self.encoder.ChiralMessagePassingEncoder = ChiralMessagePassing(
                f_h, f_z[2], cmp_econv_hidden, cmp_gat_layers,
                cmp_gat_heads, dropout, gen)

    def forward(self, batch: ChiroBatch) -> torch.Tensor:
        enc = self.encoder
        h = enc.Graph_Embedder(batch)
        latent = None
        want_latent = self.output_mode != "molecule"
        if want_latent or self.chiral_message_passing:
            latent, z_alpha = enc.InternalCoordinateEncoder(h, batch,
                                                            want_latent)
        if self.chiral_message_passing:
            h = enc.ChiralMessagePassingEncoder(h, z_alpha, batch)
        if self.output_mode == "conformer":
            return latent
        # Padded nodes are zeroed before pooling (the biases leak there).
        mol = global_add_pool(h, batch.node_graph_id, batch.num_graphs,
                              node_mask=batch.node_mask)
        if self.output_mode == "both":
            return torch.cat([mol, latent], dim=-1)
        return mol
