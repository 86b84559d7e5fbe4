"""SphereNet baseline.

Port of ``molkgnn_tpu/models/spherenet.py``: messages on the directed
edges of the radius graph, with a distance basis, an angle basis (spherical
Bessel x Y_l0) and a torsion basis (spherical Bessel x the real harmonics
Y_lm, m != 0 included), init / update_e / update_v blocks, and every
layer's per-graph output summed.

Torsion: for each triplet k -> j -> i, the dihedral between the planes
(j->i, j->k) and (j->i, j->k_n) over every in-neighbour k_n of j other
than i, mapped to (0, 2 pi], and the least of them (a segment minimum;
k_n == k gives 2 pi). Where |sin| < 1e-4 of the hypotenuse and cos > 0 the
torsion snaps to the 2 pi branch, so that coplanar candidates do not flip
between ~0 and ~2 pi with rounding. The torsion depends on positions only:
no parameter gradient flows through the minimum. The angle and torsion
bases take no envelope, as in the reference.

Torsion basis columns, per l: [m = 0, cos forms m = 1..l, sin forms
m = l..1], the sin form being the cos form at phi - pi / (2m); entry h of
the n^2 harmonics pairs with Bessel order h % n (the reference's layout).

The modules carry the reference checkpoint's names (``emb.dist_emb.freq``,
``init_e``, ``init_v``, ``update_es.{l}``, ``update_vs.{l}``). Init:
glorot-orthogonal (scale 2) where the reference resets, torch's Linear
default in init_e's ``lin_rbf_0`` and ``lin``, the embedding
uniform(-sqrt 3, sqrt 3); all drawn from ``generator``. With
``use_node_features=False`` one learned vector of width ``hidden_channels``
(init N(0, 1)) is broadcast to every node in place of the atom-type table;
its key, ``init_e.node_embedding.node_embedding``, is the one the JAX
package's importer maps its ``init_e/node_embedding`` leaf to.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from molkgnn_torch.graphs.geometric import PointBatch
from molkgnn_torch.models.common import TorchLinear, swish
from molkgnn_torch.models.dimenetpp import (
    BesselBasis,
    edge_lengths,
    glorot_linear,
    residual_stack,
    triplet_nodes,
    uniform_embedding,
)
from molkgnn_torch.ops.basis import (
    bessel_basis,
    bessel_rbf,
    real_sph_harm,
    sph_harm_factors,
)
from molkgnn_torch.ops.segment import (
    global_add_pool,
    segment_min,
    segment_sum_nodes,
    take_rows,
)


def angle_emb(rbf, angle):
    """[T, n * k] b_lr(d/c) Y_l0(angle), no envelope; ``rbf`` [T, n, k] is
    ``bessel_basis`` of the triplets' d / c."""
    n, k = rbf.shape[1:]
    return (rbf * real_sph_harm(angle, n)[:, :, None]).reshape(-1, n * k)


def torsion_emb(rbf, angle, phi):
    """[T, n * n * k] b_{h % n, r}(d/c) Y_h(angle, phi) (module doc);
    ``rbf`` as in ``angle_emb``."""
    n, k = rbf.shape[1:]
    f = sph_harm_factors(angle, n)
    harmonics = []
    for l in range(n):
        harmonics.append(f[l][0] + torch.zeros_like(phi))
        harmonics += [f[l][m] * torch.cos(m * phi) for m in range(1, l + 1)]
        harmonics += [f[l][m] * torch.cos(m * (phi - math.pi / (2 * m)))
                      for m in range(l, 0, -1)]
    cbf = torch.stack(harmonics, dim=1).reshape(-1, n, n)
    return (rbf[:, None, :, :] * cbf[:, :, :, None]).reshape(-1, n * n * k)


class _Emb(nn.Module):
    def __init__(self, num_radial):
        super().__init__()
        self.dist_emb = BesselBasis(num_radial)


class _NodeVector(nn.Module):
    def __init__(self, hidden, gen):
        super().__init__()
        self.node_embedding = nn.Parameter(torch.randn(hidden, generator=gen))


class InitE(nn.Module):
    def __init__(self, num_radial, hidden, gen, use_node_features=True):
        super().__init__()
        if use_node_features:
            self.emb = uniform_embedding(95, hidden, gen)
        else:
            self.node_embedding = _NodeVector(hidden, gen)
        self.use_node_features = use_node_features
        self.lin_rbf_0 = TorchLinear(num_radial, hidden, gen)
        self.lin = TorchLinear(3 * hidden, hidden, gen)
        self.lin_rbf_1 = glorot_linear(num_radial, hidden, gen, bias=False)

    def forward(self, z, rbf, i, j):
        if self.use_node_features:
            x = self.emb(z)
        else:
            vec = self.node_embedding.node_embedding
            x = vec[None, :].expand(z.shape[0], -1)
        rbf0 = swish(self.lin_rbf_0(rbf))
        e1 = swish(self.lin(torch.cat(
            [take_rows(x, i), take_rows(x, j), rbf0], dim=-1)))
        return e1, self.lin_rbf_1(rbf) * e1


class UpdateE(nn.Module):
    def __init__(self, hidden, int_emb, basis_dist, basis_angle,
                 basis_torsion, num_spherical, num_radial, before_skip,
                 after_skip, gen):
        super().__init__()
        g = lambda i, o, bias=True: glorot_linear(i, o, gen, bias)
        s, r = num_spherical, num_radial
        self.lin_rbf1 = g(r, basis_dist, False)
        self.lin_rbf2 = g(basis_dist, hidden, False)
        self.lin_sbf1 = g(s * r, basis_angle, False)
        self.lin_sbf2 = g(basis_angle, int_emb, False)
        self.lin_t1 = g(s * s * r, basis_torsion, False)
        self.lin_t2 = g(basis_torsion, int_emb, False)
        self.lin_rbf = g(r, hidden, False)
        self.lin_kj = g(hidden, hidden)
        self.lin_ji = g(hidden, hidden)
        self.lin_down = g(hidden, int_emb, False)
        self.lin_up = g(int_emb, hidden, False)
        self.layers_before_skip = residual_stack(before_skip, hidden, gen)
        self.lin = g(hidden, hidden)
        self.layers_after_skip = residual_stack(after_skip, hidden, gen)

    def forward(self, e, rbf0, sbf, tbf, idx_kj, idx_ji, tri_mask):
        x1, _ = e
        x_ji = swish(self.lin_ji(x1))
        x_kj = swish(self.lin_kj(x1))
        x_kj = x_kj * self.lin_rbf2(self.lin_rbf1(rbf0))
        x_kj = swish(self.lin_down(x_kj))
        x_t = take_rows(x_kj, idx_kj) * self.lin_sbf2(self.lin_sbf1(sbf))
        x_t = x_t * self.lin_t2(self.lin_t1(tbf))
        x_kj = segment_sum_nodes(x_t, idx_ji, x1.shape[0], mask=tri_mask)
        x_kj = swish(self.lin_up(x_kj))
        e1 = x_ji + x_kj
        for layer in self.layers_before_skip:
            e1 = layer(e1)
        e1 = swish(self.lin(e1)) + x1
        for layer in self.layers_after_skip:
            e1 = layer(e1)
        return e1, self.lin_rbf(rbf0) * e1


class UpdateV(nn.Module):
    def __init__(self, hidden, out_emb, out_channels, num_layers, gen):
        super().__init__()
        self.lin_up = glorot_linear(hidden, out_emb, gen)
        self.lins = nn.ModuleList(
            glorot_linear(out_emb, out_emb, gen) for _ in range(num_layers))
        self.lin = glorot_linear(out_emb, out_channels, gen, bias=False)

    def forward(self, e, i, num_nodes, edge_mask):
        v = segment_sum_nodes(e[1], i, num_nodes, mask=edge_mask)
        v = self.lin_up(v)
        for lin in self.lins:
            v = swish(lin(v))
        return self.lin(v)


def torsions(batch: PointBatch, t_j, t_i, t_k):
    """The least torsion of each triplet over its candidates (module doc);
    0 where a triplet is padded or has no candidate."""
    pos, q_t, q_kn = batch.pos, batch.quad_t, batch.quad_kn
    p_j = take_rows(pos, take_rows(t_j, q_t))
    p_j0 = take_rows(pos, take_rows(t_k, q_t)) - p_j
    p_ji = take_rows(pos, take_rows(t_i, q_t)) - p_j
    p_jk = take_rows(pos, q_kn) - p_j
    dist_ji = torch.linalg.norm(p_ji, dim=-1)
    plane1 = torch.linalg.cross(p_ji, p_j0, dim=-1)
    plane2 = torch.linalg.cross(p_ji, p_jk, dim=-1)
    ta = torch.sum(plane1 * plane2, dim=-1)
    tb = torch.sum(torch.linalg.cross(plane1, plane2, dim=-1) * p_ji,
                   dim=-1) / torch.clamp(dist_ji, min=1e-9)
    hyp = torch.sqrt(ta * ta + tb * tb)
    tb = torch.where((torch.abs(tb) < 1e-4 * hyp) & (ta > 0), 0.0, tb)
    t1 = torch.atan2(tb, ta)
    t1 = torch.where(t1 <= 0, t1 + 2 * math.pi, t1)
    t1 = torch.where(batch.quad_mask, t1, math.inf)
    least = segment_min(t1, q_t, batch.tri_mask.shape[0])
    return torch.where(torch.isfinite(least), least, 0.0)


class SphereNet(nn.Module):
    def __init__(
        self,
        cutoff: float = 5.0,
        num_layers: int = 4,
        hidden_channels: int = 128,
        out_channels: int = 32,
        int_emb_size: int = 64,
        basis_emb_size_dist: int = 8,
        basis_emb_size_angle: int = 8,
        basis_emb_size_torsion: int = 8,
        out_emb_channels: int = 256,
        num_spherical: int = 7,
        num_radial: int = 6,
        envelope_exponent: int = 5,
        num_before_skip: int = 1,
        num_after_skip: int = 2,
        num_output_layers: int = 3,
        use_node_features: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = generator
        self.cutoff, self.envelope_exponent = cutoff, envelope_exponent
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.out_channels = out_channels
        h = hidden_channels
        self.emb = _Emb(num_radial)
        self.init_e = InitE(num_radial, h, gen, use_node_features)
        self.init_v = UpdateV(h, out_emb_channels, out_channels,
                              num_output_layers, gen)
        self.update_es = nn.ModuleList(
            UpdateE(h, int_emb_size, basis_emb_size_dist,
                    basis_emb_size_angle, basis_emb_size_torsion,
                    num_spherical, num_radial, num_before_skip,
                    num_after_skip, gen)
            for _ in range(num_layers))
        self.update_vs = nn.ModuleList(
            UpdateV(h, out_emb_channels, out_channels, num_output_layers, gen)
            for _ in range(num_layers))

    def forward(self, batch: PointBatch) -> torch.Tensor:
        j, i, pos = batch.edge_src, batch.edge_dst, batch.pos
        dist = edge_lengths(batch, self.cutoff)
        idx_kj, idx_ji = batch.tri_edge_kj, batch.tri_edge_ji
        t_j, t_i, t_k = triplet_nodes(batch)
        p_j = take_rows(pos, t_j)
        v_ji = take_rows(pos, t_i) - p_j
        v_jk = take_rows(pos, t_k) - p_j
        a = torch.sum(v_ji * v_jk, dim=-1)
        b = torch.linalg.norm(torch.linalg.cross(v_ji, v_jk, dim=-1), dim=-1)
        angle = torch.where(batch.tri_mask, torch.atan2(b, a), 0.0)
        torsion = torsions(batch, t_j, t_i, t_k)

        s, r, c = self.num_spherical, self.num_radial, self.cutoff
        rbf = bessel_rbf(dist, self.emb.dist_emb.freq, c,
                         self.envelope_exponent)
        dist_t = torch.where(batch.tri_mask, take_rows(dist, idx_kj), c)
        rbf_t = bessel_basis(dist_t / c, s, r)
        sbf = angle_emb(rbf_t, angle)
        tbf = torsion_emb(rbf_t, angle, torsion)

        def pool(v):
            return global_add_pool(v, batch.node_graph_id, batch.num_graphs,
                                   node_mask=batch.node_mask)

        n = batch.num_nodes
        e = self.init_e(batch.z, rbf, i, j)
        u = pool(self.init_v(e, i, n, batch.edge_mask))
        for upd_e, upd_v in zip(self.update_es, self.update_vs):
            e = upd_e(e, rbf, sbf, tbf, idx_kj, idx_ji, batch.tri_mask)
            u = u + pool(upd_v(e, i, n, batch.edge_mask))
        return u
