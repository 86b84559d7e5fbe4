"""MolKGNN: chirality-aware molecular kernel convolutions, on PyTorch.

Port of ``molkgnn_tpu/models/kgnn.py`` with the same numerical contract:

  * All permutations are scored densely: cosine similarity of row-normalized
    operands is a dot product, so one [M, d*F] x [d*F, L*P] product scores
    every (neighborhood, kernel, permutation). With ``use_kernel=True`` the
    support-attribute scoring and its max/argmax over permutations run in the
    hand-written CUDA scorer (``ops/support_score.py``) instead, one launch
    per layer for all degree buckets.
  * The best-permutation gather only touches scalars (scores and
    precomputed support determinants).
  * The chirality sign (degree 4, last layer) compares signed tetrahedral
    volumes; the kernel-side volume is computed per (kernel, permutation)
    and gathered at the best permutation per (m, l).
  * Per-degree score blocks are scatter-added into node order; padded
    bucket rows point at node 0 and are masked to zero first.

Scores are [nodes, kernels] throughout. Module names give ``state_dict()``
the key layout of the reference PyTorch Lightning checkpoint
(``gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d-1}.*``).

Fixed (human-designed) kernel sets, score capture, the bf16 product option
and the cross-device psum of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch
from molkgnn_torch.models.common import TorchLinear, swish
from molkgnn_torch.ops.norm import MaskedBatchNorm
from molkgnn_torch.ops.permutations import perm_table
from molkgnn_torch.ops.segment import gather_scatter_add, global_add_pool
from molkgnn_torch.ops.similarity import (
    cosine_matrix,
    neighborhood_similarity,
    normalize_rows,
)
from molkgnn_torch.ops.support_score import (
    fused_support_score,
    grouped_support_score,
)

_PAIRS = [(i, j) for i in range(4) for j in range(i + 1, 4)]


class KernelConv(nn.Module):
    """Score degree-``deg`` neighborhoods against ``num_kernels`` learnable
    molecular kernels.

    Each kernel holds a center-atom feature vector, ``deg`` support-atom
    feature vectors, ``deg`` bond feature vectors, and ``deg`` 3D support
    positions. A neighborhood is scored by the best alignment (over the
    allowed support permutations) of a softmax-weighted sum of three cosine
    scores (support attrs, center attrs, bond attrs); for degree 4 in the
    last layer the score is multiplied by a chirality sign.
    """

    def __init__(
        self,
        deg: int,
        num_kernels: int,
        node_dim: int,
        edge_dim: int,
        pos_dim: int = 3,
        use_kernel: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.deg = deg
        self.num_kernels = num_kernels
        self.node_dim = node_dim
        self.use_kernel = use_kernel
        L, d = num_kernels, deg

        def randn(*shape):
            return nn.Parameter(torch.randn(*shape, generator=generator))

        self.x_center = randn(L, node_dim)
        self.x_support = randn(L, d, node_dim)
        self.edge_attr_support = randn(L, d, edge_dim)
        self.p_support = randn(L, d, pos_dim)
        # length/angle weights exist in reference checkpoints but never
        # enter the score; kept for checkpoint-shape parity.
        for name in (
            "length_sc_weight",
            "angle_sc_weight",
            "center_attr_sc_weight",
            "support_attr_sc_weight",
            "edge_attr_support_sc_weight",
        ):
            setattr(self, name, nn.Parameter(torch.tensor(0.2)))
        self.register_buffer(
            "perms",
            torch.from_numpy(perm_table(deg)).long(),
            persistent=False,
        )

    def support_operands(self, x_nei: torch.Tensor):
        """Row-normalized (A [M, d*F], B [P, d*F, L]) operands, contiguous,
        for the support scorer, which returns the raw (sum-cosine, argmax)
        pair fed back through ``support_result``."""
        d, L = self.deg, self.num_kernels
        m = x_nei.shape[0]
        a = normalize_rows(x_nei).reshape(m, d * self.node_dim)
        b = (
            normalize_rows(self.x_support[:, self.perms, :])
            .reshape(L, len(self.perms), d * self.node_dim)
            .permute(1, 2, 0)
            .contiguous()
        )
        return a, b

    def forward(
        self,
        x_focal: torch.Tensor,  # [M, F]
        p_focal: torch.Tensor,  # [M, 3]
        x_nei: torch.Tensor,  # [M, d, F]
        p_nei: torch.Tensor,  # [M, d, 3]
        e_nei: torch.Tensor,  # [M, d, Fe]
        mask: torch.Tensor,  # [M] bool
        is_last_layer: bool = False,
        support_result=None,  # optional (raw_best [M, L], idx [M, L])
    ) -> torch.Tensor:  # [M, L]
        d = self.deg
        perms = self.perms

        # --- support-attribute score over all permutations ---
        if support_result is not None:
            best_sc = support_result[0] / d
            best_idx = support_result[1].long()
        elif self.use_kernel:
            best_sc, best_idx = fused_support_score(
                *self.support_operands(x_nei)
            )
            best_sc = best_sc / d
            best_idx = best_idx.long()
        else:
            support_sc = neighborhood_similarity(
                x_nei, self.x_support[:, perms, :]
            )  # [M, L, P]
            best_sc, best_idx = support_sc.max(dim=2)  # first max wins

        # --- edge-attribute score at the best alignment ---
        edge_sc_all = neighborhood_similarity(
            e_nei, self.edge_attr_support[:, perms, :]
        )  # [M, L, P]
        edge_sc = torch.gather(edge_sc_all, 2, best_idx[:, :, None])[:, :, 0]

        # --- center-attribute score ---
        center_sc = cosine_matrix(x_focal, self.x_center)  # [M, L]

        # --- softmax-normalized score weights ---
        ew = torch.exp(
            torch.stack(
                [
                    self.support_attr_sc_weight,
                    self.center_attr_sc_weight,
                    self.edge_attr_support_sc_weight,
                ]
            )
        )
        ws = ew / ew.sum()
        sc = best_sc * ws[0] + center_sc * ws[1] + edge_sc * ws[2]

        # --- chirality sign (deg 4, last layer only) ---
        if d == 4 and is_last_layer:
            sc = sc * self._chirality_sign(
                x_nei, p_nei - p_focal[:, None, :], best_idx
            ).to(sc.dtype)

        return torch.where(mask[:, None], sc, 0.0)

    def _chirality_sign(
        self,
        x_nei: torch.Tensor,  # [M, 4, F]
        p_nei_c: torch.Tensor,  # [M, 4, 3] centered at focal
        best_idx: torch.Tensor,  # [M, L] int64
    ) -> torch.Tensor:  # [M, L] in {+1, -1}
        """Signed-tetrahedral-volume chirality comparison.

        If any two of the four neighbor feature vectors are identical the
        neighborhood is achiral => +1 for all kernels. Otherwise compare the
        sign of det[t1, t2, t3] of the neighborhood against that of the
        best-aligned kernel supports; a mismatch flips the score.

        The equality test is exact. At layers >= 2 the features are sums
        taken with atomics on CUDA (ops/segment.py), so two neighbors whose
        sums have several terms may compare unequal in one run and equal in
        another; neighbors that are single-term sums (sibling leaves)
        compare exactly, as in the JAX package.
        """
        det_nei = (
            p_nei_c[:, 2]
            * torch.linalg.cross(p_nei_c[:, 0], p_nei_c[:, 1], dim=-1)
        ).sum(-1)  # [M]
        s = self.p_support[:, self.perms, :]  # [L, P, 4, 3]
        det_sup = (
            s[:, :, 2] * torch.linalg.cross(s[:, :, 0], s[:, :, 1], dim=-1)
        ).sum(-1)  # [L, P]
        num_kernels = det_sup.shape[0]
        kernel_ids = torch.arange(num_kernels, device=best_idx.device)
        det_sup_best = det_sup[kernel_ids[None, :], best_idx]  # [M, L]

        sign_match = torch.sign(det_nei)[:, None] == torch.sign(det_sup_best)

        any_equal = torch.zeros(
            x_nei.shape[0], dtype=torch.bool, device=x_nei.device
        )
        for i, j in _PAIRS:
            any_equal |= (x_nei[:, i, :] == x_nei[:, j, :]).all(dim=-1)

        return torch.where(
            any_equal[:, None] | sign_match,
            torch.ones_like(det_sup_best),
            -torch.ones_like(det_sup_best),
        )


class KernelSetConv(nn.Module):
    """Four per-degree KernelConvs assembled into node-order scores.

    Output [N, L1+L2+L3+L4]: node n's row holds its degree-d kernel scores in
    that degree's column block and zeros elsewhere (degree-0 / degree>4
    nodes are all-zero).
    """

    def __init__(
        self,
        num_kernels: Tuple[int, int, int, int],
        node_dim: int,
        edge_dim: int,
        pos_dim: int = 3,
        use_kernel: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_kernel = use_kernel
        self.trainable_kernelconv_set = nn.ModuleList(
            KernelConv(
                deg=d,
                num_kernels=num_kernels[d - 1],
                node_dim=node_dim,
                edge_dim=edge_dim,
                pos_dim=pos_dim,
                use_kernel=use_kernel,
                generator=generator,
            )
            for d in range(1, 5)
        )

    def block_widths(self) -> Tuple[int, int, int, int]:
        """Kernel-score columns per degree."""
        return tuple(c.num_kernels for c in self.trainable_kernelconv_set)

    def forward(
        self,
        x: torch.Tensor,  # [N, F] current node features
        p: torch.Tensor,  # [N, 3]
        buckets: Sequence[DegreeBucket],
        is_last_layer: bool = False,
    ) -> torch.Tensor:
        n = x.shape[0]
        inputs = [
            dict(
                x_focal=x[b.focal_index],
                p_focal=p[b.focal_index],
                x_nei=x[b.nei_index],
                p_nei=p[b.nei_index],
                e_nei=b.nei_edge_attr,
                mask=b.mask,
                is_last_layer=is_last_layer,
            )
            for b in buckets
        ]
        convs = self.trainable_kernelconv_set

        # With the kernel on, all degree buckets are scored by ONE launch.
        results = [None] * 4
        if self.use_kernel:
            ops = [
                conv.support_operands(inp["x_nei"])
                for conv, inp in zip(convs, inputs)
            ]
            results = grouped_support_score(
                [a for a, _ in ops], [b for _, b in ops]
            )

        blocks = []
        for conv, inp, res, b in zip(convs, inputs, results, buckets):
            sc = conv(**inp, support_result=res)  # [M_d, L], 0 on padding
            # Padded rows target node 0 with zero contribution.
            block = sc.new_zeros((n, sc.shape[1]))
            blocks.append(block.index_add_(0, b.focal_index, sc))
        return torch.cat(blocks, dim=1)


class MolGCN(nn.Module):
    """Stack of KernelSetConv layers + sum-aggregation message passing.

    Layer 0 consumes raw node features; layers 1..L-1 consume the previous
    layer's aggregated kernel-score vector. After scoring, each node
    receives the sum of its neighbors' score vectors.
    """

    def __init__(
        self,
        num_layers: int,
        kernels_1hop: Tuple[int, int, int, int],
        kernels_nhop: Tuple[int, int, int, int],
        node_dim: int,
        edge_dim: int,
        pos_dim: int = 3,
        use_kernel: bool = False,
        chirality_every_layer: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        # Off = reference parity: the deg-4 chirality sign applies at the
        # last layer only; on, at every layer.
        self.chirality_every_layer = chirality_every_layer
        layers = []
        in_dim = node_dim
        for i in range(num_layers):
            layer = KernelSetConv(
                num_kernels=kernels_1hop if i == 0 else kernels_nhop,
                node_dim=in_dim,
                edge_dim=edge_dim,
                pos_dim=pos_dim,
                use_kernel=use_kernel,
                generator=generator,
            )
            layers.append(layer)
            in_dim = sum(layer.block_widths())
        self.layers = nn.ModuleList(layers)
        self.out_dim = in_dim

    def forward(self, batch: GraphBatch, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            sc = layer(
                h,
                batch.p,
                batch.buckets(),
                is_last_layer=self.chirality_every_layer or i == last,
            )
            h = gather_scatter_add(
                sc,
                batch.edge_src,
                batch.edge_dst,
                num_nodes=sc.shape[0],
                edge_mask=batch.edge_mask,
            )
        return h


class MolKGNNNet(nn.Module):
    """Full MolKGNN graph encoder.

    BatchNorm on node features -> MolGCN -> per-node MLP (lin1/swish/
    dropout/lin2) -> global add pool => [B, graph_embedding_dim].

    Reference quirk preserved: an edge-feature BatchNorm exists and updates
    its statistics, but its output is never used (kernel edge scores see
    the raw bond features of the degree buckets). It is kept for checkpoint
    parity.
    """

    def __init__(
        self,
        num_layers: int = 4,
        kernels_1hop: Tuple[int, int, int, int] = (10, 20, 30, 50),
        kernels_nhop: Tuple[int, int, int, int] = (10, 20, 30, 50),
        node_dim: int = 28,
        edge_dim: int = 7,
        pos_dim: int = 3,
        graph_embedding_dim: int = 32,
        drop_ratio: float = 0.0,
        use_kernel: bool = False,
        chirality_every_layer: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.graph_embedding_dim = graph_embedding_dim
        self.node_batch_norm = MaskedBatchNorm(node_dim)
        self.edge_batch_norm = MaskedBatchNorm(edge_dim)
        self.gnn = MolGCN(
            num_layers=num_layers,
            kernels_1hop=kernels_1hop,
            kernels_nhop=kernels_nhop,
            node_dim=node_dim,
            edge_dim=edge_dim,
            pos_dim=pos_dim,
            use_kernel=use_kernel,
            chirality_every_layer=chirality_every_layer,
            generator=generator,
        )
        self.graph_embedding_lin1 = TorchLinear(
            self.gnn.out_dim, graph_embedding_dim, generator=generator
        )
        self.dropout = nn.Dropout(drop_ratio)
        self.graph_embedding_lin2 = TorchLinear(
            graph_embedding_dim, graph_embedding_dim, generator=generator
        )

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        x = self.node_batch_norm(batch.x, mask=batch.node_mask)
        if self.training:
            # Dead-path edge BN: stats update only (see class docstring).
            self.edge_batch_norm(batch.edge_attr, mask=batch.edge_mask)

        h = self.gnn(batch, x)
        h = swish(self.graph_embedding_lin1(h))
        h = self.graph_embedding_lin2(self.dropout(h))
        return global_add_pool(
            h,
            batch.node_graph_id,
            num_graphs=batch.num_graphs,
            node_mask=batch.node_mask,
        )
