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
  * Per-degree score blocks are copied into node order; padded bucket
    rows point at node 0, are masked to zero first and go to a dropped
    row.
  * Every sum of two or more terms (message passing, pooling, the
    gradients of the gathers) goes through the fixed-order segment sum of
    ``ops/segment.py`` (a CUDA kernel on the card, no atomics), so the
    same molecules and weights give the same bits from run to run.
    ``MolGCN.forward`` builds the batch's plans once per forward and
    hands them to every layer; ``MolKGNNNet.forward`` builds the
    pooling's.

Scores are [nodes, kernels] throughout. Module names give ``state_dict()``
the key layout of the reference PyTorch Lightning checkpoint
(``gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d-1}.*``; a fixed
set's score weights under ``...fixed_kernelconv_set.{d-1}.*``).

Fixed (human-designed) kernel sets (``fixed_kernels``) sit at layer 0 beside
the trainable ones: each degree's column block is ``[fixed; trainable]``,
and with the kernel on, all groups of the layer go to one scorer launch (8
groups when every degree has a fixed set). Their four kernel tensors are
constants (non-persistent buffers: no gradient, no optimizer state, not in
``state_dict()``, as in the JAX package, whose template has no leaf for
them); their score weights are trainable parameters. Score capture
(``sow_scores``) keeps each layer's node-order score matrix of the last
eager forward as ``KernelSetConv.scores`` (never under CUDA-graph capture),
the counterpart of the JAX package's sown ``intermediates``.

``matmul_dtype`` (e.g. ``torch.bfloat16``) rounds the operands of the
permutation products (the plain support score and the edge score) to that
type; normalization and accumulation stay in the model's type. With
``use_kernel`` the support score stays fp32 in the scorer, as the JAX
package's Pallas path does. ``psum_group`` (a process group) sums
``KernelSetConv``'s node-order scores and ``MolGCN``'s aggregated features
over the group, differentiably (``parallel/collectives.py``): the hook of
the edge-partition baseline (``parallel/edge_partition.py``), the JAX
``psum_axis``. Neither adds a parameter.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch
from molkgnn_torch.models.common import Dropout, TorchLinear, swish
from molkgnn_torch.ops.norm import MaskedBatchNorm
from molkgnn_torch.ops.permutations import perm_table
from molkgnn_torch.ops.segment import (
    SegmentPlan,
    bucket_plans,
    edge_plans,
    gather_scatter_add,
    global_add_pool,
    planned,
    segment_plan,
    take_rows,
)
from molkgnn_torch.ops.similarity import (
    cosine_matrix,
    neighborhood_similarity,
    normalize_rows,
)
from molkgnn_torch.ops.support_score import (
    fused_support_score,
    grouped_support_score,
)
from molkgnn_torch.parallel.collectives import all_reduce_sum

_PAIRS = [(i, j) for i in range(4) for j in range(i + 1, 4)]


class _Pick(torch.autograd.Function):
    """``torch.gather(t, 2, idx)``, whose gradient is a ``scatter_`` into
    zeros: each (m, l) picks one permutation, so no two terms meet and the
    gradient is exact without ``scatter_add_``'s float atomics."""

    @staticmethod
    def forward(ctx, t, idx):
        ctx.save_for_backward(idx)
        ctx.shape = t.shape
        return torch.gather(t, 2, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad.new_zeros(ctx.shape).scatter_(2, idx, grad), None


class KernelConv(nn.Module):
    """Score degree-``deg`` neighborhoods against ``num_kernels`` learnable
    molecular kernels.

    Each kernel holds a center-atom feature vector, ``deg`` support-atom
    feature vectors, ``deg`` bond feature vectors, and ``deg`` 3D support
    positions. A neighborhood is scored by the best alignment (over the
    allowed support permutations) of a softmax-weighted sum of three cosine
    scores (support attrs, center attrs, bond attrs); for degree 4 in the
    last layer the score is multiplied by a chirality sign.

    ``init_kernel`` (a dict of the four kernel tensors: ``x_center``,
    ``x_support``, ``edge_attr_support``, ``p_support``) gives their
    values: parameters with ``trainable_kernels``, else constant buffers
    that are not in ``state_dict()``. The score weights are parameters
    either way. Random kernels draw from ``generator``; given ones draw
    nothing. The five score weights start at ``init_sc_weight``.
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
        init_kernel: Optional[dict] = None,
        trainable_kernels: bool = True,
        matmul_dtype: Optional[torch.dtype] = None,
        init_sc_weight: float = 0.2,
    ):
        super().__init__()
        self.deg = deg
        self.num_kernels = num_kernels
        self.node_dim = node_dim
        self.use_kernel = use_kernel
        self.matmul_dtype = matmul_dtype
        L, d = num_kernels, deg
        shapes = dict(x_center=(L, node_dim), x_support=(L, d, node_dim),
                      edge_attr_support=(L, d, edge_dim),
                      p_support=(L, d, pos_dim))
        for name, shape in shapes.items():
            if init_kernel is None:
                self.register_parameter(name, nn.Parameter(
                    torch.randn(*shape, generator=generator)))
                continue
            value = torch.from_numpy(
                np.array(init_kernel[name], np.float32))
            if tuple(value.shape) != shape:
                raise ValueError(f"init_kernel[{name!r}]: expected {shape}, "
                                 f"got {tuple(value.shape)}")
            if trainable_kernels:
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.register_buffer(name, value, persistent=False)
        # length/angle weights exist in reference checkpoints but never
        # enter the score; kept for checkpoint-shape parity.
        for name in (
            "length_sc_weight",
            "angle_sc_weight",
            "center_attr_sc_weight",
            "support_attr_sc_weight",
            "edge_attr_support_sc_weight",
        ):
            setattr(self, name, nn.Parameter(torch.tensor(init_sc_weight)))
        perms = torch.from_numpy(perm_table(deg)).long()
        self.register_buffer("perms", perms, persistent=False)
        # The plan of the gathers at ``perms``, for their gradients: the
        # table never changes, so its plan is built once, here.
        plan = segment_plan(perms, deg)
        self.register_buffer("perm_row", plan.row, persistent=False)
        self.register_buffer("perm_rowptr", plan.rowptr, persistent=False)

    def perm_support(self, t: torch.Tensor) -> torch.Tensor:
        """A support tensor [L, d, C] gathered at every permutation:
        [L, P, d, C]. On the card its gradient sums over the permutations
        in a fixed order, through the plan of the static ``perms`` table."""
        plan = SegmentPlan(self.perm_row, self.perm_rowptr,
                           self.perms.reshape(-1))
        return take_rows(t, self.perms, 1,
                         plan=plan if planned(t) else None)

    def support_a(self, x_nei: torch.Tensor) -> torch.Tensor:
        """The support scorer's row-normalized A [M, d*F], contiguous; the
        same for every kernel set of the degree."""
        return normalize_rows(x_nei).reshape(x_nei.shape[0],
                                             self.deg * self.node_dim)

    def support_b(self) -> torch.Tensor:
        """The support scorer's row-normalized B [P, d*F, L], contiguous."""
        return (
            normalize_rows(self.perm_support(self.x_support))
            .reshape(self.num_kernels, len(self.perms),
                     self.deg * self.node_dim)
            .permute(1, 2, 0)
            .contiguous()
        )

    def support_operands(self, x_nei: torch.Tensor):
        """(A [M, d*F], B [P, d*F, L]) for the support scorer, which
        returns the raw (sum-cosine, argmax) pair fed back through
        ``support_result``."""
        return self.support_a(x_nei), self.support_b()

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
                x_nei, self.perm_support(self.x_support),
                matmul_dtype=self.matmul_dtype,
            )  # [M, L, P]
            best_sc, best_idx = support_sc.max(dim=2)  # first max wins

        # --- edge-attribute score at the best alignment ---
        edge_sc_all = neighborhood_similarity(
            e_nei, self.perm_support(self.edge_attr_support),
            matmul_dtype=self.matmul_dtype,
        )  # [M, L, P]
        edge_sc = _Pick.apply(edge_sc_all, best_idx[:, :, None])[:, :, 0]

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
        # A +-1 constant: its gradient is zero, so autograd skips it.
        if d == 4 and is_last_layer:
            with torch.no_grad():
                sign = self._chirality_sign(
                    x_nei, p_nei - p_focal[:, None, :], best_idx
                )
            sc = sc * sign.to(sc.dtype)

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

        The equality test is exact. At layers >= 2 the features are sums,
        taken in a fixed order (ops/segment.py), so the test gives the same
        answer from run to run on the card, as in the JAX package.
        """
        det_nei = (
            p_nei_c[:, 2]
            * torch.linalg.cross(p_nei_c[:, 0], p_nei_c[:, 1], dim=-1)
        ).sum(-1)  # [M]
        s = self.perm_support(self.p_support)  # [L, P, 4, 3]
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

    Output [N, W1+W2+W3+W4]: node n's row holds its degree-d kernel scores
    in that degree's column block and zeros elsewhere (degree-0 / degree>4
    nodes are all-zero). A degree's block is ``[fixed; trainable]``: the
    fixed set's columns (``fixed_kernels[d-1]``, a dict of the four kernel
    tensors, or None) before the trainable ones.

    With ``sow_scores`` the output of the last eager forward is kept,
    detached, as ``scores`` (None until then); a forward under CUDA-graph
    capture keeps nothing.
    """

    def __init__(
        self,
        num_kernels: Tuple[int, int, int, int],
        node_dim: int,
        edge_dim: int,
        pos_dim: int = 3,
        use_kernel: bool = False,
        generator: torch.Generator | None = None,
        fixed_kernels: Optional[Sequence[Optional[dict]]] = None,
        sow_scores: bool = False,
        matmul_dtype: Optional[torch.dtype] = None,
        psum_group=None,
    ):
        super().__init__()
        self.use_kernel = use_kernel
        self.sow_scores = sow_scores
        self.psum_group = psum_group
        self.scores: Optional[torch.Tensor] = None
        dims = dict(node_dim=node_dim, edge_dim=edge_dim, pos_dim=pos_dim,
                    use_kernel=use_kernel, matmul_dtype=matmul_dtype)
        # Keyed by degree - 1, the reference checkpoint's index.
        self.fixed_kernelconv_set = nn.ModuleDict({
            str(d - 1): KernelConv(
                deg=d, num_kernels=int(np.shape(f["x_center"])[0]),
                init_kernel=f, trainable_kernels=False, **dims,
            )
            for d, f in enumerate(fixed_kernels or (None,) * 4, 1)
            if f is not None
        })
        self.trainable_kernelconv_set = nn.ModuleList(
            KernelConv(deg=d, num_kernels=num_kernels[d - 1],
                       generator=generator, **dims)
            for d in range(1, 5)
        )

    def degree_convs(self) -> list:
        """Per degree, its KernelConvs in column order: fixed, trainable."""
        fixed = self.fixed_kernelconv_set
        return [
            ([fixed[str(d)]] if str(d) in fixed else []) + [conv]
            for d, conv in enumerate(self.trainable_kernelconv_set)
        ]

    def block_widths(self) -> Tuple[int, int, int, int]:
        """Kernel-score columns per degree (fixed + trainable)."""
        return tuple(sum(c.num_kernels for c in convs)
                     for convs in self.degree_convs())

    def forward(
        self,
        x: torch.Tensor,  # [N, F] current node features
        p: torch.Tensor,  # [N, 3]
        buckets: Sequence[DegreeBucket],
        is_last_layer: bool = False,
        plans: Optional[list] = None,
    ) -> torch.Tensor:
        """``plans``: ``bucket_plans(buckets, N)`` for the gathers'
        gradients, if the caller has them."""
        n = x.shape[0]
        plans = plans or [(None, None)] * len(buckets)
        inputs = [
            dict(
                x_focal=take_rows(x, b.focal_index, plan=focal),
                p_focal=take_rows(p, b.focal_index),
                x_nei=take_rows(x, b.nei_index, plan=nei),
                p_nei=take_rows(p, b.nei_index),
                e_nei=b.nei_edge_attr,
                mask=b.mask,
                is_last_layer=is_last_layer,
            )
            for b, (focal, nei) in zip(buckets, plans)
        ]
        convs = self.degree_convs()

        # With the kernel on, every group of the layer (each degree's fixed
        # and trainable sets, which share the degree's A) is scored by ONE
        # launch.
        results = [[None] * len(c) for c in convs]
        if self.use_kernel:
            a_list, b_list = [], []
            for degree_convs, inp in zip(convs, inputs):
                a = degree_convs[0].support_a(inp["x_nei"])
                for conv in degree_convs:
                    a_list.append(a)
                    b_list.append(conv.support_b())
            flat = iter(grouped_support_score(a_list, b_list))
            results = [[next(flat) for _ in c] for c in convs]

        blocks = []
        for degree_convs, inp, res, b in zip(convs, inputs, results, buckets):
            scs = [conv(**inp, support_result=r)  # [M_d, L], 0 on padding
                   for conv, r in zip(degree_convs, res)]
            sc = scs[0] if len(scs) == 1 else torch.cat(scs, dim=1)
            # Node order: each node is the focal of at most one live row,
            # so this is a copy, not a sum. Padded rows (zero scores) are
            # sent to a dropped row n, where their equal zeros may land in
            # any order; no float atomics, and the gradient is a gather.
            block = sc.new_zeros((n + 1, sc.shape[1]))
            rows = torch.where(b.mask, b.focal_index.long(), n)
            blocks.append(block.index_copy_(0, rows, sc)[:n])
        out = torch.cat(blocks, dim=1)
        if self.psum_group is not None:
            out = all_reduce_sum(out, self.psum_group)
        if self.sow_scores and not (
            out.is_cuda and torch.cuda.is_current_stream_capturing()
        ):
            self.scores = out.detach()
        return out


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
        fixed_kernels: Optional[Sequence[Optional[dict]]] = None,
        sow_scores: bool = False,
        matmul_dtype: Optional[torch.dtype] = None,
        psum_group=None,
    ):
        super().__init__()
        self.psum_group = psum_group
        # Off = reference parity: the deg-4 chirality sign applies at the
        # last layer only; on, at every layer.
        self.chirality_every_layer = chirality_every_layer
        layers = []
        in_dim = node_dim
        for i in range(num_layers):
            # Fixed sets at layer 0 only: designed kernels live in the raw
            # node-feature space; deeper layers read score vectors.
            layer = KernelSetConv(
                num_kernels=kernels_1hop if i == 0 else kernels_nhop,
                node_dim=in_dim,
                edge_dim=edge_dim,
                pos_dim=pos_dim,
                use_kernel=use_kernel,
                generator=generator,
                fixed_kernels=fixed_kernels if i == 0 else None,
                sow_scores=sow_scores,
                matmul_dtype=matmul_dtype,
                psum_group=psum_group,
            )
            layers.append(layer)
            in_dim = sum(layer.block_widths())
        self.layers = nn.ModuleList(layers)
        self.out_dim = in_dim

    def forward(self, batch: GraphBatch, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        buckets = batch.buckets()
        # The batch's segment-sum plans (ops/segment.py), built once on its
        # device for every layer: the message passing's and, for the
        # gradients, its transpose and the buckets' gathers.
        edges = edge_plans(batch.edge_src, batch.edge_dst, x.shape[0],
                           batch.edge_mask, backward=torch.is_grad_enabled())
        gathers = bucket_plans(buckets, x.shape[0])
        for i, layer in enumerate(self.layers):
            sc = layer(
                h,
                batch.p,
                buckets,
                is_last_layer=self.chirality_every_layer or i == last,
                plans=gathers,
            )
            h = gather_scatter_add(
                sc,
                batch.edge_src,
                batch.edge_dst,
                num_nodes=sc.shape[0],
                edge_mask=batch.edge_mask,
                plans=edges,
            )
            if self.psum_group is not None:
                h = all_reduce_sum(h, self.psum_group)
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
        fixed_kernels: Optional[Sequence[Optional[dict]]] = None,
        sow_scores: bool = False,
        matmul_dtype: Optional[torch.dtype] = None,
        psum_group=None,
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
            fixed_kernels=fixed_kernels,
            sow_scores=sow_scores,
            matmul_dtype=matmul_dtype,
            psum_group=psum_group,
        )
        self.graph_embedding_lin1 = TorchLinear(
            self.gnn.out_dim, graph_embedding_dim, generator=generator
        )
        self.dropout = Dropout(drop_ratio)
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
        pool = (segment_plan(batch.node_graph_id, batch.num_graphs,
                             batch.node_mask) if planned(h) else None)
        return global_add_pool(
            h,
            batch.node_graph_id,
            num_graphs=batch.num_graphs,
            node_mask=batch.node_mask,
            plan=pool,
        )
