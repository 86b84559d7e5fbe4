"""Node-sharded model parallelism with halo exchange (torch.distributed).

Port of ``molkgnn_tpu/parallel/halo.py`` in PyTorch's idiom. The packed
batch's nodes are cut into contiguous shards, one a rank; each degree-bucket
row goes to the shard that owns its focal node and each edge to the shard
that owns its destination, and only the boundary rows move between ranks.

Wire protocol (tables built on the host by ``partition_halo``, static
shapes):

  * each shard references a static halo set: the remote nodes among its
    bucket neighbours and edge sources, grouped by owner and padded per
    (owner, requester) pair to a common ``Hp``;
  * ``send_ids[s, r, :]`` holds the owner-local rows shard ``s`` ships to
    requester ``r``. One all-to-all (``parallel/collectives.py::exchange``)
    moves the ``[S, Hp, C]`` send buffer; the rows received land at the
    extended coordinates ``Ns + r*Hp + k``, which is how the partitioner
    rewrote remote indices, so nothing is reordered after the exchange;
  * a layer makes two exchanges: the scores for aggregation, and the new
    features for the next layer (layer 0's features and every position are
    laid out in extended coordinates on the host).

Edges are split on the host into local-source and halo-source groups. The
score exchange is started asynchronously before the local scatter-add and
waited on before the halo-edge scatter, the port's form of the JAX
package's dependence split.

A rank's forward drives the model's own modules (``node_batch_norm``,
``gnn.layers[i]``, ``graph_embedding_lin1``/``2``, the ``GNNModel``'s
``ffn``), so no weight is copied and the scorer kernel runs through
``KernelSetConv`` as on one device: one grouped launch a layer on each rank.
Train-mode BatchNorm takes global masked statistics, two-pass (the mean
all-reduced first, then the centred second moment), with the unbiased
running update of ``ops/norm.py``. The pooled embeddings are summed over
the shards by a differentiable all-reduce whose backward sums the
cotangents, so every shard's encoder gradient is ``S`` times its partial
and the mean of the shards' gradients (``GradSync`` with divisor ``S``) is
the whole batch's gradient; the head's gradients are equal full copies on
every shard. The loss is the same on every shard.

Device-fed steps (``sampled_halo_batch``): every shard draws the same
global ids (the single-device sampler's stream), takes its ``B / S``
molecules and assembles them on the device; whole molecules share no edge,
so the cut is empty (``local_halo``: ``hp = 1`` placeholder rows, all
masked). ``y`` and ``graph_mask`` are those of the global ids, what the
JAX package all-gathers.

Not kept from the JAX package: its halo forward builds its layers without
fixed kernel sets and applies the degree-4 chirality sign at the last layer
only; here a model with fixed sets or ``chirality_every_layer`` is refused
(``check_model``). Per-node dropout draws the same stream on every shard
(the rows differ); results are held against one device with dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch
from molkgnn_torch.models.common import swish
from molkgnn_torch.ops.segment import (
    bucket_plans,
    edge_plans,
    gather_scatter_add,
    global_add_pool,
    planned,
    segment_plan,
    take_rows,
)
from molkgnn_torch.parallel.collectives import all_reduce_sum, exchange
from molkgnn_torch.parallel.data_parallel import AXIS, GradSync
from molkgnn_torch.training.optim import fill_missing_grads

# Placeholder halo-edge rows of an empty cut (all masked).
EMPTY_CUT_EDGES = 8


def _round_up(x: int, m: int) -> int:
    return ((max(int(x), 1) + m - 1) // m) * m


@dataclasses.dataclass
class HaloBatch:
    """A partitioned batch. From ``partition_halo``: numpy arrays whose
    leading axis is the shard (``partition_hybrid``: two leading axes,
    data group and shard); ``shard`` gives one shard's tensors, the leading
    axes dropped.

    ``edge_*_local`` sources are owner-local rows (< Ns); ``edge_*_halo``
    sources index the score exchange's receive buffer (S*Hp rows)."""

    x_ext: object  # [S, Next, F] owned rows then halo rows (layer-0 x)
    p_ext: object  # [S, Next, 3]
    node_mask: object  # [S, Ns]
    node_graph_id: object  # [S, Ns]
    send_ids: object  # [S, S, Hp] owner-local rows shipped per requester
    edge_src_local: object  # [S, El]
    edge_dst_local: object  # [S, El]
    edge_mask_local: object  # [S, El]
    edge_src_halo: object  # [S, Eh] receive-buffer rows
    edge_dst_halo: object  # [S, Eh] owner-local rows
    edge_mask_halo: object  # [S, Eh]
    deg1: DegreeBucket  # focal owner-local, neighbours extended
    deg2: DegreeBucket
    deg3: DegreeBucket
    deg4: DegreeBucket
    y: object  # [S, B] replicated
    graph_mask: object  # [S, B]
    # The raw bond features behind the dead edge-BatchNorm's statistics
    # (``MolKGNNNet``'s doc).
    edge_attr: object  # [S, E, Fe]
    edge_attr_mask: object  # [S, E]

    def buckets(self):
        return (self.deg1, self.deg2, self.deg3, self.deg4)

    @property
    def num_shards(self) -> int:
        return self.send_ids.shape[-2]

    @property
    def nodes_per_shard(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def halo_per_pair(self) -> int:
        return self.send_ids.shape[-1]

    def caps(self) -> dict:
        """Static capacities: ``partition_halo(caps=...)`` pins later
        batches to these shapes."""
        return {
            "ns": int(self.node_mask.shape[-1]),
            "hp": int(self.send_ids.shape[-1]),
            "el": int(self.edge_src_local.shape[-1]),
            "eh": int(self.edge_src_halo.shape[-1]),
            "buckets": tuple(int(b.mask.shape[-1]) for b in self.buckets()),
        }

    def shard(self, index, device="cpu",
              dtype: Optional[torch.dtype] = None) -> "HaloBatch":
        """Shard ``index`` (an int, or ``(data group, shard)``) as tensors
        on ``device``, float fields in ``dtype`` (default float32)."""
        dtype = dtype or torch.float32

        def take(a):
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[index]))
            if t.is_floating_point():
                t = t.to(dtype)
            return t.to(device)

        def walk(v):
            if isinstance(v, DegreeBucket):
                return DegreeBucket(*(take(getattr(v, f.name))
                                      for f in dataclasses.fields(v)))
            return take(v)

        return HaloBatch(**{f.name: walk(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def _pick(needed: int, caps: Optional[dict], key: str) -> int:
    if caps is None:
        return _round_up(needed, 8)
    cap = int(caps[key])
    if needed > cap:
        raise ValueError(
            f"partition_halo: pinned cap {key}={cap} overflowed "
            f"(needs {needed}); widen the caps"
        )
    return cap


def partition_halo(
    batch: GraphBatch, n_shards: int, caps: Optional[dict] = None
) -> HaloBatch:
    """Host partitioner: contiguous node shards and static halo tables,
    numpy, the JAX package's arrays bit for bit. With ``caps`` (from
    ``HaloBatch.caps()``) every array gets the pinned shape; an overflow
    raises ``ValueError``."""
    x = np.asarray(batch.x)
    p = np.asarray(batch.p)
    node_mask = np.asarray(batch.node_mask)
    n = x.shape[0]
    ns = (
        int(caps["ns"])
        if caps is not None
        else _round_up(-(-n // n_shards), 8)
    )
    if ns * n_shards < n:
        raise ValueError(
            f"partition_halo: pinned ns={ns} too small for {n} nodes "
            f"on {n_shards} shards"
        )
    n_pad = ns * n_shards

    def pad_rows(a, rows):
        if a.shape[0] >= rows:
            return a[:rows]
        pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])

    x = pad_rows(x, n_pad)
    p = pad_rows(p, n_pad)
    node_mask = pad_rows(node_mask, n_pad)
    node_graph_id = pad_rows(np.asarray(batch.node_graph_id), n_pad)

    esrc = np.asarray(batch.edge_src, np.int64)
    edst = np.asarray(batch.edge_dst, np.int64)
    emask = np.asarray(batch.edge_mask, bool)
    e_owner_dst = edst // ns
    e_owner_src = esrc // ns

    # Per shard: its work rows and the remote rows they reference.
    shard_edges_local = []  # (src, dst) owner-local
    shard_edges_halo = []  # (src global, dst owner-local)
    shard_buckets = []  # per shard, per degree: (focal, nei, ea) real rows
    req_lists = [[None] * n_shards for _ in range(n_shards)]
    for s in range(n_shards):
        sel = emask & (e_owner_dst == s)
        loc = sel & (e_owner_src == s)
        rem = sel & (e_owner_src != s)
        shard_edges_local.append((esrc[loc] - s * ns, edst[loc] - s * ns))
        shard_edges_halo.append((esrc[rem], edst[rem] - s * ns))
        refs = [esrc[rem]]

        per_deg = []
        for b in batch.buckets():
            mask = np.asarray(b.mask, bool)
            focal = np.asarray(b.focal_index, np.int64)
            bsel = mask & (focal // ns == s)
            nei = np.asarray(b.nei_index, np.int64)[bsel]
            per_deg.append(
                (focal[bsel], nei, np.asarray(b.nei_edge_attr)[bsel])
            )
            flat = nei.ravel()
            refs.append(flat[flat // ns != s])
        shard_buckets.append(per_deg)

        remote = np.unique(np.concatenate(refs))
        owners = remote // ns
        for r in range(n_shards):
            req_lists[s][r] = remote[owners == r].astype(np.int64)

    hp = _pick(
        max(len(req_lists[s][r]) for s in range(n_shards)
            for r in range(n_shards)),
        caps,
        "hp",
    )

    # send_ids[owner s][requester r]: owner-local rows (0-padded).
    send_ids = np.zeros((n_shards, n_shards, hp), np.int32)
    for s in range(n_shards):
        for r in range(n_shards):
            ids = req_lists[r][s]  # r requests from s
            send_ids[s, r, : len(ids)] = ids - s * ns

    # Per shard: global row -> extended coordinate.
    next_rows = ns + n_shards * hp
    luts = np.full((n_shards, n_pad), -1, np.int64)
    for s in range(n_shards):
        luts[s, s * ns : (s + 1) * ns] = np.arange(ns)
        for r in range(n_shards):
            ids = req_lists[s][r]
            luts[s, ids] = ns + r * hp + np.arange(len(ids))

    el_cap = _pick(max(len(e[0]) for e in shard_edges_local), caps, "el")
    eh_cap = _pick(max(len(e[0]) for e in shard_edges_halo), caps, "eh")
    el_src = np.zeros((n_shards, el_cap), np.int32)
    el_dst = np.zeros((n_shards, el_cap), np.int32)
    el_mask = np.zeros((n_shards, el_cap), bool)
    eh_src = np.zeros((n_shards, eh_cap), np.int32)
    eh_dst = np.zeros((n_shards, eh_cap), np.int32)
    eh_mask = np.zeros((n_shards, eh_cap), bool)
    for s in range(n_shards):
        src_l, dst_l = shard_edges_local[s]
        k = len(src_l)
        el_src[s, :k] = src_l
        el_dst[s, :k] = dst_l
        el_mask[s, :k] = True
        src_h, dst_h = shard_edges_halo[s]
        k = len(src_h)
        eh_src[s, :k] = luts[s, src_h] - ns  # receive-buffer rows
        eh_dst[s, :k] = dst_h
        eh_mask[s, :k] = True

    fe = np.asarray(batch.deg1.nei_edge_attr).shape[-1]
    buckets_out = []
    for d in range(4):
        need = max(len(shard_buckets[s][d][0]) for s in range(n_shards))
        if caps is None:
            cap = _round_up(need, 8)
        else:
            cap = int(caps["buckets"][d])
            if need > cap:
                raise ValueError(
                    f"partition_halo: pinned bucket cap deg{d + 1}={cap} "
                    f"overflowed (needs {need})"
                )
        focal = np.zeros((n_shards, cap), np.int32)
        nei = np.zeros((n_shards, cap, d + 1), np.int32)
        ea = np.zeros((n_shards, cap, d + 1, fe), np.float32)
        mask = np.zeros((n_shards, cap), bool)
        for s in range(n_shards):
            f, nn_, e = shard_buckets[s][d]
            k = len(f)
            focal[s, :k] = f - s * ns
            nei[s, :k] = luts[s, nn_]
            ea[s, :k] = e
            mask[s, :k] = True
        buckets_out.append(DegreeBucket(
            focal_index=focal, nei_index=nei, nei_edge_attr=ea, mask=mask))

    x_ext = np.zeros((n_shards, next_rows, x.shape[1]), np.float32)
    p_ext = np.zeros((n_shards, next_rows, p.shape[1]), np.float32)
    for s in range(n_shards):
        x_ext[s, :ns] = x[s * ns : (s + 1) * ns]
        p_ext[s, :ns] = p[s * ns : (s + 1) * ns]
        for r in range(n_shards):
            ids = req_lists[s][r]
            if len(ids):
                x_ext[s, ns + r * hp : ns + r * hp + len(ids)] = x[ids]
                p_ext[s, ns + r * hp : ns + r * hp + len(ids)] = p[ids]

    def rep(a):
        a = np.asarray(a)
        return np.broadcast_to(a[None], (n_shards,) + a.shape).copy()

    return HaloBatch(
        x_ext=x_ext,
        p_ext=p_ext,
        node_mask=node_mask.reshape(n_shards, ns),
        node_graph_id=node_graph_id.reshape(n_shards, ns),
        send_ids=send_ids,
        edge_src_local=el_src,
        edge_dst_local=el_dst,
        edge_mask_local=el_mask,
        edge_src_halo=eh_src,
        edge_dst_halo=eh_dst,
        edge_mask_halo=eh_mask,
        deg1=buckets_out[0],
        deg2=buckets_out[1],
        deg3=buckets_out[2],
        deg4=buckets_out[3],
        y=rep(batch.y),
        graph_mask=rep(batch.graph_mask),
        edge_attr=rep(batch.edge_attr),
        edge_attr_mask=rep(batch.edge_mask),
    )


def halo_stats(hb: HaloBatch) -> dict:
    """Communication accounting: rows an exchange moves against the rows a
    replicated layout would, and the local/halo edge split."""
    return {
        "nodes_per_shard": hb.nodes_per_shard,
        "halo_rows_per_exchange": int(hb.num_shards * hb.halo_per_pair),
        "replicated_alternative_rows": int(
            hb.num_shards * hb.nodes_per_shard
        ),
        "local_edges": int(np.asarray(hb.edge_mask_local).sum()),
        "halo_edges": int(np.asarray(hb.edge_mask_halo).sum()),
    }


# ---------------------------------------------------------------- forward


@dataclasses.dataclass
class HaloGroups:
    """One rank's process groups in a model-parallel mesh.

    ``model``: the shards of one batch (the exchanges, the pooled sum);
    ``n_model`` shards, this rank's ``index`` among them. ``bn``: the
    node BatchNorm statistics' group (every rank of a hybrid mesh).
    ``edge_bn``: the dead edge BatchNorm's (None: the local statistics are
    already global). ``data``: the data groups of a hybrid mesh (the
    loss's graph count), None for halo."""

    model: object
    n_model: int
    index: int
    bn: object
    edge_bn: object = None
    data: object = None


def halo_groups(mesh, sampled: bool = False) -> HaloGroups:
    """The groups of ``model_parallel="halo"`` on a one-dimensional mesh:
    every rank a shard of one batch. ``sampled``: device-fed batches, whose
    shards own distinct edges (their edge statistics are summed)."""
    if mesh.ndim != 1:
        raise ValueError(
            "model_parallel='halo' needs a one-dimensional mesh (make_mesh);"
            f" got dimensions {mesh.mesh_dim_names}")
    group = mesh.get_group(AXIS)
    return HaloGroups(model=group, n_model=mesh.size(),
                      index=mesh.get_local_rank(AXIS), bn=group,
                      edge_bn=group if sampled else None)


def check_model(encoder) -> None:
    """Refuse what the halo forward does not keep (see the module doc)."""
    gnn = encoder.gnn
    if gnn.chirality_every_layer:
        raise ValueError(
            "model parallelism applies the chirality sign at the last layer "
            "only, as the JAX package's halo forward does; a model with "
            "chirality_every_layer is refused")
    if any(len(layer.fixed_kernelconv_set) for layer in gnn.layers):
        raise ValueError(
            "model parallelism runs the trainable kernel sets only, as the "
            "JAX package's halo forward does; a model with fixed kernel "
            "sets is refused")


@torch.no_grad()
def _masked_stats(x, mask, group):
    """(mean, biased variance, count) of the rows of ``x`` where ``mask``,
    summed over ``group`` (None: local), two-pass as ``ops/norm.py``."""
    m = mask.to(x.dtype)[:, None]
    s1 = torch.cat([(x * m).sum(0), m.sum()[None]])
    if group is not None:
        dist.all_reduce(s1, group=group)
    count = torch.clamp(s1[-1], min=1.0)
    mean = s1[:-1] / count
    s2 = (((x - mean) ** 2) * m).sum(0)
    if group is not None:
        dist.all_reduce(s2, group=group)
    return mean, s2 / count, count


@torch.no_grad()
def _update_running(bn, mean, var, count) -> None:
    """``MaskedBatchNorm``'s running update from global statistics."""
    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
    bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
    bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)


def _affine(bn, mean, var, x):
    inv_std = torch.reciprocal(torch.sqrt(var + bn.eps))
    return (x - mean) * inv_std * bn.weight + bn.bias


def encoder_forward(encoder, hb: HaloBatch, groups: HaloGroups,
                    train: bool) -> torch.Tensor:
    """One rank's ``MolKGNNNet`` forward on its shard ``hb`` (tensors):
    the pooled embeddings [B, H], summed over the shards. In train mode the
    BatchNorm running statistics are updated from global statistics."""
    ns = hb.node_mask.shape[0]
    world = groups.n_model

    # The segment-sum plans (ops/segment.py) of the local and halo edge
    # sets, of the shipped rows' gather and of the buckets' gathers, built
    # once per forward. The halo plan's transpose sums into the received
    # rows, [S * Hp].
    grad = torch.is_grad_enabled()
    local_plans = edge_plans(hb.edge_src_local, hb.edge_dst_local, ns,
                             hb.edge_mask_local, backward=grad)
    halo_plans = edge_plans(hb.edge_src_halo, hb.edge_dst_halo, ns,
                            hb.edge_mask_halo, backward=grad,
                            num_src=hb.send_ids.numel())
    send_plan = (segment_plan(hb.send_ids, ns)
                 if grad and planned(hb.send_ids) else None)
    buckets = hb.buckets()
    gathers = bucket_plans(buckets, hb.x_ext.shape[0])

    def send(v):  # [Ns, C] -> the rows to ship, [S, Hp, C]
        return take_rows(v, hb.send_ids, plan=send_plan)

    nbn = encoder.node_batch_norm
    if train:
        # Halo rows copy rows owned elsewhere, so the global affine
        # normalises them as one device would; layer 0 needs no exchange.
        mean, var, count = _masked_stats(hb.x_ext[:ns], hb.node_mask,
                                         groups.bn)
        _update_running(nbn, mean, var, count)
        _update_running(encoder.edge_batch_norm, *_masked_stats(
            hb.edge_attr, hb.edge_attr_mask, groups.edge_bn))
    else:
        mean, var = nbn.running_mean, nbn.running_var
    h_ext = _affine(nbn, mean, var, hb.x_ext)

    layers = encoder.gnn.layers
    for i, layer in enumerate(layers):
        # [Next, C]; rows past Ns are zero (no focal row of this shard).
        sc_own = layer(h_ext, hb.p_ext, buckets,
                       is_last_layer=i == len(layers) - 1,
                       plans=gathers)[:ns]
        pending = []
        recv = exchange(send(sc_own), groups.model, pending)
        # The local edges do not read the exchange: it runs meanwhile.
        h_local = gather_scatter_add(
            sc_own, hb.edge_src_local, hb.edge_dst_local, num_nodes=ns,
            edge_mask=hb.edge_mask_local, plans=local_plans)
        pending[0].wait()
        h_local = h_local + gather_scatter_add(
            recv.reshape(world * recv.shape[1], -1), hb.edge_src_halo,
            hb.edge_dst_halo, num_nodes=ns, edge_mask=hb.edge_mask_halo,
            plans=halo_plans)
        if i < len(layers) - 1:
            halo = exchange(send(h_local), groups.model)
            h_ext = torch.cat([h_local, halo.reshape(-1, h_local.shape[1])])

    h = swish(encoder.graph_embedding_lin1(h_local))
    h = encoder.graph_embedding_lin2(encoder.dropout(h))
    pooled = global_add_pool(h, hb.node_graph_id,
                             num_graphs=hb.y.shape[-1],
                             node_mask=hb.node_mask)
    return all_reduce_sum(pooled, groups.model)


def model_forward(model, hb: HaloBatch, groups: HaloGroups, train: bool):
    """(logits [B], pooled embeddings [B, H]) of a ``GNNModel`` on this
    rank's shard: the encoder's sharded forward, then the head (its dropout
    draws the same mask on every shard, whose generators agree)."""
    model.train(train)
    pooled = encoder_forward(model.gnn_model, hb, groups, train)
    return model.ffn(model.dropout(pooled))[..., 0], pooled


def halo_loss(model, loss_fn, hb: HaloBatch, groups: HaloGroups):
    """The train-mode loss of this rank's shard: the whole batch's loss,
    the same on every shard of a batch. Under a hybrid mesh
    (``groups.data``), the group's masked mean re-weighted by its share of
    the global graph count, so that the sum over data groups is the global
    masked mean (``loss_fn`` must be a masked mean)."""
    logits, _ = model_forward(model, hb, groups, train=True)
    loss = loss_fn(logits, hb.y, hb.graph_mask)
    if groups.data is None:
        return loss
    with torch.no_grad():
        cnt = hb.graph_mask.to(loss.dtype).sum()
        total = cnt.clone()
        dist.all_reduce(total, group=groups.data)
        weight = cnt / torch.clamp(total, min=1.0)
    return loss * weight


def local_halo(local: GraphBatch, n_shards: int, graph_offset: int,
               y: torch.Tensor, graph_mask: torch.Tensor,
               hp: int = 1) -> HaloBatch:
    """A molecule-aligned shard from this rank's sub-batch ``local``
    (assembled on the device): the cut is empty, every edge and bucket row
    is local, and the exchanges move ``hp`` masked placeholder rows a
    pair. ``graph_offset`` maps the local graph ids into the batch's;
    ``y``/``graph_mask`` are the whole batch's [B]."""
    def ext(a):
        return torch.cat([a, a.new_zeros((n_shards * hp, a.shape[1]))])

    index = local.edge_src.new_zeros
    return HaloBatch(
        x_ext=ext(local.x),
        p_ext=ext(local.p),
        node_mask=local.node_mask,
        node_graph_id=local.node_graph_id + graph_offset,
        send_ids=index((n_shards, hp)),
        edge_src_local=local.edge_src,
        edge_dst_local=local.edge_dst,
        edge_mask_local=local.edge_mask,
        edge_src_halo=index((EMPTY_CUT_EDGES,)),
        edge_dst_halo=index((EMPTY_CUT_EDGES,)),
        edge_mask_halo=local.edge_mask.new_zeros((EMPTY_CUT_EDGES,)),
        deg1=local.deg1,
        deg2=local.deg2,
        deg3=local.deg3,
        deg4=local.deg4,
        y=y,
        graph_mask=graph_mask,
        edge_attr=local.edge_attr,
        edge_attr_mask=local.edge_mask,
    )


def sampled_halo_batch(data, ids: torch.Tensor, shard_spec, gather,
                       n_shards: int, index: int) -> HaloBatch:
    """The device-fed shard ``index`` of the batch of graph ids ``ids``
    [B] (-1 padded): its ``B / n_shards`` molecules assembled by
    ``gather(data, ids, shard_spec)`` and wrapped by ``local_halo``."""
    per = ids.shape[0] // n_shards
    local = gather(data, ids[index * per:(index + 1) * per], shard_spec)
    valid = ids >= 0
    y = torch.where(valid, data.y[torch.where(valid, ids, 0)], 0.0)
    return local_halo(local, n_shards, index * per, y, valid)


# ------------------------------------------------------------ entry points


def halo_parallel_forward(encoder, hb: HaloBatch, mesh) -> torch.Tensor:
    """Eval-mode encoder forward of a ``partition_halo`` batch over the
    one-dimensional ``mesh`` (this rank takes its shard): the pooled
    embeddings [B, H], the same on every rank."""
    groups = halo_groups(mesh)
    param = next(encoder.parameters())
    with torch.no_grad():
        encoder.eval()
        return encoder_forward(
            encoder, hb.shard(groups.index, param.device, param.dtype),
            groups, train=False)


def halo_eval_step(model, hb: HaloBatch, mesh) -> torch.Tensor:
    """Eval-mode ``GNNModel`` logits [B] of a ``partition_halo`` batch over
    ``mesh`` (running statistics, no dropout), the same on every rank."""
    groups = halo_groups(mesh)
    param = next(model.parameters())
    with torch.no_grad():
        return model_forward(
            model, hb.shard(groups.index, param.device, param.dtype),
            groups, train=False)[0]


def halo_train_step(model, optimizer, mesh, loss_fn):
    """A train step over ``mesh``: ``step(hb, lr) -> loss`` takes a
    ``partition_halo`` batch and a learning rate (0-dim tensor) and runs
    train-mode BatchNorm with global statistics, the loss, the backward
    through both exchanges of every layer, the mean of the shards'
    gradients and one ``optimizer`` (``training/optim.py::AdamW``) update.
    The ``Trainer`` runs the same step with its schedule, clipping and
    skipping."""
    groups = halo_groups(mesh)
    return train_step(model, optimizer, mesh, loss_fn, groups,
                      lambda hb, p: hb.shard(groups.index, p.device,
                                             p.dtype))


def train_step(model, optimizer, mesh, loss_fn, groups: HaloGroups, mine):
    """``step(hb, lr) -> loss`` of ``halo_train_step`` and
    ``hybrid.hybrid_train_step``: ``mine(hb, param)`` is this rank's shard
    of ``hb`` on ``param``'s device and dtype."""
    sync = GradSync(mesh, optimizer.params, [], divisor=groups.n_model)

    def step(hb: HaloBatch, lr: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad()
        loss = halo_loss(model, loss_fn, mine(hb, optimizer.params[0]),
                         groups)
        loss.backward()
        fill_missing_grads(optimizer.params)
        loss = sync(loss.detach())
        optimizer.step(lr)
        return loss

    return step
