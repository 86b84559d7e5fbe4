"""Data groups x halo model parallelism on a two-dimensional mesh.

Port of ``molkgnn_tpu/parallel/hybrid.py``. ``make_mesh_2d(nd, nm)`` is a
``DeviceMesh`` with dimensions ``("data", "model")``; rank ``r`` sits at
``(r // nm, r % nm)``, as the JAX package's ``devices.reshape(nd, nm)``:

  * the global batch is ``nd`` groups of graphs, one a row of the mesh;
    groups never communicate except in the gradient and statistics
    reductions;
  * each group's batch is node-sharded over its row's ``nm`` ranks
    (``parallel/halo.py``), the exchanges and the pooled sum on the row's
    ``"model"`` group.

A train step's collectives: two exchanges a layer within a row; the node
BatchNorm statistics summed over every rank; for the dead edge BatchNorm,
over the ``"data"`` group (host-fed batches, whose edge features each row
holds whole) or every rank (device-fed, each rank its own edges); the
pooled sum within a row; one flat all-reduce of the gradients over every
rank divided by ``nm`` (``GradSync``), which is
``psum(pmean(grads, model), data)``. The objective is the masked mean over
every graph of the global batch: each group's loss enters as its masked
mean times its share of the global count, a plain sum over the groups.

Device-fed steps: each data group draws its own ids (the sampler's seed
from ``(seed, salt, data index)``, so the ranks of a row agree) and each
rank assembles its ``B / nm`` molecules (``halo.sampled_halo_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from molkgnn_torch.graphs.batch import GraphBatch
from molkgnn_torch.parallel.halo import (
    HaloBatch,
    HaloGroups,
    encoder_forward,
    model_forward,
    partition_halo,
    train_step,
)

DIMS = ("data", "model")


def make_mesh_2d(
    n_data: int,
    n_model: int,
    device: Optional[str | torch.device] = None,
    backend: Optional[str] = None,
):
    """A ``DeviceMesh`` of ``n_data x n_model`` ranks with dimensions
    ``("data", "model")`` over the world (``make_mesh``'s set-up and
    checks; a world of one is set up in this process)."""
    from torch.distributed.device_mesh import init_device_mesh

    from molkgnn_torch.parallel.data_parallel import join_world

    device = join_world(n_data * n_model, device, backend,
                        f"make_mesh_2d({n_data}, {n_model})")
    return init_device_mesh(device.type, (n_data, n_model),
                            mesh_dim_names=DIMS)


def hybrid_groups(mesh, sampled: bool = False) -> HaloGroups:
    """This rank's groups on a ``make_mesh_2d`` mesh; ``sampled``:
    device-fed batches (see the module doc)."""
    if tuple(mesh.mesh_dim_names or ()) != DIMS:
        raise ValueError(
            "model_parallel='hybrid' needs a 2D mesh with dimensions "
            f"('data', 'model'); got {mesh.mesh_dim_names}")
    data = mesh.get_group("data")
    return HaloGroups(
        model=mesh.get_group("model"), n_model=mesh.shape[1],
        index=mesh.get_local_rank("model"), bn=dist.group.WORLD,
        edge_bn=dist.group.WORLD if sampled else data, data=data)


def _stack(parts: Sequence):
    """Stack dataclass trees (``HaloBatch``, ``DegreeBucket``) leaf by
    leaf along a new leading axis."""
    first = parts[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _stack([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)})
    return np.stack([np.asarray(p) for p in parts])


def union_caps(a: dict, b: dict) -> dict:
    """The larger of two ``HaloBatch.caps()``, key by key."""
    return {k: (tuple(max(x, y) for x, y in zip(a[k], b[k]))
                if k == "buckets" else max(a[k], b[k])) for k in a}


def partition_hybrid(
    groups: List[GraphBatch], n_model: int, caps: Optional[dict] = None
) -> HaloBatch:
    """Partition each data group's batch over ``n_model`` shards and
    stack: arrays with leading ``[n_data, n_model]`` axes. Every group
    takes one set of capacities: ``caps``, else the largest over the
    groups."""
    if caps is None:
        for g in groups:
            c = partition_halo(g, n_model).caps()
            caps = c if caps is None else union_caps(caps, c)
    return _stack([partition_halo(g, n_model, caps=caps) for g in groups])


def _mine(hb: HaloBatch, mesh, like: torch.Tensor) -> HaloBatch:
    return hb.shard((mesh.get_local_rank("data"),
                     mesh.get_local_rank("model")), like.device, like.dtype)


def gather_groups(x: torch.Tensor, groups: HaloGroups) -> torch.Tensor:
    """[nd, ...]: ``x`` of every data group, in group order."""
    n = dist.get_world_size(groups.data)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=groups.data)
    return torch.stack(parts)


def hybrid_parallel_forward(encoder, hb: HaloBatch, mesh) -> torch.Tensor:
    """Eval-mode encoder forward of a ``partition_hybrid`` batch over
    ``mesh``: every group's pooled embeddings [nd, B, H], the same on every
    rank."""
    groups = hybrid_groups(mesh)
    with torch.no_grad():
        encoder.eval()
        pooled = encoder_forward(
            encoder, _mine(hb, mesh, next(encoder.parameters())), groups,
            train=False)
        return gather_groups(pooled, groups)


def hybrid_eval_step(model, hb: HaloBatch, mesh) -> torch.Tensor:
    """Eval-mode ``GNNModel`` logits [nd, B] of a ``partition_hybrid``
    batch over ``mesh``: ``nd`` batches at once, each node-sharded over its
    row; the same on every rank."""
    groups = hybrid_groups(mesh)
    with torch.no_grad():
        logits = model_forward(
            model, _mine(hb, mesh, next(model.parameters())), groups,
            train=False)[0]
        return gather_groups(logits, groups)


def hybrid_train_step(model, optimizer, mesh, loss_fn):
    """A train step over the 2D ``mesh``: ``step(hb, lr) -> loss`` on a
    ``partition_hybrid`` batch, with one device's semantics on the
    undivided global batch (global BatchNorm statistics, the masked mean
    over every graph, gradients through every exchange, one update of
    ``optimizer``); ``loss_fn`` must be a masked mean."""
    return train_step(model, optimizer, mesh, loss_fn, hybrid_groups(mesh),
                      lambda hb, p: _mine(hb, mesh, p))
