"""Data parallelism over a one-dimensional device mesh (torch.distributed).

Port of ``molkgnn_tpu/parallel/data_parallel.py`` in PyTorch's idiom: one
process a device, ``torch.distributed`` with NCCL on the card and gloo on
the CPU, and a ``DeviceMesh`` with one dimension named ``"data"`` as the
counterpart of the JAX ``Mesh``. The state is replicated on every rank and
each rank trains on its own padded sub-batch:

  * ``make_mesh``: the mesh over the whole world (a world of one is set up
    in the process itself when no process group exists);
  * ``GradSync``: the train step's collective. After the backward, one
    all-reduce (SUM, then divided by the world size) of a flat buffer that
    holds every gradient, the BatchNorm running statistics after the
    step's own update, and the loss: the JAX step's ``pmean`` of its
    gradients, of its ``batch_stats`` updates and of its loss. The buffer
    is allocated once, so a captured step records one collective.
    ``DistributedDataParallel`` is not used: its ``broadcast_buffers``
    copies rank 0's statistics where the JAX step averages them, and its
    bucket hooks stand in the way of capturing the whole step as a CUDA
    graph;
  * ``rank_rows``: the rows of a ``[S, ...]`` stack (the epoch's id
    batches, or the host loader's batches) that this rank trains on: the
    JAX ``reshape(G, ndev, B)[:, rank]`` with the trailing sub-``ndev``
    group dropped (``molkgnn_tpu/training/trainer.py:1225-1265``);
  * ``sampler_seed``: each rank's device-sampler seed, from
    ``(seed, salt, rank)`` (the JAX sampler folds in ``axis_index``);
  * ``score_blocks``: the block sharding of evaluation and screening. The
    ``[S, B]`` id blocks are padded with all ``-1`` blocks to a multiple of
    the world size, block ``j`` is scored on rank ``j % world`` (the JAX
    ``feed.reshape(K, nd, B)`` under ``P(None, "data")``), and the scores
    come back by ``all_gather`` in block order, padding dropped: every rank
    returns the same ``[S, B]``.

Nothing here starts a process; ``parallel/launch.py`` does, and
``parallel/multihost.py`` joins a world that a launcher started.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXIS = "data"


def is_writer() -> bool:
    """True where this process writes the run's files: everywhere without
    a process group, else on rank 0 alone (the state is replicated)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def cuda_index(backend: str) -> int:
    """The card of this process: ``LOCAL_RANK`` (else the rank) among the
    machine's cards. NCCL needs a card a rank and raises where there are
    too few; ranks of an explicit gloo world may share one."""
    count = torch.cuda.device_count()
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl" and local >= count:
        raise ValueError(
            f"rank {rank} (local rank {local}) needs its own CUDA device "
            f"for NCCL; this machine has {count}"
        )
    return local % count


def make_mesh(
    n: Optional[int] = None,
    device: Optional[str | torch.device] = None,
    backend: Optional[str] = None,
):
    """A ``DeviceMesh`` with one dimension ``"data"`` over every rank of
    the world, on ``device``'s type (default the card; raises without one).

    ``backend`` defaults to NCCL on the card and gloo on the CPU; gloo on
    the card is taken only where it is asked for by name. Without a process
    group, ``n`` must be 1 (or None) and a world of one is set up in this
    process; a larger world is started by ``parallel/launch.py`` or a
    launcher (``multihost.initialize``). ``n`` other than the world's size
    raises, as does a process group of another backend."""
    from torch.distributed.device_mesh import init_device_mesh

    device = join_world(n, device, backend, f"make_mesh({n})")
    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


def join_world(n: Optional[int], device, backend: Optional[str],
               what: str) -> torch.device:
    """The checks and set-up of ``make_mesh`` (see there) for a mesh of
    ``n`` ranks (None: the world's); returns the device."""
    from molkgnn_torch.serving.predictor import resolve_device

    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs CUDA tensors; use gloo on the CPU")
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"{what}: no process group; start {n} processes "
                "(parallel/launch.py, or torch.distributed.run) and join "
                "them (multihost.initialize) first"
            )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"{what} in a world of {world} processes")
    have = dist.get_backend()
    if have != backend:
        raise ValueError(
            f"the process group runs {have}; this mesh asks for {backend}"
        )
    if device.type == "cuda":
        torch.cuda.set_device(cuda_index(backend))
    return device


def mesh_rank(mesh) -> tuple[int, int]:
    """(world size, this rank) of a mesh over the world."""
    return mesh.size(), mesh.get_rank()


def world_group(mesh):
    """The process group of every rank of ``mesh`` (which spans the
    world): its one dimension's, or the default group's."""
    return mesh.get_group(AXIS) if mesh.ndim == 1 else dist.group.WORLD


def batch_norm_buffers(model: nn.Module) -> List[torch.Tensor]:
    """The BatchNorm running statistics of ``model`` (``ops/norm.py``), in
    module order: the JAX ``batch_stats`` collection."""
    from molkgnn_torch.ops.norm import MaskedBatchNorm

    return [t for m in model.modules() if isinstance(m, MaskedBatchNorm)
            for t in (m.running_mean, m.running_var)]


class GradSync:
    """The data-parallel collective of a train step (see the module doc).

    ``sync(loss)`` replaces every parameter's gradient and every BatchNorm
    statistic by its sum over every rank of the mesh divided by
    ``divisor`` (default the rank count: the mean), and returns the loss so
    reduced (a new tensor). Gradients must exist
    (``optim.fill_missing_grads``). The flat buffer is made here, before
    any capture; parameters and statistics share one dtype (a model in
    float32, or in float64 for parity).

    Model parallelism passes no statistics (its BatchNorm statistics are
    global already) and divides by the shards of a batch: ``S`` shards'
    gradients (each ``S`` times its partial, ``parallel/halo.py``) summed
    over a world of ``D`` data groups of ``S`` and divided by ``S`` are
    ``psum(pmean(g, model), data)``, and the loss, a data group's share on
    each of its shards, sums to the global loss the same way."""

    def __init__(self, mesh, params: Sequence[nn.Parameter],
                 buffers: Sequence[torch.Tensor],
                 divisor: Optional[int] = None):
        self.group = world_group(mesh)
        self.world = mesh.size()
        self.divisor = divisor or self.world
        self.params = list(params)
        self.buffers = list(buffers)
        tensors = self.params + self.buffers
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"parameters and statistics of dtypes {dtypes}"
                             "; GradSync keeps one flat buffer of one dtype")
        # A slot per gradient, per statistic, and the loss's last.
        shapes = [t.shape for t in tensors] + [torch.Size(())]
        self.flat = torch.zeros(sum(s.numel() for s in shapes),
                                dtype=dtypes.pop(), device=tensors[0].device)
        self._views = [v.view(s) for v, s in zip(
            self.flat.split([s.numel() for s in shapes]), shapes)]

    @property
    def nbytes(self) -> int:
        """Bytes all-reduced a step."""
        return self.flat.numel() * self.flat.element_size()

    @torch.no_grad()
    def __call__(self, loss: torch.Tensor) -> torch.Tensor:
        local = [p.grad for p in self.params] + self.buffers
        torch._foreach_copy_(self._views, local + [loss])
        dist.all_reduce(self.flat, group=self.group)
        self.flat.div_(self.divisor)
        torch._foreach_copy_(local, self._views[:-1])
        return self._views[-1].clone()

    @torch.no_grad()
    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Copy rank 0's ``tensors`` to every rank: the replicated initial
        state."""
        src = dist.get_global_rank(self.group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=self.group)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        t = torch.tensor([int(flag)], device=self.flat.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def gather_objects(self, obj) -> list:
        """``obj`` of every rank, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def rank_rows(rows, world: int, rank: int):
    """The rows of ``rows`` [S, ...] that ``rank`` of ``world`` takes:
    consecutive groups of ``world`` rows, the ``rank``-th of each, the
    trailing partial group dropped (a numpy array or a range)."""
    whole = (len(rows) // world) * world
    return rows[rank:whole:world]


def sampler_seed(seed: int, salt: int, rank: Optional[int] = None) -> int:
    """The device sampler's seed: from ``(seed, salt)`` on one device, from
    ``(seed, salt, rank)`` on a rank of a mesh, so that ranks draw
    different ids."""
    entropy = [seed, salt] if rank is None else [seed, salt, rank]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def score_blocks(mesh, idm: torch.Tensor,
                 score: Callable[[torch.Tensor], torch.Tensor]):
    """[S, ...] scores of the id blocks ``idm`` [S, B] (-1 padded), scored
    across the mesh: this rank scores blocks ``rank, rank + world, ...`` of
    ``idm`` padded with all ``-1`` blocks to a multiple of the world size
    (``score(rows [K, B]) -> [K, ...]``), and the ranks' scores are
    gathered back in block order, padding dropped. Every rank returns the
    same tensor."""
    world, rank = mesh_rank(mesh)
    s = idm.shape[0]
    pad = -s % world
    if pad:
        idm = torch.cat([idm, idm.new_full((pad, *idm.shape[1:]), -1)])
    mine = score(idm[rank::world]).contiguous()
    parts = [torch.empty(mine.shape, dtype=mine.dtype, device=mine.device)
             for _ in range(world)]
    dist.all_gather(parts, mine, group=mesh.get_group(AXIS))
    return torch.stack(parts, 1).reshape(-1, *mine.shape[1:])[:s]
