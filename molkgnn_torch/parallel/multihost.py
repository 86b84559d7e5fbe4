"""Joining a multi-process (and multi-host) world.

Port of ``molkgnn_tpu/parallel/multihost.py``. One process owns one device,
so a world of N devices is N processes, started by ``parallel/launch.py``
or by a launcher (``torch.distributed.run``, a cluster's scheduler):

  * ``initialize()`` joins the world from the environment (idempotent: it
    returns at once when a process group exists). It reads the JAX
    package's names, ``COORDINATOR_ADDRESS`` (host:port of rank 0),
    ``NUM_PROCESSES`` and ``PROCESS_ID``, or a launcher's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``LOCAL_RANK`` picks the
    card). With neither set it is a single process and does nothing.
    Failures of an explicit setup propagate;
  * ``global_data_mesh()`` is the ``"data"`` mesh over every rank;
  * ``host_shard`` and ``local_device_batches`` keep the JAX semantics with
    one device a process: a process's contiguous share of a list, and its
    row of a global ``[n_devices, B]`` id matrix.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def env_world() -> Optional[int]:
    """The world size the environment sets up (the JAX package's names
    first, then a launcher's), or None for a single process."""
    if os.environ.get("COORDINATOR_ADDRESS"):
        return int(os.environ.get("NUM_PROCESSES", "1"))
    if os.environ.get("MASTER_ADDR") and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str | torch.device] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the world (see the module doc); returns True if this call
    created the process group (its caller then destroys it), False if one
    existed or there is no world to join. ``backend`` defaults to NCCL for
    ``device`` on the card (the default) and gloo on the CPU."""
    if dist.is_initialized():
        return False
    from molkgnn_torch.serving.predictor import resolve_device

    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{addr}",
            world_size=int(num_processes if num_processes is not None
                           else os.environ.get("NUM_PROCESSES", "1")),
            rank=int(process_id if process_id is not None
                     else os.environ.get("PROCESS_ID", "0")),
        )
    elif env_world() is not None:
        dist.init_process_group(backend, init_method="env://")
    else:
        return False  # a single process
    if device.type == "cuda":
        from molkgnn_torch.parallel.data_parallel import cuda_index

        torch.cuda.set_device(cuda_index(backend))
    return True


def global_data_mesh(device: Optional[str | torch.device] = None,
                     backend: Optional[str] = None):
    """The ``"data"`` mesh over every rank of the world."""
    from molkgnn_torch.parallel.data_parallel import make_mesh

    return make_mesh(None, device=device, backend=backend)


def _rank_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(
    items: Sequence,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
):
    """Contiguous static partition of ``items`` for this process."""
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    pcount = world if process_count is None else process_count
    per = -(-len(items) // pcount)
    return items[pid * per:(pid + 1) * per]


def local_device_batches(global_batch_ids: np.ndarray) -> np.ndarray:
    """This process's rows of a global per-step id matrix
    ``[n_global_devices, B]``: one row, its rank's (one device a
    process)."""
    rank, _ = _rank_world()
    return global_batch_ids[rank:rank + 1]
