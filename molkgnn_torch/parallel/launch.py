"""Starting a world of N processes on one machine, one a device.

``spawn(fn, n, args, device)`` runs ``fn(*args)`` in N new processes
(``torch.multiprocessing`` with the ``spawn`` method), rank r with the
launcher's environment (``MASTER_ADDR``/``MASTER_PORT`` on a free
localhost port, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and the world
joined (``multihost.initialize``) before ``fn`` runs; the process group is
destroyed when it returns. Rank r runs on ``cuda:r`` with NCCL, or on the
CPU with gloo. NCCL needs a card a rank: N above the machine's cards
raises before any process starts; ranks share a card only in a gloo world
asked for by name (``backend="gloo"``). The scorer kernel is built here,
before the ranks start, so that N processes do not compile it at once. A
rank that fails fails the call, after every rank has ended.

Under a launcher (``torch.distributed.run``) nothing is spawned: each
process joins the launcher's world with ``multihost.initialize``.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Optional

import torch


def free_port() -> int:
    """A free localhost port (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(
    fn: Callable,
    n: int,
    args: tuple = (),
    device: Optional[str | torch.device] = None,
    backend: Optional[str] = None,
) -> None:
    """Run ``fn(*args)`` on ``n`` ranks (see the module doc); ``fn`` must
    be importable by name (a module-level function)."""
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and n > count:
            raise ValueError(
                f"{n} ranks need {n} CUDA devices (one process a device); "
                f"this machine has {count}"
            )
        from molkgnn_torch.ops import _build

        _build.build_all()
    torch.multiprocessing.spawn(
        _rank_main,
        args=(n, free_port(), str(device.type), backend, fn, args),
        nprocs=n,
        join=True,
    )


def _rank_main(rank, n, port, device, backend, fn, args):
    from molkgnn_torch.parallel.multihost import initialize

    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(n),
        RANK=str(rank), LOCAL_RANK=str(rank),
    )
    initialize(device=device, backend=backend)
    try:
        fn(*args)
    finally:
        torch.distributed.destroy_process_group()
