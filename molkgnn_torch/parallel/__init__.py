"""Data and model parallelism and multi-process setup on ``torch.distributed``.

Port of ``molkgnn_tpu/parallel``: ``data_parallel.py`` (the mesh, the
step's collective, the batching and block sharding), ``halo.py`` (node-
sharded model parallelism with halo exchange), ``hybrid.py`` (data groups x
halo shards on a 2D mesh), ``collectives.py`` (the differentiable exchange
and sum they run on), ``multihost.py`` (joining a launched world),
``launch.py`` (starting one) and the deprecated, eval-only
``edge_partition.py`` (not exported here, as in the JAX package).

Two names of the JAX package's exports have no namesake here: pmap's
``shard_train_step`` is the ``Trainer``'s step with ``GradSync`` (the
step's one all-reduce, given a ``mesh``), and ``stack_shards`` is
``rank_rows`` (each rank takes its rows of a batch; nothing is stacked on
a leading device axis).
"""

from molkgnn_torch.parallel.data_parallel import (
    AXIS,
    GradSync,
    make_mesh,
    rank_rows,
    score_blocks,
)
from molkgnn_torch.parallel.halo import (
    halo_parallel_forward,
    halo_stats,
    halo_train_step,
    partition_halo,
)
from molkgnn_torch.parallel.hybrid import (
    hybrid_parallel_forward,
    hybrid_train_step,
    make_mesh_2d,
    partition_hybrid,
)

__all__ = [
    "AXIS",
    "GradSync",
    "make_mesh",
    "rank_rows",
    "score_blocks",
    "partition_halo",
    "halo_stats",
    "halo_parallel_forward",
    "halo_train_step",
    "make_mesh_2d",
    "partition_hybrid",
    "hybrid_parallel_forward",
    "hybrid_train_step",
]
