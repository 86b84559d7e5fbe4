"""Data parallelism and multi-process setup on ``torch.distributed``.

Port of ``molkgnn_tpu/parallel`` (its data-parallel and multi-host parts):
``data_parallel.py`` (the mesh, the step's collective, the batching and
block sharding), ``multihost.py`` (joining a launched world) and
``launch.py`` (starting one). Model parallelism (halo, hybrid) is not
ported yet (ROADMAP A13).
"""

from molkgnn_torch.parallel.data_parallel import (
    AXIS,
    GradSync,
    make_mesh,
    rank_rows,
    score_blocks,
)

__all__ = ["AXIS", "GradSync", "make_mesh", "rank_rows", "score_blocks"]
