"""Static permutation tables for kernel-support alignment.

Copy of ``molkgnn_tpu/ops/permutations.py``. Degrees 1-3 enumerate all d!
orderings (itertools order). Degree 4 uses only the 12 *even* (rotation)
permutations of the tetrahedron, so that mirror-image neighborhoods cannot
be aligned away: this is what preserves chirality.
"""

from itertools import permutations as _perms

import numpy as np

# Even permutations of 4 elements (the rotation group of the tetrahedron),
# in the reference's order.
_D4_EVEN = (
    (0, 1, 2, 3),
    (0, 2, 3, 1),
    (0, 3, 1, 2),
    (1, 0, 3, 2),
    (1, 2, 0, 3),
    (1, 3, 2, 0),
    (2, 0, 1, 3),
    (2, 1, 3, 0),
    (2, 3, 0, 1),
    (3, 0, 2, 1),
    (3, 1, 0, 2),
    (3, 2, 1, 0),
)

PERMS = {
    1: tuple(_perms(range(1))),
    2: tuple(_perms(range(2))),
    3: tuple(_perms(range(3))),
    4: _D4_EVEN,
}


def num_perms(deg: int) -> int:
    return len(PERMS[deg])


def perm_table(deg: int) -> np.ndarray:
    """[P, deg] int32 table of permutations for ``deg`` neighbors."""
    return np.asarray(PERMS[deg], dtype=np.int32)
