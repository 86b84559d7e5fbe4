"""The traffic of a training cell, made from the seed on the host.

One general generator reads a traffic file (``traffic/<name>.json``):

  * ``molecules``: ``unique`` random molecular graphs of heavy atoms (the
    reference code reads its SDF files with RDKit's ``SDMolSupplier``,
    which removes hydrogens). Atom counts are uniform on ``atoms = [lo,
    hi)``. A spanning tree grows atom by atom: each new atom bonds to a
    placed atom of degree k < 4 drawn with weight ``attach_weight[k]``.
    Then ``Binomial(n, ring_bond_prob)`` ring bonds close rings of
    ``ring_size`` atoms between two atoms of degree at most 2 (at most
    four tries a bond). The file's ``source`` gives the published means
    these parameters were fitted to, and its ``assumed`` list what no
    source gives (the spread of the counts, the split among degrees, the
    features and coordinates). Bond features are a one-hot of 4 orders
    and 3 random bits, both directions of a bond consecutive; node
    features N(0, 1), coordinates N(0, coord_std^2) Angstrom, atomic
    numbers 1-9;
  * ``entries``: ``actives`` + ``inactives`` dataset entries, each pointing
    to one unique molecule (a seeded shuffle of ``i % unique``), the
    actives placed at random;
  * ``split``: 80/10/10 of a permutation of the entries, sorted, as
    ``molkgnn_torch/data/dataset.py::_split`` splits.

The rest of the file (batch size, steps, what is traced) is read by the
harness (``run.py``).
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from collections import deque
from itertools import accumulate
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Molecule:
    """One molecule's raw arrays: what both the program and the plain
    reference are given."""

    x: np.ndarray  # [n, node_dim] float32
    p: np.ndarray  # [n, 3] float32
    edge_index: np.ndarray  # [2, E] int32, both directions of a bond
    edge_attr: np.ndarray  # [E, edge_dim] float32
    atomic_num: np.ndarray  # [n] int32


@dataclasses.dataclass
class Traffic:
    molecules: List[Molecule]
    mol_of_entry: np.ndarray  # [entries] int64, index into molecules
    labels: np.ndarray  # [entries] float32
    split: Dict[str, np.ndarray]  # sorted entry ids


def _ring_partner(rng, adj, deg, u: int, size: int):
    """An atom of degree at most 2 that lies ``size - 1`` bonds from ``u``
    (a bond between them closes a ring of ``size`` atoms), or None."""
    dist = {u: 0}
    queue = deque([u])
    while queue:
        a = queue.popleft()
        if dist[a] == size - 1:
            continue
        for b in adj[a]:
            if b not in dist:
                dist[b] = dist[a] + 1
                queue.append(b)
    far = [b for b, d in dist.items() if d == size - 1 and deg[b] <= 2]
    return far[int(rng.integers(len(far)))] if far else None


def random_molecule(rng: np.random.Generator, m: dict) -> Molecule:
    """One molecule of the traffic file's ``molecules`` entry ``m``."""
    lo, hi = m["atoms"]
    weight = m["attach_weight"]
    node_dim, edge_dim = m["node_dim"], m["edge_dim"]
    n = int(rng.integers(lo, hi))
    deg = [0] * n
    adj: List[List[int]] = [[] for _ in range(n)]
    bonds = []
    order = rng.permutation(n).tolist()
    placed = [order[0]]
    for v in order[1:]:
        cand = [u for u in placed if deg[u] < 4]
        w = list(accumulate(weight[deg[u]] for u in cand))
        u = cand[min(bisect_right(w, rng.random() * w[-1]), len(cand) - 1)]
        bonds.append((u, v))
        placed.append(v)
        deg[u] += 1
        deg[v] += 1
        adj[u].append(v)
        adj[v].append(u)
    rings = int(rng.binomial(n, m["ring_bond_prob"]))
    made = 0
    for _ in range(4 * rings):
        if made == rings:
            break
        free = [a for a in range(n) if deg[a] <= 2]
        if not free:
            break
        u = free[int(rng.integers(len(free)))]
        v = _ring_partner(rng, adj, deg, u, m["ring_size"])
        if v is None:
            continue
        bonds.append((u, v))
        deg[u] += 1
        deg[v] += 1
        adj[u].append(v)
        adj[v].append(u)
        made += 1
    edge_list = np.empty((2 * len(bonds), 2), np.int32)
    edge_attr = np.zeros((2 * len(bonds), edge_dim), np.float32)
    orders = rng.integers(0, 4, size=len(bonds))
    bits = rng.integers(0, 2, size=(len(bonds), edge_dim - 4))
    for b, (u, v) in enumerate(bonds):
        attr = edge_attr[2 * b]
        attr[orders[b]] = 1.0
        attr[4:] = bits[b]
        edge_attr[2 * b + 1] = attr
        edge_list[2 * b] = (u, v)
        edge_list[2 * b + 1] = (v, u)
    x = rng.standard_normal((n, node_dim)).astype(np.float32)
    p = rng.standard_normal((n, 3)).astype(np.float32) * m["coord_std"]
    atomic_num = rng.integers(1, 10, size=n).astype(np.int32)
    return Molecule(x=x, p=p, edge_index=np.ascontiguousarray(edge_list.T),
                    edge_attr=edge_attr, atomic_num=atomic_num)


def make_traffic(spec: dict, seed: int) -> Traffic:
    """The molecules, entries, labels and split of ``spec`` (a traffic
    file's dict) from ``seed``."""
    rng = np.random.default_rng([int(seed), 0x7AF1C])
    m = spec["molecules"]
    molecules = [random_molecule(rng, m) for _ in range(m["unique"])]
    e = spec["entries"]
    n = e["actives"] + e["inactives"]
    mol_of_entry = rng.permutation(np.arange(n) % m["unique"])
    labels = np.zeros(n, np.float32)
    labels[rng.choice(n, e["actives"], replace=False)] = 1.0
    perm = rng.permutation(n)
    n_tr, n_va = int(n * spec["split"][0]), int(n * spec["split"][1])
    split = {"train": np.sort(perm[:n_tr]),
             "valid": np.sort(perm[n_tr:n_tr + n_va]),
             "test": np.sort(perm[n_tr + n_va:])}
    return Traffic(molecules, mol_of_entry.astype(np.int64), labels, split)
