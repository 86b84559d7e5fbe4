"""Synthetic molecule-like graphs for tests and benchmarks.

Numpy copy of ``molkgnn_tpu/data/synthetic.py``: the same seed gives the
same graphs. Random connected graphs with max degree 4, random 3D
coordinates, 28-dim node and 7-dim bond features. Edge lists emit both bond
directions consecutively (2i, 2i+1).
"""

from __future__ import annotations

from typing import List

import numpy as np

from molkgnn_torch.graphs.molgraph import MolGraph


def random_molgraph(
    rng: np.random.Generator,
    num_atoms: int | None = None,
    label: float | None = None,
) -> MolGraph:
    """One random molecule; ``label`` None draws a 0/1 label from ``rng``."""
    n = int(num_atoms if num_atoms is not None else rng.integers(8, 40))
    node_dim, edge_dim = 28, 7
    deg = np.zeros(n, np.int64)
    bonds = []

    # Random spanning tree with degree cap 4.
    order = rng.permutation(n)
    in_tree = [order[0]]
    for v in order[1:]:
        candidates = [u for u in in_tree if deg[u] < 4]
        u = candidates[int(rng.integers(len(candidates)))]
        bonds.append((u, v))
        deg[u] += 1
        deg[v] += 1
        in_tree.append(v)

    # A few ring-closing edges.
    n_extra = int(rng.binomial(max(n // 6, 1), 0.3))
    existing = set(map(frozenset, bonds))
    for _ in range(n_extra):
        u, v = rng.integers(0, n, size=2)
        if u == v or deg[u] >= 4 or deg[v] >= 4:
            continue
        if frozenset((int(u), int(v))) in existing:
            continue
        bonds.append((int(u), int(v)))
        existing.add(frozenset((int(u), int(v))))
        deg[u] += 1
        deg[v] += 1

    edge_list = []
    edge_attr = []
    for u, v in bonds:
        attr = np.zeros(edge_dim, np.float32)
        attr[int(rng.integers(0, 4))] = 1.0  # bond-order one-hot
        attr[4:] = rng.integers(0, 2, size=edge_dim - 4)
        edge_list.append((u, v))
        edge_attr.append(attr)
        edge_list.append((v, u))
        edge_attr.append(attr)

    x = rng.standard_normal((n, node_dim)).astype(np.float32)
    p = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    y = float(label if label is not None else rng.integers(0, 2))
    g = MolGraph(
        x=x,
        p=p,
        edge_index=np.array(edge_list, np.int32).T,
        edge_attr=np.array(edge_attr, np.float32),
        y=y,
        atomic_num=rng.integers(1, 10, size=n).astype(np.int32),
    )
    return g.with_fields()


def random_dataset(
    seed: int = 0,
    num_graphs: int = 64,
    active_fraction: float = 0.1,
) -> List[MolGraph]:
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(num_graphs):
        label = 1.0 if rng.random() < active_fraction else 0.0
        g = random_molgraph(rng, label=label)
        g.idx = i
        graphs.append(g)
    return graphs


def tie_free_molgraph(rng: np.random.Generator) -> MolGraph:
    """Caterpillar tree with at most one leaf child per node.

    Spine s0..s_{m-1}; interior spine nodes optionally gain one leaf and/or
    one pendant 2-chain (internal child + its own single leaf), so degrees
    run 1-4. No node has two neighbors with identical neighbor sets, the
    generic source of bitwise-equal aggregated features at layers >= 2 that
    make the permutation argmax depend on summation order. Comparisons of
    deep models across implementations use these molecules.
    """
    edges = []
    m = int(rng.integers(5, 7))
    nodes = m
    for u in range(m - 1):
        edges.append((u, u + 1))
    for si in range(2, m - 2):
        kind = int(rng.integers(0, 3))
        if kind >= 1:  # one leaf child
            edges.append((si, nodes))
            nodes += 1
        if kind == 2:  # plus one pendant chain: deg-4 spine node
            t, u = nodes, nodes + 1
            edges.append((si, t))
            edges.append((t, u))
            nodes += 2
    ei, ea = [], []
    for u, v in edges:
        attr = rng.standard_normal(7).astype(np.float32)
        ei += [(u, v), (v, u)]
        ea += [attr, attr]
    return MolGraph(
        x=rng.standard_normal((nodes, 28)).astype(np.float32),
        p=rng.standard_normal((nodes, 3)).astype(np.float32),
        edge_index=np.array(ei, np.int32).T,
        edge_attr=np.array(ea, np.float32),
        y=0.0,
        atomic_num=rng.integers(1, 10, size=nodes).astype(np.int32),
    ).with_fields()
