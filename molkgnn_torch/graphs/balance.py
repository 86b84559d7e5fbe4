"""Balanced batch composition for tight static capacities.

Copied from ``molkgnn_tpu/graphs/balance.py``, with the port's
``BatchSpec`` and ``MolGraph``; the port imports nothing of the JAX package.

``spec_for_graphs`` (batch.py) guarantees that ANY ``batch_size`` molecules
drawn from the pool fit: a max-k-sum capacity. Random batches fill only part
of that bound, so much of every scoring product and segment op is padding.
This module trades the any-subset guarantee for a sampler-aware one:

  * ``deal_by_size``: compose an epoch's batches by dealing the sampled ids
    round-robin in decreasing size order. Each batch receives one graph per
    size stratum per round, so per-batch field sums concentrate tightly
    around the epoch mean instead of fluctuating like iid draws.
  * ``spec_for_sampler`` / ``spec_for_dataset``: capacities = max dealt-batch
    sums over simulated sampler epochs, times a slack factor.
  * ``check_batches_fit``: the hard host-side guarantee. The device-side
    assembler (``device_pack.gather_batch``) has no way to raise and
    TRUNCATES silently on overflow, so every tightened-spec consumer must
    run this check before dispatch; it raises with the offending field.

Training semantics: the sampled multiset of each epoch is exactly the
oversampling draw of ``data/dataset.py::epoch_order``; only the
*composition* of batches changes, from draw order to size-stratified
dealing. Opt-in via ``TrainConfig.balanced_batches``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from molkgnn_torch.graphs.batch import BatchSpec, _round_up
from molkgnn_torch.graphs.molgraph import MAX_DEGREE, MolGraph

FIELD_NAMES = ("nodes", "edges", "deg1", "deg2", "deg3", "deg4")
N_FIELDS = len(FIELD_NAMES)
# Deal key: edge count, strongly correlated with nodes and every degree
# bucket, so balancing it balances all six padded fields at once.
SIZE_FIELD = 1


def count_matrix(graphs: Sequence[MolGraph]) -> np.ndarray:
    """[G, 6] int64 per-graph padded-field sizes (nodes, edges, deg1..4)."""
    C = np.zeros((len(graphs), N_FIELDS), np.int64)
    for i, g in enumerate(graphs):
        gf = g.with_fields()
        C[i, 0] = g.num_nodes
        C[i, 1] = g.num_edges
        for d in range(1, MAX_DEGREE + 1):
            C[i, 1 + d] = gf.fields[d].count
    return C


def caps_vector(spec: BatchSpec) -> np.ndarray:
    return np.array(
        [spec.num_nodes, spec.num_edges, *spec.deg_capacity], np.int64
    )


def deal_by_size(
    ids: np.ndarray, sizes: np.ndarray, batch_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Deal ``ids`` into ceil(n / batch_size) batches, one per row.

    Ids are sorted by decreasing ``sizes`` (stable, so equal-size order is
    the sampler's draw order) and dealt round-robin: batch i gets sorted
    items i, i+S, i+2S, ... Every batch therefore spans the full size
    distribution and their field sums are nearly equal.

    Returns ``(id_matrix, pos_matrix)``, both [S, batch_size] int32 padded
    with -1; ``pos_matrix[i, j]`` is the position in ``ids`` of
    ``id_matrix[i, j]`` (use it to restore per-id outputs, e.g. eval
    predictions, to the caller's order).
    """
    ids = np.asarray(ids)
    n = len(ids)
    order = np.argsort(-np.asarray(sizes), kind="stable")
    s = max(1, -(-n // batch_size))
    idm = np.full((s, batch_size), -1, np.int32)
    posm = np.full((s, batch_size), -1, np.int32)
    for i in range(s):
        sel = order[i::s]
        idm[i, : len(sel)] = ids[sel]
        posm[i, : len(sel)] = sel
    return idm, posm


def batch_field_sums(id_matrix: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """[..., 6] field sums of each id row (-1 entries ignored)."""
    idm = np.asarray(id_matrix)
    valid = idm >= 0
    safe = np.where(valid, idm, 0)
    return (counts[safe] * valid[..., None]).sum(axis=-2)


def check_batches_fit(
    id_matrix: np.ndarray, counts: np.ndarray, spec: BatchSpec
) -> None:
    """Raise if any id row overflows the spec. MANDATORY before dispatching
    a non-cover spec: gather_batch silently drops rows past capacity."""
    sums = batch_field_sums(np.atleast_2d(id_matrix), counts)
    caps = caps_vector(spec)
    over = sums > caps
    if over.any():
        i, j = map(int, np.argwhere(over)[0])
        raise ValueError(
            f"balanced batch {i} exceeds spec {FIELD_NAMES[j]} capacity "
            f"({int(sums[i, j])} > {int(caps[j])}). Rebuild the spec with "
            f"more slack (graphs.balance.spec_for_sampler) or fall back to "
            f"the cover spec (graphs.batch.spec_for_graphs)."
        )


def spec_for_sampler(
    graphs: Sequence[MolGraph],
    batch_size: int,
    *,
    pools: Optional[Sequence[np.ndarray]] = None,
    weighted_pools: Optional[Sequence[tuple]] = None,
    epochs: int = 30,
    slack: float = 1.08,
    seed: int = 0,
    node_align: int = 8,
) -> BatchSpec:
    """Tight capacities for size-dealt batches.

    Simulates ``epochs`` epochs of every consumer of the spec and sets each
    capacity to the max dealt-batch sum observed, times ``slack``:

      * ``pools``: id arrays dealt as-is (evaluation over a split; dealing
        is permutation-invariant so one pass per pool suffices, but every
        epoch re-checks for free).
      * ``weighted_pools``: ``(ids, probs)`` tuples simulated as len(ids)
        with-replacement draws (the oversampling train sampler):
        duplicates of large actives are what push dealt sums above the
        permutation maxima.

    Defaults to the whole graph list as one pool. Consumers must still run
    ``check_batches_fit`` per epoch (it is O(batch-rows) numpy).
    """
    counts = count_matrix(graphs)
    rng = np.random.default_rng(seed)
    maxima = np.zeros(N_FIELDS, np.int64)
    base_pools = [np.asarray(p) for p in (pools or [np.arange(len(graphs))])]
    wpools = [
        (np.asarray(ids), np.asarray(w, np.float64) / np.sum(w))
        for ids, w in (weighted_pools or [])
    ]

    def observe(ids):
        nonlocal maxima
        idm, _ = deal_by_size(ids, counts[ids, SIZE_FIELD], batch_size)
        maxima = np.maximum(maxima, batch_field_sums(idm, counts).max(0))

    for _ in range(epochs):
        for pool in base_pools:
            observe(pool)
        for ids, p in wpools:
            observe(ids[rng.choice(len(ids), size=len(ids), p=p)])

    cap = [
        _round_up(int(np.ceil(m * slack)), node_align) for m in maxima
    ]
    g0 = graphs[0]
    return BatchSpec(
        num_graphs=batch_size,
        num_nodes=cap[0],
        num_edges=cap[1],
        deg_capacity=tuple(cap[2:]),
        node_dim=int(g0.x.shape[1]),
        edge_dim=int(g0.edge_attr.shape[1]),
        pos_dim=int(g0.p.shape[1]),
    )


def spec_for_dataset(
    dataset, batch_size: int, *, oversample: bool = True, **kwargs
) -> BatchSpec:
    """``spec_for_sampler`` wired to a Dataset: covers evaluation dealing of
    every split plus (optionally) the oversampled train draw."""
    from molkgnn_torch.data.dataset import oversampling_weights

    pools = [np.asarray(ids) for ids in dataset.split.values()]
    weighted = None
    if oversample:
        train_ids = np.asarray(dataset.split["train"])
        labels = np.array([dataset.graphs[i].y for i in train_ids])
        weighted = [(train_ids, oversampling_weights(labels))]
    return spec_for_sampler(
        dataset.graphs,
        batch_size,
        pools=pools,
        weighted_pools=weighted,
        **kwargs,
    )
