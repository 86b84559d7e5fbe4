"""Datasets, splits and the host-side loader.

Port of ``molkgnn_tpu/data/dataset.py`` (the dataset names, the synthetic
datasets, the oversampling weights and ``GraphLoader``; the QSAR and D4DCHP
ingest is in ``qsar.py`` and ``d4dchp.py``), with the same numpy RNG streams:
the same seed draws the same graphs, splits and batch ids. Oversampling
with replacement follows WeightedRandomSampler: inverse class-count
weights, ``len(graphs)`` draws an epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from molkgnn_torch.data.synthetic import (
    random_dataset,
    random_molgraph,
    tie_free_molgraph,
)
from molkgnn_torch.graphs.batch import BatchSpec, GraphBatch
from molkgnn_torch.graphs.molgraph import MolGraph
from molkgnn_torch.graphs.packed import PackedGraphs
from molkgnn_torch.parallel.data_parallel import rank_rows

QSAR_DATASET_NAMES = (
    "435008",
    "1798",
    "435034",
    "1843",
    "2258",
    "463087",
    "488997",
    "2689",
    "485290",
    "9999",
)
D4DCHP_DATASET_NAMES = ("CHIRAL1", "DIFF5", "D4DCHP", "dummy")

QSAR_METRICS = ["ppv", "logAUC_0.001_0.1", "logAUC_0.001_1", "f1_score", "AUC"]


@dataclasses.dataclass
class Dataset:
    """A featurized dataset with split indices and evaluation contract."""

    name: str
    graphs: List[MolGraph]
    split: Dict[str, np.ndarray]  # train/valid/test -> indices
    metrics: List[str]
    loss_name: str  # key into training.model.LOSSES

    def subset(self, part: str) -> List[MolGraph]:
        return [self.graphs[i] for i in self.split[part]]


def _split(rng: np.random.Generator, num_graphs: int) -> Dict[str, np.ndarray]:
    """80/10/10 split of a permutation drawn from ``rng``."""
    perm = rng.permutation(num_graphs)
    n_tr = int(num_graphs * 0.8)
    n_va = int(num_graphs * 0.1)
    return {
        "train": np.sort(perm[:n_tr]),
        "valid": np.sort(perm[n_tr : n_tr + n_va]),
        "test": np.sort(perm[n_tr + n_va :]),
    }


def make_synthetic_dataset(
    seed: int = 0,
    num_graphs: int = 256,
    active_fraction: float = 0.15,
) -> Dataset:
    """Random molecules with random labels and the QSAR evaluation
    contract, for tests, benchmarks and smoke training."""
    graphs = random_dataset(
        seed=seed, num_graphs=num_graphs, active_fraction=active_fraction
    )
    return Dataset(
        name="synthetic",
        graphs=graphs,
        split=_split(np.random.default_rng(seed + 1), num_graphs),
        metrics=list(QSAR_METRICS),
        loss_name="bce_with_logits",
    )


def make_motif_dataset(
    seed: int = 0,
    num_graphs: int = 256,
    noise: float = 0.3,
) -> Dataset:
    """Molecules with a learnable label: positives carry a planted
    4-neighbour feature motif around a degree-4 centre, the pattern the
    kernel convolution is built to match."""
    rng = np.random.default_rng(seed)
    motifs = rng.standard_normal((4, 28)).astype(np.float32) * 2
    graphs = []
    while len(graphs) < num_graphs:
        g = random_molgraph(rng, num_atoms=16)
        if g.fields[4].count < 1:
            continue
        y = float(rng.random() < 0.5)
        if y == 1.0:
            nei = g.fields[4].nei_index[0]
            for k in range(4):
                g.x[int(nei[k])] = motifs[k] + noise * rng.standard_normal(
                    28
                ).astype(np.float32)
            g.fields = None
            g = g.with_fields()
        g.y = y
        g.idx = len(graphs)
        graphs.append(g)
    return Dataset(
        name="synthetic_motif",
        graphs=graphs,
        split=_split(rng, num_graphs),
        metrics=list(QSAR_METRICS),
        loss_name="bce_with_logits",
    )


def make_tie_free_dataset(
    n: int, n_train: int, seed: int = 0, active_fraction: float = 0.5
) -> Dataset:
    """``n`` tie-free molecules (``tie_free_molgraph``) with random 0/1
    labels; the first ``n_train`` train, the rest split in two halves.

    Runs on the card compared with runs on the CPU use them: where
    neighbours carry bitwise-equal features the permutation argmax follows
    the last bits of the sums, cuBLAS sums its products in another order
    than the CPU does, and Adam's first steps turn such a flip into a
    parameter difference of the learning rate's size. Runs on the card
    compared with each other need them no longer: every sum there runs in
    a fixed order (``ops/segment.py``), so they repeat bit for bit.
    """
    rng = np.random.default_rng(seed)
    graphs = [tie_free_molgraph(rng) for _ in range(n)]
    for i, g in enumerate(graphs):
        g.y, g.idx = float(rng.random() < active_fraction), i
    half = n_train + (n - n_train) // 2
    return Dataset(
        name="tie_free",
        graphs=graphs,
        split={"train": np.arange(n_train), "valid": np.arange(n_train, half),
               "test": np.arange(half, n)},
        metrics=list(QSAR_METRICS),
        loss_name="bce_with_logits",
    )


def oversampling_weights(labels: np.ndarray) -> np.ndarray:
    """Inverse-class-count weights."""
    n_active = int((labels == 1).sum())
    n_inactive = int(labels.shape[0]) - n_active
    return np.where(
        labels == 1, 1.0 / max(n_active, 1), 1.0 / max(n_inactive, 1)
    )


def epoch_order(
    rng: np.random.Generator,
    labels: np.ndarray,
    oversample: bool,
    shuffle: bool,
) -> np.ndarray:
    """One epoch's positions into ``labels``: ``len(labels)`` weighted draws
    with replacement, a permutation, or the identity, in that order of
    precedence."""
    n = labels.shape[0]
    if oversample:
        w = oversampling_weights(labels)
        return rng.choice(n, size=n, replace=True, p=w / w.sum())
    if shuffle:
        return rng.permutation(n)
    return np.arange(n)


class GraphLoader:
    """Host-side loader of fixed-shape GraphBatches (CPU tensors).

    ``seed`` is an int or a ``np.random.Generator`` to draw from. The final
    partial batch is padded with masked graphs, never dropped. ``shard``
    (rank, world) of a data-parallel run: every rank draws the same epoch
    order and packs only its own batches, the ``rank``-th of each group of
    ``world`` consecutive ones, the trailing partial group dropped
    (``parallel/data_parallel.py::rank_rows``). ``collate``
    (graphs, spec) -> batch packs another batch family (the point families'
    ``batch_points``, ChIRoNet's ``batch_chiro``); by default kgnn batches
    come from the flat-packed dataset.
    """

    def __init__(
        self,
        graphs: Sequence[MolGraph],
        spec: BatchSpec,
        batch_size: int,
        shuffle: bool = False,
        oversample: bool = False,
        seed=0,
        collate=None,
        shard: Tuple[int, int] = (0, 1),
    ):
        self.graphs = list(graphs)
        self.spec = spec
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.oversample = oversample
        self.rng = np.random.default_rng(seed)
        self.collate = collate
        self.shard = shard
        self._packed = (PackedGraphs.from_graphs(self.graphs)
                        if collate is None else None)
        self._labels = np.array([g.y for g in self.graphs])

    def _starts(self, n: int):
        rank, world = self.shard
        return rank_rows(range(0, n, self.batch_size), world, rank)

    def __len__(self) -> int:
        return len(self._starts(len(self.graphs)))

    def __iter__(self) -> Iterator[GraphBatch]:
        order = epoch_order(
            self.rng, self._labels, self.oversample, self.shuffle
        )
        for start in self._starts(len(order)):
            idx = order[start : start + self.batch_size]
            if self._packed is None:
                yield self.collate([self.graphs[i] for i in idx], self.spec)
            else:
                yield self._packed.pack(idx, self.spec)
