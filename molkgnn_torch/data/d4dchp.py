"""D4DCHP chirality datasets (CHIRAL1 / DIFF5 / D4DCHP / dummy).

Reference contract: D4DCHPDataset (reference wrapper.py:246-348) +
the registry entries in data.py:41-78 — a CSV with a ``smiles`` column and a
per-subset label column, split indices in a ``.npy`` (list of three index
arrays: train, valid, test), SMILES -> embedded 3D graphs. CHIRAL1 is
binary classification (accuracy, BCE), D4DCHP is docking-score regression
(RMSE, sum-reduced MSE).

Copy of ``molkgnn_tpu/data/d4dchp.py``: SMILES ->
``chem.embed.smiles_to_graph`` (kgnn and the point families), or ->
``graphs/chiro.py::smiles_to_chiro_graph`` for ChIRoNet (rows whose
molecule has no dihedral are dropped), bit-equal to the JAX package. The
ChIRoNet cache is the port's own ``.npz`` (``data/qsar.py::
save_chiro_cache``), never the JAX package's pickle.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from molkgnn_torch.data.dataset import Dataset

SUBSETS = {
    "CHIRAL1": dict(
        label_column="labels", metrics=["accuracy"], loss="bce_with_logits"
    ),
    "DIFF5": dict(
        label_column="labels", metrics=["accuracy"], loss="bce_with_logits"
    ),
    "D4DCHP": dict(
        label_column="docking_score", metrics=["RMSE"], loss="mse_sum"
    ),
    "dummy": dict(
        label_column="labels", metrics=["accuracy"], loss="bce_with_logits"
    ),
}


def load_d4dchp_dataset(
    data_file: str,
    subset_name: str,
    idx_file: str,
    gnn_type: str = "kgnn",
    cache_dir: Optional[str] = None,
    embed_seed: int = 42,
) -> Dataset:
    if subset_name not in SUBSETS:
        raise ValueError(f"unknown D4DCHP subset {subset_name}")
    info = SUBSETS[subset_name]

    cache = None
    chiro = gnn_type == "chironet"
    if cache_dir:
        cache = os.path.join(
            cache_dir,
            f"{gnn_type}-d4dchp-{subset_name}.{'npz' if chiro else 'npy'}",
        )
    if chiro and cache and os.path.exists(cache):
        from molkgnn_torch.data.qsar import load_chiro_cache

        graphs = load_chiro_cache(cache)[0]
        kept = [g.idx for g in graphs]
    elif cache and os.path.exists(cache):
        payload = np.load(cache, allow_pickle=True).item()
        graphs, kept = payload["graphs"], payload["kept"]
    else:
        graphs, kept = _ingest(data_file, info["label_column"], gnn_type,
                               embed_seed)
        if chiro and cache:
            from molkgnn_torch.data.qsar import save_chiro_cache

            save_chiro_cache(cache, graphs, [])
        elif cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            np.save(
                cache,
                np.array({"graphs": graphs, "kept": kept}, dtype=object),
                allow_pickle=True,
            )

    indices = np.load(idx_file, allow_pickle=True)
    split_raw = {
        "train": np.asarray(indices[0]),
        "valid": np.asarray(indices[1]),
        "test": np.asarray(indices[2]),
    }
    # Map original CSV row ids -> positions among successfully parsed graphs.
    idx_to_pos = {orig: pos for pos, orig in enumerate(kept)}
    split = {
        part: np.array(
            [idx_to_pos[i] for i in ids if i in idx_to_pos], np.int64
        )
        for part, ids in split_raw.items()
    }
    return Dataset(
        name=subset_name,
        graphs=graphs,
        split=split,
        metrics=list(info["metrics"]),
        loss_name=info["loss"],
    )


def _ingest(data_file: str, label_column: str, gnn_type: str, embed_seed: int):
    from molkgnn_torch.chem.embed import smiles_to_graph
    from molkgnn_torch.graphs.chiro import smiles_to_chiro_graph

    to_graph = (smiles_to_chiro_graph if gnn_type == "chironet"
                else smiles_to_graph)
    graphs: List = []
    kept: List[int] = []
    with open(data_file) as f:
        reader = csv.DictReader(f)
        for i, row in enumerate(reader):
            smi = row["smiles"]
            label = float(row[label_column])
            g = to_graph(smi, y=label, idx=i, seed=embed_seed)
            if g is None:
                continue
            graphs.append(g)
            kept.append(i)
    return graphs, kept
