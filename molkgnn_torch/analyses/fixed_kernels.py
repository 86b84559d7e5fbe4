"""Fixed (human-designed) kernel sets: load from disk, dump node scores.

Port of ``molkgnn_tpu/analyses/fixed_kernels.py``. The reference's kernel
set layer accepts per-degree *fixed* kernel convolutions whose scores stand
ahead of the trainable ones in each degree's column block, and its score
dump labels each score row with the kernel's name (trainable kernels are
``std_kernel``). The on-disk format is the JAX package's:

    customized_kernels/
      deg{d}.npz   x_center [L,F], x_support [L,d,F],
                   edge_attr_support [L,d,Fe], p_support [L,d,3]
      deg{d}.csv   one row per kernel, a ``name`` column (labels only)

``load_customized_kernels`` gives the 4-tuple that
``MolKGNNNet(fixed_kernels=...)`` takes. Score capture runs on the port's
``KernelSetConv.sow_scores``: ``capture_layer0_scores`` runs one eval
forward with it on and reads layer 0's node-order score matrix back once;
``dump_scores`` writes the reference-shaped ``scores.csv`` (rows = kernels,
columns = nodes) on the host. The loaders and writers are copied.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

KERNEL_FIELDS = ("x_center", "x_support", "edge_attr_support", "p_support")


def load_customized_kernels(
    root: str = "customized_kernels",
) -> Tuple[Tuple[Optional[Dict], ...], Tuple[List[str], ...]]:
    """Read per-degree fixed kernel tensors + names.

    Returns (fixed_kernels, names): ``fixed_kernels`` is a 4-tuple suitable
    for ``MolKGNNNet(fixed_kernels=...)`` (None for absent degrees);
    ``names`` is a 4-tuple of per-kernel label lists (empty for absent
    degrees).
    """
    kernels: List[Optional[Dict]] = []
    names: List[List[str]] = []
    for d in range(1, 5):
        npz_path = os.path.join(root, f"deg{d}.npz")
        if not os.path.exists(npz_path):
            kernels.append(None)
            names.append([])
            continue
        with np.load(npz_path) as z:
            entry = {k: np.asarray(z[k], np.float32) for k in KERNEL_FIELDS}
        L = entry["x_center"].shape[0]
        for k in ("x_support", "edge_attr_support", "p_support"):
            if entry[k].shape[0] != L or entry[k].shape[1] != d:
                raise ValueError(
                    f"{npz_path}: {k} must be [L={L}, d={d}, ...], "
                    f"got {entry[k].shape}"
                )
        kernels.append(entry)
        csv_path = os.path.join(root, f"deg{d}.csv")
        if os.path.exists(csv_path):
            with open(csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
            labels = [r["name"] for r in rows]
            if len(labels) != L:
                raise ValueError(
                    f"{csv_path}: {len(labels)} names for {L} kernels"
                )
        else:
            labels = [f"fixed_kernel_{i}" for i in range(L)]
        names.append(labels)
    return tuple(kernels), tuple(names)


def save_customized_kernels(
    root: str,
    kernels: Sequence[Optional[Dict]],
    names: Optional[Sequence[Sequence[str]]] = None,
) -> None:
    """Write the ``customized_kernels/`` layout read by the loader."""
    os.makedirs(root, exist_ok=True)
    for d, entry in enumerate(kernels, start=1):
        if entry is None:
            continue
        np.savez(
            os.path.join(root, f"deg{d}.npz"),
            **{k: np.asarray(entry[k], np.float32) for k in KERNEL_FIELDS},
        )
        if names is not None and names[d - 1]:
            with open(os.path.join(root, f"deg{d}.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["name"])
                for n in names[d - 1]:
                    w.writerow([n])


def score_headers(
    fixed_names: Sequence[Sequence[str]],
    num_trainable: Sequence[int],
) -> List[str]:
    """Row labels for scores.csv: per degree, fixed-kernel names then
    ``std_kernel`` per trainable kernel."""
    headers: List[str] = []
    for d in range(4):
        headers += list(fixed_names[d]) if d < len(fixed_names) else []
        headers += ["std_kernel"] * num_trainable[d]
    return headers


def dump_scores(
    scores: np.ndarray,  # [N, sum(block widths)] node-order score matrix
    fixed_names: Sequence[Sequence[str]],
    num_trainable: Sequence[int],
    path: str = "scores.csv",
) -> None:
    """Write the reference-shaped scores.csv: one row per kernel (named),
    one column per node."""
    headers = score_headers(fixed_names, num_trainable)
    scores = np.asarray(scores)
    if scores.shape[1] != len(headers):
        raise ValueError(
            f"scores have {scores.shape[1]} kernel columns, "
            f"headers describe {len(headers)}"
        )
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + list(range(scores.shape[0])))
        for i, name in enumerate(headers):
            w.writerow([name] + [repr(float(v)) for v in scores[:, i]])


def _layer0(model):
    """Layer 0 (a ``KernelSetConv``) of a ``MolKGNNNet`` or of a
    ``GNNModel`` around one."""
    enc = getattr(model, "gnn_model", model)
    layers = getattr(getattr(enc, "gnn", None), "layers", None)
    if not layers:
        raise ValueError("capture_layer0_scores: the model has no kgnn "
                         "layer 0")
    return layers[0]


@torch.no_grad()
def capture_layer0_scores(model, batch) -> np.ndarray:
    """Run one eval forward of ``model`` on ``batch`` (a ``GraphBatch`` on
    the model's device) with layer 0's score capture on, and return its
    node-order score matrix [N, sum(block widths)] (the reference's score
    dump input). The model's mode and capture flag are restored after."""
    layer = _layer0(model)
    sow, training = layer.sow_scores, model.training
    layer.sow_scores = True
    model.eval()
    try:
        model(batch)
        return layer.scores.cpu().numpy()
    finally:
        layer.sow_scores = sow
        if not sow:
            layer.scores = None
        model.train(training)
