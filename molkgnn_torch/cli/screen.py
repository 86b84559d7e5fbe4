"""`molkgnn-torch-screen`: score an SDF library with an exported model.

Port of ``molkgnn_tpu/cli/screen.py``. The artifact of ``Predictor.export``
(or ``molkgnn-torch-import``) carries the program and its batch spec, so
scoring needs no model code, no checkpoint directory and no training
configuration:

    molkgnn-torch-screen --exported model.pt2 --sdf library.sdf \\
        --out scores.csv

The CSV is ``record_index,score``, one row per SDF record; a record that
does not parse, or that the artifact's family cannot featurize (a molecule
with no dihedral for ChIRoNet), has an empty score, at its position.
``--probabilities`` applies the sigmoid to the finite scores. ``--device``
(default ``cuda``) must be the device type the artifact was exported on.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="molkgnn-torch-screen",
        description="Score an SDF molecule library with an exported model",
    )
    p.add_argument("--exported", required=True,
                   help="Predictor.export artifact")
    p.add_argument("--sdf", required=True, help="SDF file to score")
    p.add_argument("--out", required=True, help="output CSV path")
    p.add_argument(
        "--probabilities",
        action="store_true",
        default=False,
        help="emit sigmoid probabilities instead of raw logits",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(
        argv if argv is not None else sys.argv[1:]
    )
    t0 = time.time()

    import torch

    from molkgnn_torch.chem.sdf import parse_sdf
    from molkgnn_torch.serving.predictor import (
        Predictor,
        host_pipeline_for_spec,
    )
    from molkgnn_torch.training.metrics import sigmoid

    forward, spec = Predictor.load_exported(args.exported, args.device)
    to_graph, collate = host_pipeline_for_spec(spec)

    graphs, rows = [], []  # rows[i] = record index of graphs[i]
    n_records = 0
    for mol, _data in parse_sdf(args.sdf):
        idx = n_records
        n_records += 1
        g = None if mol is None else to_graph(mol, y=0.0, idx=idx)
        if g is None:
            continue
        rows.append(idx)
        graphs.append(g)

    scores = np.full((n_records,), np.nan, np.float32)
    b = spec.num_graphs
    preds, masks = [], []
    for start in range(0, len(graphs), b):
        batch = collate(graphs[start : start + b], spec)  # raises on overflow
        pred, _emb = forward(batch)
        preds.append(pred)
        masks.append(batch.graph_mask.numpy())
    if preds:
        flat = torch.cat(preds).cpu().numpy()  # one readback
        scores[np.asarray(rows)] = flat[np.concatenate(masks)]
    if args.probabilities:
        finite = np.isfinite(scores)
        scores[finite] = sigmoid(scores[finite])

    with open(args.out, "w") as f:
        f.write("record_index,score\n")
        for i, v in enumerate(scores):
            f.write(f"{i},{'' if np.isnan(v) else repr(float(v))}\n")
    print(
        f"molkgnn-torch-screen: {n_records} records, {len(graphs)} scored,"
        f" {n_records - len(graphs)} invalid, {time.time() - t0:.1f}s"
        f" -> {args.out}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
