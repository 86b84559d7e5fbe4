"""Screening graphs/s of the flagship alone, timed on the card.

The flagship (4 layers, 10/20/30/50 kernels, hidden 32, the scorer kernel;
random weights from seed 0) screens a library of 8192 synthetic molecules
(seed 0) repeated 16 times (131,072, slabs of 100,000 and 31,072) at batch
1024 through ``Predictor.screen_library``, on one device; with ``--dp`` on
a world-1 data mesh (``parallel/data_parallel.py::make_mesh``). After one
screen to warm up, each of ``--runs`` screens is timed on the host clock,
synchronised. Prints one JSON line with the working directory, the seconds
and graphs/s of each screen and the host seconds of each slab's flat
packing and copy.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m molkgnn_torch.tools.screen_rate [--runs 3] [--dp]

Run it from two checkouts in turns (A, B, B, A) to compare their screening
on one card: its host side (the packing, about 60% of a screen) varies
from process to process.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from molkgnn_torch.data.synthetic import random_dataset
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.ops import _build
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training.model import GNNModel


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--dp", action="store_true")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    graphs = random_dataset(seed=0, num_graphs=8192)
    spec = spec_for_graphs(graphs, 1024)
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(MolKGNNNet(num_layers=4, use_kernel=True,
                                generator=gen), generator=gen)
    pred = Predictor(model, model.state_dict(), spec)
    library = list(graphs) * 16
    mesh = None
    if args.dp:
        from molkgnn_torch.parallel.data_parallel import make_mesh

        mesh = make_mesh(1)
    pred.screen_library(library, mesh=mesh)
    seconds, packs = [], []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.screen_library(library, mesh=mesh)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        packs.append([s["pack_s"] for s in pred.screen_slabs])
    print(json.dumps({
        "dir": os.getcwd(), "dp": args.dp, "seconds": seconds,
        "graphs_per_s": [len(library) / s for s in seconds],
        "pack_s": packs,
    }))
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
