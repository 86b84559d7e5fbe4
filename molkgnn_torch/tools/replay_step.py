"""The flagship's replayed train step alone, timed on the card.

The flagship (4 layers, 10/20/30/50 kernels, hidden 32, the scorer kernel;
random weights from seed 0) trains on 8192 synthetic molecules at batch
1024 with ``scan_steps=16`` and device sampling: after 20 replays, six
blocks of 16 replays are timed by CUDA events. Prints one JSON line with
the working directory and the milliseconds a step of each block.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m molkgnn_torch.tools.replay_step

Run it from two checkouts in turns (A, B, B, A) to compare their steps on
one card.
"""

from __future__ import annotations

import json
import os

import torch

from molkgnn_torch.data.dataset import make_synthetic_dataset
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.ops import _build
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ds = make_synthetic_dataset(num_graphs=8192)
    spec = spec_for_graphs(ds.graphs, 1024)
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(MolKGNNNet(num_layers=4, use_kernel=True,
                                generator=gen), generator=gen)
    trainer = Trainer(model, ds, spec, TrainConfig(
        batch_size=1024, progress=False, scan_steps=16,
        device_sampling=True))
    for _ in range(20):
        trainer._graph_step()
    torch.cuda.synchronize()
    blocks = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(16):
            trainer._graph_step()
        end.record()
        torch.cuda.synchronize()
        blocks.append(start.elapsed_time(end) / 16)
    print(json.dumps({"dir": os.getcwd(), "ms_a_step": blocks}))


if __name__ == "__main__":
    main()
