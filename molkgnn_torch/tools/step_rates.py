"""End-to-end rates of the flagship and of each other family, timed on the card.

In one process, from seed 0, fp32, TF32 off:

  * kgnn, the flagship (4 layers, 10/20/30/50 kernels, hidden 32, the
    scorer kernel) on 8192 synthetic molecules at batch 1024: the replayed
    train step (``scan_steps=16``, device sampling; after 20 replays, six
    blocks of 16 replays by CUDA events), serving graphs/s end to end
    (``Predictor.predict_graphs``) and forward only (the model on the
    prepared batches), and ``Predictor.screen_library`` graphs/s over the
    molecules repeated 4 times (32,768), each after one warm-up, host clock,
    synchronised, best of 3;
  * SchNet, DimeNet++ and SphereNet at their published widths on the same
    molecules (8192, 2048 and 512 of them, batches 1024, 128 and 128) and
    ChIRoNet on the 29 scaffold SMILES of ``chip_smoke.py`` under 8 seeds
    repeated to 8192 (batch 1024): the replayed train step (device sampling,
    ``scan_steps=16``; after 6 replays, 3 blocks of 4 replays by events).

Prints one JSON line with the package's path, the card's name and every
number. Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m molkgnn_torch.tools.step_rates [--families kgnn,schnet,...]

It uses only names that the port has had since its point families and
ChIRoNet came in, so a second checkout can be timed by the same file:
``PYTHONPATH=<other checkout> python <this file>``. Compare two checkouts in
turns (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np
import torch

import molkgnn_torch
from molkgnn_torch.data.dataset import (
    QSAR_METRICS,
    Dataset,
    _split,
    make_synthetic_dataset,
)
from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
from molkgnn_torch.models.kgnn import MolKGNNNet
from molkgnn_torch.models.registry import get_family
from molkgnn_torch.ops import _build
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer

BATCH = 1024
FAMILIES = {"schnet": (8192, 1024), "dimenet_pp": (2048, 128),
            "spherenet": (512, 128), "chironet": (8192, 1024)}
# chip_smoke.py's scaffold set (its ACTIVE_SMILES and INACTIVE_SMILES).
SMILES = (
    [(1.0, s) for s in (
        "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
        "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "CC(=O)NC1=CC=C(O)C=C1",
        "ClC1=CC=C(C=C1)C(=O)O", "NC(=O)c1ccccc1", "CC(C)(C)c1ccc(O)cc1",
        "Oc1ccccc1")]
    + [(0.0, s) for s in (
        "CCO", "CC(=O)O", "CCN", "CCC", "CCCC", "CC(C)C", "CCOC", "CCS",
        "CNC", "COC", "CCCl", "CCBr", "CCF", "CC(N)=O", "CC(C)O", "CCCO",
        "CCCC(=O)O", "CCOC(=O)C", "CCCCCCCC", "CC1CCCCC1", "OCC(O)CO")])


def replayed_ms(trainer, warm, blocks, n):
    """ms a replayed step in each of ``blocks`` blocks of ``n`` replays,
    by CUDA events, after ``warm`` steps."""
    for _ in range(warm):
        trainer._graph_step()
    torch.cuda.synchronize()
    out = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            trainer._graph_step()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return out


def best_rate(fn, graphs, runs=3):
    """graphs/s of the best of ``runs`` synchronised calls after one."""
    fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return graphs / min(secs)


def kgnn_rates():
    ds = make_synthetic_dataset(num_graphs=8192)
    spec = spec_for_graphs(ds.graphs, BATCH)

    def flagship():
        gen = torch.Generator().manual_seed(0)
        return GNNModel(MolKGNNNet(num_layers=4, use_kernel=True,
                                   generator=gen), generator=gen)

    trainer = Trainer(flagship(), ds, spec, TrainConfig(
        batch_size=BATCH, progress=False, scan_steps=16,
        device_sampling=True))
    step = replayed_ms(trainer, 20, 6, 16)
    trainer = None
    gc.collect()
    model = flagship()
    pred = Predictor(model, {k: v.clone() for k, v in
                             model.state_dict().items()}, spec,
                     device="cuda")
    graphs = ds.graphs
    batches = [batch_graphs(graphs[s:s + BATCH], spec).to("cuda")
               for s in range(0, len(graphs), BATCH)]

    def forward():
        with torch.inference_mode():
            for b in batches:
                pred.model(b)

    library = graphs * 4
    return {
        "replayed_step_ms": step,
        "train_graphs_per_s": [BATCH * 1e3 / ms for ms in step],
        "serve_e2e_graphs_per_s": best_rate(
            lambda: pred.predict_graphs(graphs), len(graphs)),
        "serve_forward_graphs_per_s": best_rate(forward, len(graphs)),
        "screen_graphs_per_s": best_rate(
            lambda: pred.screen_library(library), len(library)),
    }


def chiro_molecules(n):
    from molkgnn_torch.chem.embed import embed_molecule
    from molkgnn_torch.chem.smiles import parse_smiles
    from molkgnn_torch.graphs.chiro import mol_to_chiro_graph

    conf = []
    for seed in range(8):
        for label, smi in SMILES:
            mol = parse_smiles(smi, add_hs=True)
            for a, p in zip(mol.atoms, embed_molecule(mol, seed=seed,
                                                      iterations=60)):
                a.x, a.y, a.z = map(float, p)
            conf.append(mol_to_chiro_graph(mol, y=label, idx=len(conf),
                                           smiles=smi))
    return [dataclasses.replace(conf[i % len(conf)], idx=i)
            for i in range(n)]


def family_step(name):
    from molkgnn_torch.data.synthetic import random_dataset

    n, b = FAMILIES[name]
    mols = (chiro_molecules(n) if name == "chironet"
            else random_dataset(seed=0, num_graphs=n))
    family = get_family(name)
    spec = family.make_spec(mols, b)
    ds = Dataset(name, mols, _split(np.random.default_rng(1), len(mols)),
                 list(QSAR_METRICS), "bce_with_logits")
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(family.make_encoder(generator=gen), generator=gen)
    trainer = Trainer(model, ds, spec, TrainConfig(
        batch_size=b, progress=False, scan_steps=16, oversample=True,
        device_sampling=True), device="cuda")
    step = replayed_ms(trainer, 6, 3, 4)
    return {"batch": b, "replayed_step_ms": step,
            "train_graphs_per_s": [b * 1e3 / ms for ms in step]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--families", default="kgnn," + ",".join(FAMILIES))
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    out = {"package": molkgnn_torch.__file__,
           "card": torch.cuda.get_device_name(0)}
    for name in args.families.split(","):
        t0 = time.perf_counter()
        out[name] = kgnn_rates() if name == "kgnn" else family_step(name)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
