"""The system under test: ``molkgnn_torch``'s Trainer, built from a cell's
files. The one module of the benchmark that imports the program.

The benchmark hands the program the traffic's molecules (as the program's
``MolGraph``, with the program deriving its own fields, batch spec and
device dataset) and its own initial weights (copied into the program's
parameters by name); everything else is the program's own: the model, the
device sampler, the captured train step, the fit loop and its
validation.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset
from molkgnn_torch.graphs.molgraph import MolGraph
from molkgnn_torch.models.registry import get_family
from molkgnn_torch.ops import _build
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.trainer import TrainConfig, Trainer


def build_kernels() -> float:
    """Compile the program's CUDA sources (cached in the checkout)."""
    return _build.build_all()


def dataset(traffic, cfg: dict, batch: int) -> Dataset:
    """The program's dataset of the traffic's entries: one ``MolGraph`` a
    unique molecule, and a shallow copy an entry carrying the entry's label
    and index. The family's spec is taken over the unique molecules first,
    so that what the program derives and keeps on a molecule (its degree
    fields, its radius graph) is derived once and shared by its entries."""
    unique = [
        MolGraph(x=m.x, p=m.p, edge_index=m.edge_index,
                 edge_attr=m.edge_attr, atomic_num=m.atomic_num).with_fields()
        for m in traffic.molecules
    ]
    get_family(cfg["family"]).make_spec(unique, batch)
    graphs = []
    for i, (k, y) in enumerate(zip(traffic.mol_of_entry, traffic.labels)):
        g = copy.copy(unique[int(k)])
        g.y, g.idx = float(y), i
        graphs.append(g)
    return Dataset(name="bench", graphs=graphs,
                   split={k: np.asarray(v) for k, v in traffic.split.items()},
                   metrics=list(QSAR_METRICS), loss_name="bce_with_logits")


def trainer(cfg: dict, spec_traffic: dict, ds: Dataset,
            weights: Dict[str, torch.Tensor], seed: int, device,
            log_dir: str, dtype=torch.float32) -> Trainer:
    """The program's Trainer of configuration ``cfg`` on ``ds``, its
    parameters (of ``dtype``) set to ``weights``."""
    family = get_family(cfg["family"])
    batch = spec_traffic["batch_size"]
    model = GNNModel(family.make_encoder(**cfg["encoder"]),
                     ffn_dropout_rate=cfg["head"]["ffn_dropout_rate"])
    model.to(device=device, dtype=dtype)
    params = dict(model.named_parameters())
    if {k: tuple(v.shape) for k, v in params.items()} != {
            k: tuple(v.shape) for k, v in weights.items()}:
        raise ValueError("the program's parameters are not the reference's "
                         "(names or shapes differ)")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    spec = family.make_spec(ds.graphs, batch)
    opt = cfg["optimizer"]
    steps = -(-len(ds.split["train"]) // batch)
    config = TrainConfig(
        batch_size=batch,
        max_epochs=1,
        peak_lr=opt["peak_lr"],
        end_lr=opt["end_lr"],
        warmup_iterations=opt["warmup_iterations"],
        weight_decay=opt["weight_decay"],
        tot_iterations=steps * spec_traffic["schedule_epochs"] + 2,
        seed=seed,
        oversample=True,
        device_sampling=spec_traffic["device_sampling"],
        scan_steps=spec_traffic["scan_steps"],
        progress=False,
        log_dir=log_dir,
    )
    return Trainer(model, ds, spec, config, device=device)


def step_call(tr: Trainer):
    """The call by which ``fit`` runs a train step on this device: the
    captured step on the card, the eager one elsewhere."""
    graphed = tr.config.scan_steps > 1 and tr.device.type == "cuda"
    return tr._graph_step if graphed else tr._device_step


def first_gradients(tr: Trainer) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer took it, from its state
    after that step: Adam's first moment over (1 - beta1)."""
    opt = tr.optimizer
    names = {id(p): n for n, p in tr.model.named_parameters()}
    return {names[id(p)]: (m / (1.0 - opt.beta1)).detach().clone()
            for p, m in zip(opt.params, opt.exp_avg)}


def valid_predictions(tr: Trainer):
    """(entry ids, logits) of the validation split, through the Trainer's
    own evaluation (the path ``fit`` validates by)."""
    ids = np.asarray(tr.dataset.split["valid"])
    _, pred = tr._predictions("valid")
    return ids, np.asarray(pred, np.float64)


def state(tr: Trainer) -> Dict[str, torch.Tensor]:
    """The model's parameters and statistics, copied to the host."""
    return {k: v.detach().cpu().clone()
            for k, v in tr.model.state_dict().items()}
