"""Model registry: gnn_type -> encoder and batch family.

Port of ``molkgnn_tpu/models/registry.py``. Each entry gives the encoder
class (with the reference's default hyperparameters), the batch-spec
builder (the point families' with their cutoff), the host collate of its
batch family, and the encoder attribute holding the graph-embedding width,
which sizes ``GNNModel``'s head (ChIRoNet's ``out_dim`` follows its output
mode; the JAX package's head infers its width and names ``f_h``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

GNN_TYPES = ("kgnn", "schnet", "dimenet_pp", "spherenet", "chironet")


@dataclasses.dataclass
class ModelFamily:
    name: str
    make_encoder: Callable[..., Any]
    make_spec: Callable[..., Any]  # (graphs, batch_size, **kw) -> spec
    collate: Callable[..., Any]  # (graphs, spec) -> batch
    out_dim_field: str  # encoder attribute holding the embedding width


def _kgnn() -> ModelFamily:
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet

    return ModelFamily("kgnn", MolKGNNNet, spec_for_graphs, batch_graphs,
                       "graph_embedding_dim")


def _point_family(name, encoder, cutoff, **geometry) -> ModelFamily:
    from molkgnn_torch.graphs.geometric import (
        batch_points,
        point_spec_for_graphs,
    )

    def make_spec(graphs, batch_size, cutoff=cutoff, **kw):
        return point_spec_for_graphs(graphs, batch_size, cutoff=cutoff,
                                     **geometry, **kw)

    return ModelFamily(name, encoder, make_spec, batch_points,
                       "out_channels")


def _schnet() -> ModelFamily:
    from molkgnn_torch.models.schnet import SchNet

    return _point_family("schnet", SchNet, 10.0)


def _dimenet_pp() -> ModelFamily:
    from molkgnn_torch.models.dimenetpp import DimeNetPP

    return _point_family("dimenet_pp", DimeNetPP, 5.0, with_triplets=True)


def _spherenet() -> ModelFamily:
    from molkgnn_torch.models.spherenet import SphereNet

    return _point_family("spherenet", SphereNet, 5.0, with_torsion=True)


def _chironet() -> ModelFamily:
    from molkgnn_torch.graphs.chiro import batch_chiro, chiro_spec_for_graphs
    from molkgnn_torch.models.chironet import ChIRoNet

    return ModelFamily("chironet", ChIRoNet, chiro_spec_for_graphs,
                       batch_chiro, "out_dim")


_FACTORIES: Dict[str, Callable[[], ModelFamily]] = {
    "kgnn": _kgnn,
    "schnet": _schnet,
    "dimenet_pp": _dimenet_pp,
    "spherenet": _spherenet,
    "chironet": _chironet,
}


def get_family(gnn_type: str) -> ModelFamily:
    if gnn_type not in _FACTORIES:
        raise ValueError(
            f"unknown gnn_type {gnn_type!r}; expected one of {GNN_TYPES}"
        )
    return _FACTORIES[gnn_type]()


def embedding_width(encoder) -> int:
    """The graph-embedding width of ``encoder``, from its family's
    ``out_dim_field``."""
    for name in GNN_TYPES:
        family = get_family(name)
        if isinstance(encoder, family.make_encoder):
            return getattr(encoder, family.out_dim_field)
    raise TypeError(f"{type(encoder).__name__} is not a registered encoder")
