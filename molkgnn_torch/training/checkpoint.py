"""Checkpoint files of the port, and the weight bridge from the JAX package.

``save_checkpoint``/``load_checkpoint`` write and read the port's own
checkpoint files: ``torch.save`` of a payload of tensors and plain values
(moved to the CPU), at ``path + ".pt"``, read back with
``weights_only=True``.

``from_jax_variables`` takes a ``GNNModel(MolKGNNNet)`` variable tree of the
JAX package (``{'params': ..., 'batch_stats': ...}``, leaves as numpy
arrays) and returns the port's ``state_dict``, whose keys are those of the
reference PyTorch Lightning checkpoint. It is the inverse of the key map in
``molkgnn_tpu/training/checkpoint.py::from_torch_state_dict``:

  * linear layers: the JAX kernel [in, out] becomes weight [out, in];
  * BatchNorm: weight/bias pass through; batch_stats mean/var become
    running_mean/running_var;
  * KernelConv tensors and score weights pass through unchanged, from
    ``encoder/gnn/layer{i}/kernelconv{d}`` to
    ``gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d-1}``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

SUFFIX = ".pt"


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (tensors on any device, dicts, plain values) to
    ``path + ".pt"``, through a temporary file so that a reader never sees
    half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}{SUFFIX}.tmp{os.getpid()}"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path + SUFFIX)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of ``save_checkpoint(path, ...)``, tensors on the CPU."""
    return torch.load(path + SUFFIX, map_location="cpu", weights_only=True)


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _target_key(collection: str, path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(port state_dict key, transpose) for one JAX leaf path."""
    if collection == "batch_stats":
        if path[0] == "encoder" and path[1] in (
            "node_batch_norm",
            "edge_batch_norm",
        ):
            leaf = {"mean": "running_mean", "var": "running_var"}[path[2]]
            return f"gnn_model.{path[1]}.{leaf}", False
    elif path[0] == "ffn":
        return f"ffn.{'weight' if path[1] == 'kernel' else path[1]}", (
            path[1] == "kernel"
        )
    elif path[0] == "encoder":
        rest = path[1:]
        if rest[0] in ("node_batch_norm", "edge_batch_norm"):
            return f"gnn_model.{rest[0]}.{rest[1]}", False
        if rest[0].startswith("graph_embedding_lin"):
            leaf = "weight" if rest[1] == "kernel" else rest[1]
            return f"gnn_model.{rest[0]}.{leaf}", rest[1] == "kernel"
        if (
            rest[0] == "gnn"
            and rest[1].startswith("layer")
            and rest[2].startswith("kernelconv")
        ):
            i, d = int(rest[1][len("layer"):]), int(rest[2][-1])
            return (
                f"gnn_model.gnn.layers.{i}.trainable_kernelconv_set."
                f"{d - 1}.{rest[3]}",
                False,
            )
    raise KeyError(f"no port key for {collection} path {path}")


def from_jax_variables(variables: Any) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX ``GNNModel(MolKGNNNet)`` tree.

    Load the result with ``model.load_state_dict(sd, strict=True)``.
    Raises KeyError for a leaf with no counterpart in the port (e.g. fixed
    kernel sets, not ported yet).
    """
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            key, transpose = _target_key(collection, path)
            arr = np.asarray(leaf)
            if transpose:
                arr = arr.T
            out[key] = torch.tensor(arr)
    return out
