"""Checkpoint files of the port, and the weight bridge from the JAX package.

``save_checkpoint``/``load_checkpoint`` write and read the port's own
checkpoint files: ``torch.save`` of a payload of tensors and plain values
(moved to the CPU), at ``path + ".pt"``, read back with
``weights_only=True``.

``from_torch_state_dict``/``load_torch_checkpoint`` import a checkpoint of
the reference PyTorch implementation (a PL ``.ckpt`` or a raw
``state_dict``) into the port's kgnn model: the port's ``state_dict()``
already has the reference's keys, so what they port from
``molkgnn_tpu/training/checkpoint.py`` is its checking: every target key
found, every shape equal, no key left over but the reference's dead ones.

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


# Reference GNNModel members that exist but are dead in its forward
# (lin1/lin2 are built beside ffn and never applied; the encoder's
# graph_embedding_linear is never called); SchNet's Gaussian offsets are a
# constant buffer. num_batches_tracked (BatchNorm bookkeeping) is skipped
# too. The same list as the JAX package's importer.
_IGNORED_TORCH_KEYS = (
    "lin1.", "lin2.", "gnn_model.graph_embedding_linear.",
    "gnn_model.dist_emb.offset",
)


def from_torch_state_dict(
    model: torch.nn.Module, state_dict: Any, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``model`` from a reference checkpoint's
    ``state_dict`` (str keys to tensors or arrays); load it with
    ``model.load_state_dict(sd, strict=True)``.

    The import is driven by the model's own keys: each, with ``prefix``
    put before it, must be in ``state_dict`` (else ``KeyError``) with the
    same shape (else ``ValueError``); values are cast to the model's
    dtypes. A key of ``state_dict`` that no target took raises
    ``ValueError``, except the reference's dead keys (``_IGNORED_TORCH_KEYS``
    after the prefix) and ``*num_batches_tracked``. Fixed kernel sets are
    not ported (ROADMAP A4), so a ``fixed_kernelconv_set`` key is left
    over and raises, as with the JAX CLI's model, which builds none.
    """
    sd = {str(k): v for k, v in dict(state_dict).items()}
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in model.state_dict().items():
        key = prefix + name
        if key not in sd:
            raise KeyError(f"reference state_dict missing '{key}' "
                           f"(for {name})")
        value = sd[key]
        value = (value.detach().cpu() if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch at '{key}': reference "
                f"{tuple(value.shape)} vs model {tuple(leaf.shape)}"
            )
        out[name] = value.to(leaf.dtype)
    used = {prefix + name for name in out}
    leftovers = [
        k for k in sd
        if k not in used
        and not k[len(prefix):].startswith(_IGNORED_TORCH_KEYS)
        and not k.endswith("num_batches_tracked")
    ]
    if leftovers:
        raise ValueError(
            "reference state_dict keys with no target in the model "
            f"(wrong model config?): {sorted(leftovers)[:8]}"
        )
    return out


def load_torch_checkpoint(
    path: str, model: torch.nn.Module, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """``from_torch_state_dict`` of a torch-saved file: a raw
    ``state_dict`` or a PL ``.ckpt`` (``{'state_dict': ...}``). The file is
    unpickled in full (a PL checkpoint holds more than tensors), so load
    only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return from_torch_state_dict(model, obj, prefix=prefix)


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
