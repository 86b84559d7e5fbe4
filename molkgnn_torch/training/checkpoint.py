"""Checkpoint files of the port, and the weight bridge from the JAX package.

``save_checkpoint``/``load_checkpoint`` write and read the port's own
checkpoint files: ``torch.save`` of a payload of tensors and plain values
(moved to the CPU), at ``path + ".pt"``, read back with
``weights_only=True``; in a data-parallel world rank 0 writes and every
rank reads.

``from_torch_state_dict``/``load_torch_checkpoint`` import a checkpoint of
the reference PyTorch implementation (a PL ``.ckpt`` or a raw
``state_dict``) into the port's model of any ported family: the port's
``state_dict()`` already has the reference's keys, so what they port from
``molkgnn_tpu/training/checkpoint.py`` is its checking: every target key
found, every shape equal, no key left over but the reference's dead ones.

``from_jax_variables`` takes a ``GNNModel`` variable tree of the JAX
package (``{'params': ..., 'batch_stats': ...}``, leaves as numpy arrays)
for any of the five families and returns the port's ``state_dict``, whose
keys are those of the reference PyTorch Lightning checkpoint. It is the
inverse of the key maps in
``molkgnn_tpu/training/checkpoint.py::from_torch_state_dict``
(``_enc_key``, ``_schnet_key``, ``_dimenet_key``, ``_spherenet_key``,
``_chiro_key``):

  * linear layers: the JAX kernel [in, out] becomes weight [out, in];
  * embeddings ([num, H]) and the radial frequencies pass through;
  * BatchNorm: weight/bias pass through; batch_stats mean/var become
    running_mean/running_var;
  * KernelConv tensors and score weights pass through unchanged, from
    ``encoder/gnn/layer{i}/kernelconv{d}`` to
    ``gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d-1}``, and a
    fixed set's score weights from ``.../fixed_kernelconv{d}`` to
    ``...fixed_kernelconv_set.{d-1}``;
  * the point families' blocks map by name: ``mlp1_{l}`` to
    ``update_es.{l}.mlp.0``, ``output{b}`` to ``output_blocks.{b}``,
    ``interaction{b}/before_skip{k}`` to
    ``interaction_blocks.{b}.layers_before_skip.{k}``, ``lin{k}`` of an
    output block to ``lins.{k}``, and so on;
  * ChIRoNet's under ``gnn_model.encoder``: ``EConv``/``ChiralEConv``
    (``nn/lin{k}`` to ``nn.linear_layers.{k}``, the root weight ``root``
    to ``lin.weight``, transposed), ``GAT{g}``/``ChiralGAT{g}`` to
    ``Graph_Embedder.GAT_layers.{g}``/``ChiralMessagePassingEncoder.
    ChiralGATLayers.{g}`` (``lin`` transposed; ``att_src``, ``att_dst``,
    ``bias`` as they are), and ``InternalCoordinateEncoder/{MLP}/lin{k}``
    to ``InternalCoordinateEncoder.{MLP}.linear_layers.{k}``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from molkgnn_torch.parallel.data_parallel import is_writer

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
    half a file. Under ``torch.distributed`` (one process a rank, the state
    replicated) rank 0 alone writes; every rank may load."""
    if not is_writer():
        return
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
    ``state_dict`` (str keys to tensors or arrays), any ported family; load
    it with
    ``model.load_state_dict(sd, strict=True)``.

    The import is driven by the model's own keys: each, with ``prefix``
    put before it, must be in ``state_dict`` (else ``KeyError``) with the
    same shape (else ``ValueError``); values are cast to the model's
    dtypes. A key of ``state_dict`` that no target took raises
    ``ValueError``, except the reference's dead keys (``_IGNORED_TORCH_KEYS``
    after the prefix) and ``*num_batches_tracked``. A model with fixed
    kernel sets takes their score weights from
    ``...fixed_kernelconv_set.{d-1}.*``; their kernel tensors are constants
    of the model, not in its ``state_dict()``, so a checkpoint that holds
    them (the reference's fixed tensors) has them left over and raises, as
    the JAX importer does (its template has no leaf for them either).
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


def _kgnn_key(collection: str, path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(port state_dict key, transpose) for one leaf of a kgnn tree."""
    if collection == "batch_stats":
        if path[0] == "encoder" and path[1] in (
            "node_batch_norm",
            "edge_batch_norm",
        ):
            leaf = {"mean": "running_mean", "var": "running_var"}[path[2]]
            return f"gnn_model.{path[1]}.{leaf}", False
    elif path[0] == "encoder":
        rest = path[1:]
        if rest[0] in ("node_batch_norm", "edge_batch_norm"):
            return f"gnn_model.{rest[0]}.{rest[1]}", False
        if rest[0].startswith("graph_embedding_lin"):
            leaf = "weight" if rest[1] == "kernel" else rest[1]
            return f"gnn_model.{rest[0]}.{leaf}", rest[1] == "kernel"
        if rest[0] == "gnn" and rest[1].startswith("layer"):
            conv = rest[2]
            sets = (("fixed_kernelconv", "fixed_kernelconv_set"),
                    ("kernelconv", "trainable_kernelconv_set"))
            for jax_name, set_name in sets:
                if conv.startswith(jax_name):
                    i, d = int(rest[1][len("layer"):]), int(conv[-1])
                    return (f"gnn_model.gnn.layers.{i}.{set_name}."
                            f"{d - 1}.{rest[3]}", False)
    raise KeyError(f"no port key for {collection} path {path}")


def _leaf(rest):
    """(torch leaf name, transpose) of a JAX leaf: kernel -> weight."""
    return ("weight", True) if rest[-1] == "kernel" else (rest[-1], False)


def _schnet_key(rest):
    name = rest[0]
    if name == "init_v":
        return "gnn_model.init_v.weight", False
    leaf, transpose = _leaf(rest)
    if name in ("uu1", "uu2"):
        return f"gnn_model.update_u.lin{name[-1]}.{leaf}", transpose
    base, _, layer = name.rpartition("_")
    if base in ("mlp1", "mlp2"):
        seq = {"mlp1": 0, "mlp2": 2}[base]
        return f"gnn_model.update_es.{layer}.mlp.{seq}.{leaf}", transpose
    if base == "lin":
        return f"gnn_model.update_es.{layer}.lin.{leaf}", transpose
    if base in ("uv1", "uv2"):
        return f"gnn_model.update_vs.{layer}.lin{base[-1]}.{leaf}", transpose
    raise KeyError(f"no port key for SchNet path {rest}")


def _skip_sub(name):
    """before_skip{k}/after_skip{k} -> layers_*_skip.{k}, else None."""
    for ours, theirs in (("before_skip", "layers_before_skip"),
                         ("after_skip", "layers_after_skip")):
        if name.startswith(ours):
            return f"{theirs}.{int(name[len(ours):])}"
    return None


def _out_sub(sub):
    """lin{k} -> lins.{k}; lin_rbf, lin_up and lin pass through."""
    if sub in ("lin_rbf", "lin_up", "lin"):
        return sub
    if sub.startswith("lin"):
        return f"lins.{int(sub[len('lin'):])}"
    raise KeyError(f"no port key for output sublayer {sub}")


def _block_sub(rest):
    """The sublayer path of an interaction/update_e leaf."""
    sk = _skip_sub(rest[1])
    return f"{sk}.{rest[2]}" if sk else rest[1]


def _dimenet_key(rest):
    name = rest[0]
    if name == "rbf_freq":
        return "gnn_model.rbf.freq", False
    if name == "emb":
        return "gnn_model.emb.emb.weight", False
    leaf, transpose = _leaf(rest)
    if name in ("emb_lin_rbf", "emb_lin"):
        return f"gnn_model.emb.{name[len('emb_'):]}.{leaf}", transpose
    if name.startswith("output"):
        b = int(name[len("output"):])
        return (f"gnn_model.output_blocks.{b}.{_out_sub(rest[1])}.{leaf}",
                transpose)
    if name.startswith("interaction"):
        b = int(name[len("interaction"):])
        return (f"gnn_model.interaction_blocks.{b}.{_block_sub(rest)}."
                f"{leaf}", transpose)
    raise KeyError(f"no port key for DimeNet++ path {rest}")


def _spherenet_key(rest):
    name = rest[0]
    if name == "rbf_freq":
        return "gnn_model.emb.dist_emb.freq", False
    leaf, transpose = _leaf(rest)
    if name == "init_e":
        if rest[1] == "emb":
            return "gnn_model.init_e.emb.weight", False
        return f"gnn_model.init_e.{rest[1]}.{leaf}", transpose
    if name == "init_v":
        return f"gnn_model.init_v.{_out_sub(rest[1])}.{leaf}", transpose
    if name.startswith("update_e"):
        layer = int(name[len("update_e"):])
        return (f"gnn_model.update_es.{layer}.{_block_sub(rest)}.{leaf}",
                transpose)
    if name.startswith("update_v"):
        layer = int(name[len("update_v"):])
        return (f"gnn_model.update_vs.{layer}.{_out_sub(rest[1])}.{leaf}",
                transpose)
    raise KeyError(f"no port key for SphereNet path {rest}")


def _chiro_key(rest):
    base = "gnn_model.encoder"
    name, sub = rest[0], rest[1:]

    def mlp(mod, lin, leaf):
        k = int(lin[len("lin"):])
        key, transpose = _leaf((leaf,))
        return f"{mod}.linear_layers.{k}.{key}", transpose

    def nnconv(mod):
        if sub[0] == "nn":
            return mlp(f"{mod}.nn", sub[1], sub[2])
        if sub[0] == "root":
            return f"{mod}.lin.weight", True
        if sub[0] == "bias":
            return f"{mod}.bias", False
        raise KeyError(f"no port key for NNConv path {rest}")

    def gat(mod):
        if sub[0] == "lin":
            return f"{mod}.lin.weight", True
        if sub[0] in ("att_src", "att_dst", "bias"):
            return f"{mod}.{sub[0]}", False
        raise KeyError(f"no port key for GAT path {rest}")

    cmp = f"{base}.ChiralMessagePassingEncoder"
    if name == "EConv":
        return nnconv(f"{base}.Graph_Embedder.EConv")
    if name == "ChiralEConv":
        return nnconv(f"{cmp}.ChiralEConv")
    if name.startswith("ChiralGAT"):
        return gat(f"{cmp}.ChiralGATLayers.{int(name[len('ChiralGAT'):])}")
    if name.startswith("GAT"):
        return gat(f"{base}.Graph_Embedder.GAT_layers."
                   f"{int(name[len('GAT'):])}")
    if name == "InternalCoordinateEncoder":
        return mlp(f"{base}.InternalCoordinateEncoder.{sub[0]}", sub[1],
                   sub[2])
    raise KeyError(f"no port key for ChIRoNet path {rest}")


def _target_key_fn(variables: Any):
    """(collection, path) -> (port key, transpose) for the tree's encoder
    family, told apart by its structure as the JAX importer tells them:
    kgnn owns the BatchNorms, ChIRoNet the EConv, DimeNet++ the emb_lin
    pair, SphereNet the init_e block, SchNet a flat init_v table."""
    enc = variables.get("params", {}).get("encoder", {})
    if "node_batch_norm" in enc:
        return _kgnn_key
    for marker, fn in (("EConv", _chiro_key), ("emb_lin", _dimenet_key),
                       ("init_e", _spherenet_key), ("init_v", _schnet_key)):
        if marker in enc:
            def key(collection, path, fn=fn):
                if path[0] == "encoder":
                    return fn(path[1:])
                raise KeyError(f"no port key for {collection} path {path}")
            return key
    raise KeyError(
        f"unrecognised encoder family (keys: {sorted(enc)[:6]})")


def from_jax_variables(variables: Any) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX ``GNNModel`` tree of any of the
    five families (kgnn, SchNet, DimeNet++, SphereNet, ChIRoNet).

    Load the result with ``model.load_state_dict(sd, strict=True)``.
    Raises KeyError for a leaf with no counterpart in the port.
    """
    encoder_key = _target_key_fn(variables)
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            if path[0] == "ffn":
                key, transpose = _leaf(path)
                key = f"ffn.{key}"
            else:
                key, transpose = encoder_key(collection, path)
            arr = np.asarray(leaf)
            if transpose:
                arr = arr.T
            out[key] = torch.tensor(arr)
    return out
