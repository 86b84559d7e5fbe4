"""Inference / serving path: trained weights -> batched predictor.

Port of ``molkgnn_tpu/serving/predictor.py`` on one device, for every
batch family, dispatched on the spec's type: kgnn (``BatchSpec``), the
point clouds of SchNet, DimeNet++ and SphereNet (``PointBatchSpec``) and
ChIRoNet's internal-coordinate graphs (``ChiroBatchSpec``):

  * ``predict_graphs``: chunked batching of any number of molecules through
    one fixed-shape ``BatchSpec`` (each chunk packed on the host, the last
    padded and its padding masked out), raw logits or sigmoid
    probabilities, and optional graph embeddings;
  * ``screen_library``: a whole library scored from the device. Each slab
    of molecules is flat-packed once and copied to the device, every batch
    is assembled there, and the slab's id blocks go through one CUDA graph
    replayed per block (``serving/blocks.py``), with one readback a slab;
  * ``predict_smiles``: SMILES in (the port's chemistry), scores out, NaN
    where a SMILES does not parse (or, for ChIRoNet, has no dihedral);
  * ``export``/``load_exported``: the eval forward as a ``torch.export``
    program (the scorer kernel a registered op in it) with the spec and
    its family; loading needs no model code.

A spec of another type raises. ``screen_library(mesh=)`` screens across
the ranks of a data mesh (``parallel/data_parallel.py::make_mesh``): each
rank scores its share of every slab's blocks, and every rank returns the
whole library's scores.

On the card, float32 products run in full float32: TF32 is switched off
for matrix products and cuDNN, because the permutation argmax of the score
products would otherwise move with the lost digits.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from molkgnn_torch.graphs.batch import BatchSpec, GraphBatch
from molkgnn_torch.graphs.chiro import ChiroBatch, ChiroBatchSpec
from molkgnn_torch.graphs.geometric import PointBatch, PointBatchSpec
from molkgnn_torch.graphs.molgraph import MolGraph
from molkgnn_torch.training.metrics import sigmoid

# extra_files entry of an exported artifact: the spec, its batch family
# and the device the program was exported on. An artifact without a family
# is a kgnn one.
SPEC_FILE = "molkgnn_spec.json"
# Batch family name -> (spec type, batch type).
FAMILIES = {"kgnn": (BatchSpec, GraphBatch),
            "point": (PointBatchSpec, PointBatch),
            "chiro": (ChiroBatchSpec, ChiroBatch)}


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``device`` or, when None, the card. Raises when the card is asked for
    (explicitly or by default) and CUDA is absent: there is no silent CPU
    fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def spec_family(spec) -> str:
    """The batch family of ``spec`` ("kgnn", "point" or "chiro"); a spec of
    another type raises."""
    for name, (spec_type, _) in FAMILIES.items():
        if isinstance(spec, spec_type):
            return name
    raise NotImplementedError(
        f"{type(spec).__name__} is not a batch spec of molkgnn_torch; "
        "BatchSpec, PointBatchSpec and ChiroBatchSpec are"
    )


def host_pipeline_for_spec(spec):
    """(mol -> graph featurizer, collate) for a spec's batch family: the
    point families read the kgnn featurisation's atomic numbers and
    positions (``mol_to_graph``) and pack with ``batch_points``; kgnn packs
    with ``batch_graphs``; ChIRoNet featurizes with ``mol_to_chiro_graph``
    (None for a molecule with no dihedral) and packs with
    ``batch_chiro``."""
    from molkgnn_torch.chem.features import mol_to_graph

    family = spec_family(spec)
    if family == "chiro":
        from molkgnn_torch.graphs.chiro import batch_chiro, mol_to_chiro_graph

        return mol_to_chiro_graph, batch_chiro
    if family == "point":
        from molkgnn_torch.graphs.geometric import batch_points

        return mol_to_graph, batch_points
    from molkgnn_torch.graphs.batch import batch_graphs

    return mol_to_graph, batch_graphs


def device_pipeline(spec):
    """(build(graphs, device) -> device dataset, gather(data, ids, spec) ->
    batch) for a spec's batch family: ``device_points`` for the point
    families, ``device_chiro`` for ChIRoNet, ``device_pack`` for kgnn."""
    family = spec_family(spec)
    if family == "chiro":
        from molkgnn_torch.graphs.device_chiro import (
            DeviceChiroDataset,
            gather_chiro,
        )

        return DeviceChiroDataset.from_graphs, gather_chiro
    if family == "point":
        from molkgnn_torch.graphs.device_points import (
            DevicePointDataset,
            gather_points,
        )

        return (lambda graphs, device: DevicePointDataset.from_graphs(
            graphs, spec, device), gather_points)
    from molkgnn_torch.graphs.device_pack import DeviceDataset, gather_batch
    from molkgnn_torch.graphs.packed import PackedGraphs

    return (lambda graphs, device: DeviceDataset.from_packed(
        PackedGraphs.from_graphs(graphs), device), gather_batch)


class Predictor:
    """Wraps a GNNModel and its weights for fixed-shape batched inference."""

    def __init__(
        self,
        model: nn.Module,
        state_dict: Mapping[str, torch.Tensor],
        spec,
        device: Optional[str | torch.device] = None,
        collate=None,
    ):
        spec_family(spec)  # raises for a family not ported yet
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.collate = collate or host_pipeline_for_spec(spec)[1]
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.spec = spec
        # Per slab of the last screen_library call: molecules, and the host
        # seconds of the capacity check and of the flat packing (with the
        # copy to the device).
        self.screen_slabs: List[dict] = []

    @classmethod
    def from_trainer(cls, trainer, tag: str = "last") -> "Predictor":
        """A Predictor of the trainer's checkpoint ``tag`` (its current
        weights if there is none), on its device. The model is a copy: the
        trainer's own stays as it is."""
        ck = trainer._ckpts.get(tag)
        sd = ck["model"] if ck is not None else trainer.model.state_dict()
        # The dropout generators are the run's: the copy, in eval mode,
        # draws nothing and shares none of them.
        memo = {id(m.generator): None for m in trainer.model.modules()
                if getattr(m, "generator", None) is not None}
        model = copy.deepcopy(trainer.model, memo)
        return cls(model, sd, trainer.spec, device=trainer.device)

    @classmethod
    def from_checkpoint(
        cls, model: nn.Module, path: str, spec, collate=None,
        device: Optional[str | torch.device] = None,
    ) -> "Predictor":
        """A Predictor of a port checkpoint (``Trainer``'s
        ``checkpoint_dir/{tag}``, ``path`` without its ``.pt``)."""
        from molkgnn_torch.training.checkpoint import load_checkpoint

        return cls(model, load_checkpoint(path)["model"], spec,
                   device=device, collate=collate)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_graphs(
        self,
        graphs: Sequence[MolGraph],
        probabilities: bool = False,
        return_embeddings: bool = False,
    ):
        b = self.spec.num_graphs
        scores: List[torch.Tensor] = []
        embs: List[torch.Tensor] = []
        masks: List[np.ndarray] = []
        for start in range(0, len(graphs), b):
            batch = self.collate(list(graphs[start : start + b]), self.spec)
            masks.append(batch.graph_mask.numpy())
            pred, emb = self.model(batch.to(self.device))
            scores.append(pred)
            if return_embeddings:
                embs.append(emb)
        # One device -> host readback.
        mask = np.concatenate(masks) if masks else np.zeros((0,), bool)
        out = (
            torch.cat(scores).cpu().numpy()[mask]
            if scores
            else np.zeros((0,))
        )
        if probabilities:
            out = sigmoid(out)
        if return_embeddings:
            emb_out = (
                torch.cat(embs).cpu().numpy()[mask]
                if embs
                else np.zeros((0, 0))
            )
            return out, emb_out
        return out

    # ------------------------------------------------------------------
    def _batch_resource_counts(self, graphs):
        """Per-graph resource counts, the spec's capacity vector and their
        names: the host-side overflow check that the device gather cannot
        make (it truncates silently)."""
        spec = self.spec
        family = spec_family(spec)
        if family == "chiro":
            from molkgnn_torch.graphs.chiro import COUNT_NAMES

            rows = [g.counts() for g in graphs]
            caps, names = spec.capacities(), COUNT_NAMES
        elif family == "point":
            from molkgnn_torch.graphs.geometric import molecule_geometry

            rows = []
            for g in graphs:
                e, t, q = molecule_geometry(
                    g, spec.cutoff, spec.with_triplets, spec.with_torsion)
                rows.append((g.num_nodes, e.shape[1], t.shape[1],
                             q.shape[1]))
            caps = (spec.num_nodes, spec.num_edges, spec.num_triplets,
                    spec.num_quads)
            names = ("nodes", "edges", "triplets", "quads")
        else:
            rows = [
                (g.num_nodes, g.num_edges)
                + tuple(g.with_fields().fields[d].count for d in range(1, 5))
                for g in graphs
            ]
            caps = (spec.num_nodes, spec.num_edges) + tuple(
                spec.deg_capacity)
            names = ("nodes", "edges", "deg1", "deg2", "deg3", "deg4")
        return (np.asarray(rows, np.int64).reshape(-1, len(caps)),
                np.asarray(caps, np.int64), names)

    def screen_library(
        self,
        graphs: Sequence[MolGraph],
        probabilities: bool = False,
        slab: int = 100_000,
        mesh=None,
    ) -> np.ndarray:
        """Scores of a whole molecule library, in order: the reference's
        production use (ranking a PubChem HTS library by score).

        Each slab of ``slab`` molecules is flat-packed on the host once
        and copied to the device (``device_pipeline``: ``DeviceDataset``,
        ``DevicePointDataset`` with the molecules' geometry, or
        ``DeviceChiroDataset``);
        every padded batch is assembled there and the slab's id blocks are
        scored by one CUDA graph replayed per block on the card (eager
        forwards on the CPU), with one readback a slab. Every batch is
        checked on the host against the spec's capacities first: the device
        gather would truncate an overflowing batch silently, so a library
        with molecules larger than the spec was built for raises
        ``ValueError``. Each slab captures its own graph (one eager forward
        of its first block); see ``serving/blocks.py``. The graph and the
        slab's device tensors are released when the call returns.

        ``mesh``: data-parallel screening, every rank calling with the
        same library. Each rank packs each slab onto its device (the
        dataset replicated), scores blocks ``rank, rank + world, ...`` of
        the slab's blocks padded with all ``-1`` blocks to a multiple of
        the world size, and gathers the ranks' scores back in block order
        (``serving/blocks.py``): the scores are the single-device path's,
        on every rank.
        """
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh for a Predictor on "
                f"{self.device.type}")
        from molkgnn_torch.graphs.device_pack import pad_ids
        from molkgnn_torch.serving.blocks import BlockScorer

        blocks = BlockScorer(self.model, self.spec)
        build = device_pipeline(self.spec)[0]
        b = self.spec.num_graphs
        counts, caps, names = self._batch_resource_counts(graphs)
        self.screen_slabs = []
        outs = []
        for s0 in range(0, len(graphs), slab):
            t0 = time.perf_counter()
            chunk = list(graphs[s0 : s0 + slab])
            ids = np.arange(len(chunk), dtype=np.int32)
            idm = np.stack(
                [pad_ids(ids[s : s + b], b) for s in range(0, len(chunk), b)]
            )
            rows = np.zeros((idm.size, len(caps)), np.int64)
            rows[: len(chunk)] = counts[s0 : s0 + len(chunk)]
            sums = rows.reshape(idm.shape[0], b, len(caps)).sum(axis=1)
            over_rows = np.nonzero((sums > caps).any(axis=1))[0]
            if over_rows.size:
                over = [
                    f"{n}: {int(v)} > cap {int(c)}"
                    for n, v, c in zip(names, sums[over_rows[0]], caps)
                    if v > c
                ]
                raise ValueError(
                    "screen_library: batch exceeds the spec's capacities "
                    f"({'; '.join(over)}) — the library contains molecules "
                    "larger than the spec was built for; rebuild the spec "
                    "over the library (spec_for_graphs, "
                    "point_spec_for_graphs, chiro_spec_for_graphs)"
                )
            t1 = time.perf_counter()
            data = build(chunk, self.device)
            t2 = time.perf_counter()
            preds = blocks(
                data, torch.as_tensor(idm, device=self.device), mesh=mesh,
            ).cpu().numpy().reshape(-1)
            outs.append(preds[(idm >= 0).reshape(-1)])
            self.screen_slabs.append({
                "molecules": len(chunk), "check_s": t1 - t0,
                "pack_s": t2 - t1,
            })
        out = np.concatenate(outs) if outs else np.zeros((0,))
        if probabilities:
            out = sigmoid(out)
        return out

    # ------------------------------------------------------------------
    def export(self, path: str):
        """Write the eval forward as a ``torch.export`` program at ``path``
        (``torch.export.save``), with the spec and its batch family in its
        extra files: an artifact that ``load_exported`` serves without the
        model code. Returns the ``ExportedProgram``.

        The program takes the batch's leaves (``GraphBatch.leaves``,
        ``PointBatch.leaves`` or ``ChiroBatch.leaves``, the JAX package's
        tree order) at the spec's shapes and returns
        (prediction [B], graph embedding [B, H]). It is traced on this
        Predictor's device, whose tensors it keeps (parameters, and the
        devices of tensors the forward creates), so it serves on that
        device type only. With ``use_kernel=True`` the scorer is one
        ``molkgnn.support_score`` node a layer."""
        family = spec_family(self.spec)
        if family == "chiro":
            from molkgnn_torch.graphs.chiro import template_graph

            example = template_graph()
        else:
            example = _two_atoms(self.spec)
        leaves = self.collate([example], self.spec).to(self.device).leaves()
        with torch.no_grad():
            program = torch.export.export(
                _LeafForward(self.model, FAMILIES[family][1]), tuple(leaves))
        meta = {"spec": dataclasses.asdict(self.spec), "family": family,
                "device": self.device.type}
        with open(path, "wb") as f:  # a file object: any name will do
            torch.export.save(program, f,
                              extra_files={SPEC_FILE: json.dumps(meta)})
        return program

    @staticmethod
    def load_exported(path: str, device: Optional[str | torch.device] = None):
        """Load an ``export`` artifact; returns ``(call(batch) -> (pred,
        emb), spec)``. No model code is imported: only the scorer op's
        registration (``ops/support_score.py``). ``device`` (default the
        card) must be the device type the program was exported on; the
        batch is copied there, and the outputs stay there."""
        import molkgnn_torch.ops.support_score  # noqa: F401 (the op)

        device = resolve_device(device)
        extra = {SPEC_FILE: ""}
        with open(path, "rb") as f:
            program = torch.export.load(f, extra_files=extra)
        meta = json.loads(extra[SPEC_FILE])
        if meta["device"] != device.type:
            raise ValueError(
                f"{path} was exported on {meta['device']}; it serves there "
                f"only (export it again on {device.type})"
            )
        fields = meta["spec"]
        family = meta.get("family", "kgnn")
        if family in ("point", "chiro"):
            spec = FAMILIES[family][0](**fields)
        else:
            spec = BatchSpec(**{**fields,
                                "deg_capacity": tuple(fields["deg_capacity"])})
        fn = program.module()

        def call(batch):
            with torch.inference_mode():
                return fn(*[t.to(device) for t in batch.leaves()])

        return call, spec

    # ------------------------------------------------------------------
    def predict_smiles(
        self,
        smiles: Sequence[str],
        probabilities: bool = False,
        embed_seed: int = 42,
    ) -> np.ndarray:
        """SMILES -> scores; unparseable molecules (for ChIRoNet, also
        those with no dihedral) get NaN (positions are preserved)."""
        if spec_family(self.spec) == "chiro":
            from molkgnn_torch.graphs.chiro import (
                smiles_to_chiro_graph as to_graph,
            )
        else:
            from molkgnn_torch.chem.embed import smiles_to_graph as to_graph

        graphs = [to_graph(s, seed=embed_seed) for s in smiles]
        valid = [g for g in graphs if g is not None]
        scores = (
            self.predict_graphs(valid, probabilities=probabilities)
            if valid
            else np.zeros((0,))
        )
        out = np.full(len(smiles), np.nan)
        k = 0
        for i, g in enumerate(graphs):
            if g is not None:
                out[i] = scores[k]
                k += 1
        return out


class _LeafForward(nn.Module):
    """``model`` called on a batch of type ``batch_type`` rebuilt from its
    leaves: the module ``export`` traces."""

    def __init__(self, model: nn.Module, batch_type):
        super().__init__()
        self.model = model
        self.batch_type = batch_type

    def forward(self, *leaves):
        return self.model(self.batch_type.from_leaves(leaves))


def _two_atoms(spec) -> MolGraph:
    """The template molecule of ``export``'s example batch: only its
    shapes and types are traced."""
    fe = getattr(spec, "edge_dim", 7)
    return MolGraph(
        x=np.zeros((2, getattr(spec, "node_dim", 28)), np.float32),
        p=np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32),
        edge_index=np.array([[0, 1], [1, 0]], np.int32),
        edge_attr=np.zeros((2, fe), np.float32),
        atomic_num=np.array([6, 8], np.int32),
    )
