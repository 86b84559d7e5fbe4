"""Scoring a device-resident dataset one id block at a time.

The counterpart of the JAX package's ``lax.scan`` over id blocks inside one
``jit`` (``Predictor.screen_library``, ``Trainer._eval_flat``): the dataset
lives on the device (``graphs/device_pack.py``,
``graphs/device_points.py`` for the point families or
``graphs/device_chiro.py`` for ChIRoNet: the gather is the spec family's,
from ``serving/predictor.py::device_pipeline``), the ids of every batch
form a ``[nblocks, B]`` matrix padded with -1 (``pad_ids``), and the
predictions of all blocks come back as one ``[nblocks, B]`` tensor, read
back once by the caller. Nothing is read back between blocks.

On the card, one eval forward, ``model(gather(data, ids, spec))[0]`` on a
static id buffer, is captured as a CUDA graph and replayed per block:
copy the block's ids into the static buffer, replay, copy the static output
into the result. The graph is captured on the first call for a (dataset,
B): the first block runs eagerly on a side stream (the warm-up, whose
output is that block's result), then the forward is captured, and the
other blocks are replays. The graph is cached for the dataset's tensors
and B; a call with other tensors (the next slab of a library) captures
anew, after the old graph and its memory are released: one graph is held
at a time, and a slab's capture costs one eager forward. The forward reads
the parameters and BatchNorm statistics in place, so loading weights by
copy (``load_state_dict``) between calls keeps the graph valid. The scorer
launches recorded in the capture are taken back and added at each replay
(``ops/support_score.py::take_launches``), so a block counts one launch
per layer as an eager forward does. A failed capture raises; nothing falls
back to eager on the card.

On the CPU the same loop runs eagerly, one forward per block.

With a data mesh (``mesh=``: data-parallel evaluation and screening) each
rank scores its share of the blocks, ``rank, rank + world, ...`` of the
blocks padded with all ``-1`` blocks to a multiple of the world size,
through its own capture and replays, and the ranks' predictions are
gathered back in block order (``parallel/data_parallel.py::score_blocks``):
every rank returns the whole ``[nblocks, B]``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from molkgnn_torch.ops.support_score import (
    add_launches,
    launch_counts,
    take_launches,
)
from molkgnn_torch.serving.predictor import device_pipeline


class BlockScorer:
    """Predictions of an eval-mode ``model`` over id blocks of a device
    dataset of ``spec``'s family (see the module doc)."""

    def __init__(self, model: nn.Module, spec):
        self.model = model
        self.spec = spec
        self._gather = device_pipeline(spec)[1]
        self._key = None  # (the dataset's tensors, B) the graph reads
        self._graph = None
        self._ids = None  # static [B] int32 input
        self._pred = None  # static [B] output
        self._launches = None  # scorer launches of one replay

    def _forward(self, data, ids: torch.Tensor):
        return self.model(self._gather(data, ids, self.spec))[0]

    def __call__(self, data, idm: torch.Tensor, mesh=None):
        """[nblocks, B] predictions of the graphs ``idm`` [nblocks, B]
        (int32 on the dataset's device, -1 padded; padded entries score
        whatever the model gives a masked graph), left on the device;
        across ``mesh``'s ranks when one is given (see the module doc)."""
        if mesh is not None:
            from molkgnn_torch.parallel.data_parallel import score_blocks

            return score_blocks(mesh, idm,
                                lambda rows: self._score(data, rows))
        return self._score(data, idm)

    @torch.inference_mode()
    def _score(self, data, idm: torch.Tensor):
        if idm.device.type != "cuda":
            return torch.stack([self._forward(data, ids) for ids in idm])
        key = (_tensors(data), idm.shape[1])
        first = None
        if not self._cached(key):
            first = self._capture(data, idm[0])
            self._key = key
        out = torch.empty(idm.shape, dtype=self._pred.dtype,
                          device=idm.device)
        if first is not None:
            out[0].copy_(first)
        for i in range(0 if first is None else 1, idm.shape[0]):
            self._ids.copy_(idm[i])
            self._graph.replay()
            add_launches(self._launches)
            out[i].copy_(self._pred)
        return out

    def _cached(self, key) -> bool:
        if self._key is None or self._key[1] != key[1]:
            return False
        return all(a is b for a, b in zip(self._key[0], key[0]))

    def _capture(self, data, first: torch.Tensor):
        """Score the block ``first`` eagerly on a side stream (the warm-up),
        then capture the forward on a static copy of its ids; returns the
        block's predictions."""
        self._key = self._graph = self._ids = self._pred = None
        device = first.device
        ids = first.clone()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            pred = self._forward(data, ids)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            self._pred = self._forward(data, ids)
        self._launches = take_launches(before)
        self._graph, self._ids = graph, ids
        return pred


def _tensors(data) -> list:
    """Every tensor of ``data``, the per-degree tuples flattened."""
    out = []
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        out += list(v) if isinstance(v, tuple) else [v]
    return out
