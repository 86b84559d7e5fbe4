"""Device-resident point-cloud dataset and on-device batch assembly.

Port of ``molkgnn_tpu/graphs/device_points.py``: ``device_pack.py``'s
pipeline (the flat dataset on the device, each padded batch assembled
there from a [B] vector of graph ids) for the SchNet, DimeNet++ and
SphereNet batches. Each molecule's geometry (``geometric.
molecule_geometry``, the arrays the host packer uses) is stored with
molecule-local indices and per-molecule counts and starts; the gather
rebases indices at three levels: node ids by the batch's node offsets,
triplet edge ids by its edge offsets, and quad triplet ids by its triplet
offsets.

``gather_points`` gives, for the same ids, the same tensors as
``batch_points``, bit for bit; ids padded with -1 are masked graphs.
Nothing is read back to the host and nothing checks capacities on the
device: the caller keeps every batch within the spec.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from molkgnn_torch.graphs.device_pack import _ranged_gather
from molkgnn_torch.graphs.geometric import (
    PointBatch,
    PointBatchSpec,
    molecule_geometry,
)
from molkgnn_torch.graphs.molgraph import MolGraph


@dataclasses.dataclass
class DevicePointDataset:
    """The flat point-cloud dataset, as tensors on one device."""

    z: torch.Tensor  # [sumN] int32
    pos: torch.Tensor  # [sumN, 3] float32
    node_count: torch.Tensor  # [G] int32
    node_start: torch.Tensor  # [G] int32
    edge_local: torch.Tensor  # [sumE, 2] int32 (j, i), molecule-local
    edge_count: torch.Tensor  # [G] int32
    edge_start: torch.Tensor  # [G] int32
    tri_local: torch.Tensor  # [sumT, 3] int32 (e_kj, e_ji, k), local
    tri_count: torch.Tensor  # [G] int32
    tri_start: torch.Tensor  # [G] int32
    quad_local: torch.Tensor  # [sumQ, 2] int32 (t, k_n), local
    quad_count: torch.Tensor  # [G] int32
    quad_start: torch.Tensor  # [G] int32
    y: torch.Tensor  # [G] float32

    @classmethod
    def from_graphs(
        cls, graphs: Sequence[MolGraph], spec: PointBatchSpec, device="cpu"
    ) -> "DevicePointDataset":
        geo = [
            molecule_geometry(g, spec.cutoff, spec.with_triplets,
                              spec.with_torsion)
            for g in graphs
        ]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def flat(level, width):
            chunks = [np.asarray(x[level], np.int32).T for x in geo]
            if sum(c.shape[0] for c in chunks) == 0:
                return dev(np.zeros((0, width), np.int32))
            return dev(np.concatenate(chunks, axis=0))

        def counts_starts(counts):
            c = np.asarray(counts, np.int64)
            return (dev(c.astype(np.int32)),
                    dev((np.cumsum(c) - c).astype(np.int32)))

        ncnt, nst = counts_starts([g.num_nodes for g in graphs])
        ecnt, est = counts_starts([x[0].shape[1] for x in geo])
        tcnt, tst = counts_starts([x[1].shape[1] for x in geo])
        qcnt, qst = counts_starts([x[2].shape[1] for x in geo])
        return cls(
            z=dev(np.concatenate(
                [np.asarray(g.atomic_num, np.int32) for g in graphs])),
            pos=dev(np.concatenate(
                [np.asarray(g.p, np.float32) for g in graphs])),
            node_count=ncnt, node_start=nst,
            edge_local=flat(0, 2), edge_count=ecnt, edge_start=est,
            tri_local=flat(1, 3), tri_count=tcnt, tri_start=tst,
            quad_local=flat(2, 2), quad_count=qcnt, quad_start=qst,
            y=dev(np.asarray([g.y for g in graphs], np.float32)),
        )


def gather_points(
    data: DevicePointDataset, ids: torch.Tensor, spec: PointBatchSpec
) -> PointBatch:
    """Assemble a padded ``PointBatch`` on ``ids``' device from graph ids
    [B] (int32, -1 padded), with no host readback (capturable)."""
    valid = ids >= 0
    ids_c = torch.where(valid, ids, 0)

    def lens(count):
        return torch.where(valid, count[ids_c], 0)

    def offsets(n):  # exclusive cumsum: each graph's offset in the batch
        return torch.cumsum(n, 0, dtype=torch.int32) - n

    nlens = lens(data.node_count)
    boff = offsets(nlens)
    nsrc, ngop, nmask = _ranged_gather(
        ids_c, nlens, data.node_start, spec.num_nodes
    )
    z = torch.where(nmask, data.z[nsrc], 0)
    pos = torch.where(nmask[:, None], data.pos[nsrc], 0.0)
    gid = torch.where(nmask, ngop, 0)

    elens = lens(data.edge_count)
    eoff = offsets(elens)
    esrc, egop, emask = _ranged_gather(
        ids_c, elens, data.edge_start, spec.num_edges
    )
    if data.edge_local.shape[0] == 0:
        # No radius edge anywhere in the dataset: a gather from the empty
        # flat array is invalid even fully masked, so the level is all
        # padding (the same guard for triplets and quads below).
        pair = ids.new_zeros((spec.num_edges, 2))
    else:
        pair = data.edge_local[esrc] + boff[egop][:, None]
        pair = torch.where(emask[:, None], pair, 0)

    def zeros(cap):
        return (ids.new_zeros((cap,)),
                torch.zeros(cap, dtype=torch.bool, device=ids.device))

    cap = spec.num_triplets
    if not spec.with_triplets or data.tri_local.shape[0] == 0:
        tz, tmask = zeros(cap)
        tkj = tji = tk = tz
    else:
        tlens = lens(data.tri_count)
        tsrc, tgop, tmask = _ranged_gather(
            ids_c, tlens, data.tri_start, cap
        )
        rows = data.tri_local[tsrc]  # [cap, 3]
        tkj, tji, tk = (
            torch.where(tmask, rows[:, c] + off[tgop], 0)
            for c, off in ((0, eoff), (1, eoff), (2, boff))
        )

    cap = spec.num_quads
    if not spec.with_torsion or data.quad_local.shape[0] == 0:
        qt, qmask = zeros(cap)
        qkn = qt
    else:
        qlens = lens(data.quad_count)
        qsrc, qgop, qmask = _ranged_gather(
            ids_c, qlens, data.quad_start, cap
        )
        toff = offsets(lens(data.tri_count))
        rows = data.quad_local[qsrc]  # [cap, 2]
        qt = torch.where(qmask, rows[:, 0] + toff[qgop], 0)
        qkn = torch.where(qmask, rows[:, 1] + boff[qgop], 0)

    return PointBatch(
        z=z,
        pos=pos,
        node_mask=nmask,
        node_graph_id=gid,
        edge_src=pair[:, 0].contiguous(),
        edge_dst=pair[:, 1].contiguous(),
        edge_mask=emask,
        tri_edge_kj=tkj,
        tri_edge_ji=tji,
        tri_k=tk,
        tri_mask=tmask,
        quad_t=qt,
        quad_kn=qkn,
        quad_mask=qmask,
        y=torch.where(valid, data.y[ids_c], 0.0),
        graph_mask=valid,
    )
