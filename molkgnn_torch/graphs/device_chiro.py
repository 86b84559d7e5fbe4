"""Device-resident ChIRoNet dataset and on-device batch assembly.

Port of ``molkgnn_tpu/graphs/device_chiro.py``: ``device_pack.py``'s
pipeline (the flat dataset on the device, each padded batch assembled
there from a [B] vector of graph ids) for ``ChiroBatch``. A ChiroGraph's
tensors (features, bonds, distance/angle/dihedral paths with their values,
the local-structure map and the alpha rows) are static per conformer; they
are stored flat, per kind, with molecule-local indices and per-molecule
counts and starts. The gather rebases every atom index by the batch's node
offsets, except ``ls_map``, which rebases by the batch's alpha offsets.

``gather_chiro`` gives, for the same ids, the same tensors as
``batch_chiro``, bit for bit; ids padded with -1 are masked graphs.
Nothing is read back to the host and nothing checks capacities on the
device: the caller keeps every batch within the spec.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from molkgnn_torch.graphs.chiro import ChiroBatch, ChiroBatchSpec, ChiroGraph
from molkgnn_torch.graphs.device_pack import _ranged_gather


@dataclasses.dataclass
class DeviceChiroDataset:
    """The flat ChIRoNet dataset, as tensors on one device."""

    x: torch.Tensor  # [sumN, 52] float32
    node_count: torch.Tensor  # [G] int32
    node_start: torch.Tensor  # [G] int32
    edge_local: torch.Tensor  # [sumE, 2] int32, molecule-local
    edge_attr: torch.Tensor  # [sumE, 14] float32
    edge_count: torch.Tensor
    edge_start: torch.Tensor
    dist_val: torch.Tensor  # [sumD]
    dist_local: torch.Tensor  # [sumD, 2]
    dist_count: torch.Tensor
    dist_start: torch.Tensor
    ang_val: torch.Tensor  # [sumP]
    ang_local: torch.Tensor  # [sumP, 3]
    ang_count: torch.Tensor
    ang_start: torch.Tensor
    dih_val: torch.Tensor  # [sumS]
    dih_local: torch.Tensor  # [sumS, 4]
    ls_local: torch.Tensor  # [sumS] molecule-local alpha rows
    dih_count: torch.Tensor
    dih_start: torch.Tensor
    alpha_local: torch.Tensor  # [sumA, 2]
    alpha_count: torch.Tensor
    alpha_start: torch.Tensor
    y: torch.Tensor  # [G] float32

    @classmethod
    def from_graphs(
        cls, graphs: Sequence[ChiroGraph], device="cpu"
    ) -> "DeviceChiroDataset":
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def cat(chunks, tail, dtype):
            if sum(np.shape(c)[0] for c in chunks) == 0:
                return dev(np.zeros((0,) + tail, dtype))
            return dev(np.concatenate([np.asarray(c, dtype)
                                       for c in chunks]))

        counts = np.asarray([g.counts() for g in graphs],
                            np.int64).reshape(-1, 6)
        cs = {}
        for k, kind in enumerate(("node", "edge", "dist", "ang", "dih",
                                  "alpha")):
            c = counts[:, k]
            cs[f"{kind}_count"] = dev(c.astype(np.int32))
            cs[f"{kind}_start"] = dev((np.cumsum(c) - c).astype(np.int32))
        f32, i32 = np.float32, np.int32
        return cls(
            x=cat([g.x for g in graphs], (52,), f32),
            edge_local=cat([g.edge_index.T for g in graphs], (2,), i32),
            edge_attr=cat([g.edge_attr for g in graphs], (14,), f32),
            dist_val=cat([g.distances for g in graphs], (), f32),
            dist_local=cat([g.distance_index for g in graphs], (2,), i32),
            ang_val=cat([g.angles for g in graphs], (), f32),
            ang_local=cat([g.angle_index for g in graphs], (3,), i32),
            dih_val=cat([g.dihedrals for g in graphs], (), f32),
            dih_local=cat([g.dihedral_index for g in graphs], (4,), i32),
            ls_local=cat([g.ls_map for g in graphs], (), i32),
            alpha_local=cat([g.alpha_index.T for g in graphs], (2,), i32),
            y=dev(np.asarray([g.y for g in graphs], f32)),
            **cs,
        )


def gather_chiro(
    data: DeviceChiroDataset, ids: torch.Tensor, spec: ChiroBatchSpec
) -> ChiroBatch:
    """Assemble a padded ``ChiroBatch`` on ``ids``' device from graph ids
    [B] (int32, -1 padded), with no host readback (capturable)."""
    valid = ids >= 0
    ids_c = torch.where(valid, ids, 0)

    def seg(counts, starts, cap):
        """(src, graph of each position, mask, batch offset of each graph)
        of one kind; the offsets rebase this kind's indices in other
        kinds (alpha offsets feed ls_map)."""
        lens = torch.where(valid, counts[ids_c], 0)
        off = torch.cumsum(lens, 0, dtype=torch.int32) - lens
        src, gop, mask = _ranged_gather(ids_c, lens, starts, cap)
        return src, gop, mask, off

    def pull(flat, src, mask):
        """Masked gather; a dataset-wide empty flat array (a gather from it
        is invalid even fully masked) gives the zero fill directly, of the
        flat array's dtype."""
        shape = src.shape + flat.shape[1:]
        if flat.shape[0] == 0:
            return flat.new_zeros(shape)
        m = mask.reshape(mask.shape + (1,) * (flat.dim() - 1))
        return torch.where(m, flat[src], 0)

    def rebase(rows, gop, mask, off):
        """Index rows plus their graph's batch offset (0 where padded)."""
        shift = torch.where(mask, off[gop], 0)
        return rows + (shift[:, None] if rows.dim() == 2 else shift)

    nsrc, ngop, nmask, boff = seg(data.node_count, data.node_start,
                                  spec.num_nodes)
    x = pull(data.x, nsrc, nmask)
    gid = torch.where(nmask, ngop, 0)

    esrc, egop, emask, _ = seg(data.edge_count, data.edge_start,
                               spec.num_edges)
    pair = rebase(pull(data.edge_local, esrc, emask), egop, emask, boff)
    eattr = pull(data.edge_attr, esrc, emask)

    dsrc, dgop, dmask, _ = seg(data.dist_count, data.dist_start,
                               spec.num_dist)
    dvals = pull(data.dist_val, dsrc, dmask)
    didx = rebase(pull(data.dist_local, dsrc, dmask), dgop, dmask, boff)

    asrc, agop, amask, _ = seg(data.ang_count, data.ang_start,
                               spec.num_angles)
    avals = pull(data.ang_val, asrc, amask)
    aidx = rebase(pull(data.ang_local, asrc, amask), agop, amask, boff)

    alsrc, algop, almask, aloff = seg(data.alpha_count, data.alpha_start,
                                      spec.num_alpha)
    alidx = rebase(pull(data.alpha_local, alsrc, almask), algop, almask,
                   boff)

    ssrc, sgop, smask, _ = seg(data.dih_count, data.dih_start,
                               spec.num_dihedrals)
    svals = pull(data.dih_val, ssrc, smask)
    sidx = rebase(pull(data.dih_local, ssrc, smask), sgop, smask, boff)
    # ls_map rebases by the batch's alpha offsets, not its node offsets.
    lsm = rebase(pull(data.ls_local, ssrc, smask), sgop, smask, aloff)

    def col(t, c):
        return t[:, c].contiguous()

    return ChiroBatch(
        x=x,
        node_mask=nmask,
        node_graph_id=gid,
        edge_src=col(pair, 0),
        edge_dst=col(pair, 1),
        edge_attr=eattr,
        edge_mask=emask,
        distances=dvals,
        dist_i=col(didx, 0),
        dist_j=col(didx, 1),
        dist_mask=dmask,
        angles=avals,
        ang_i=col(aidx, 0),
        ang_j=col(aidx, 1),
        ang_k=col(aidx, 2),
        ang_mask=amask,
        dihedrals=svals,
        dih_i=col(sidx, 0),
        dih_j=col(sidx, 1),
        dih_k=col(sidx, 2),
        dih_l=col(sidx, 3),
        dih_mask=smask,
        ls_map=lsm,
        alpha_x=col(alidx, 0),
        alpha_y=col(alidx, 1),
        alpha_mask=almask,
        y=torch.where(valid, data.y[ids_c], 0.0),
        graph_mask=valid,
    )
