"""Device-resident dataset and on-device batch assembly.

Port of ``molkgnn_tpu/graphs/device_pack.py``. The whole flat-packed
dataset (``graphs/packed.py``) lives in device memory, and each batch is
assembled there from a [B] vector of graph ids: per step only the ids cross
from the host, and the assembly is a handful of gathers with static shapes.

The padded concatenation of variable-length per-graph ranges:

  pos          = 0..CAP-1
  graph_of_pos = searchsorted(cumsum(lens), pos, right)
  within       = pos - exclusive_cumsum(lens)[graph_of_pos]
  src          = start[ids[graph_of_pos]] + within
  mask         = pos < sum(lens)

``gather_batch`` gives, for the same ids, the same arrays as
``PackedGraphs.pack`` and ``batch_graphs``, bit for bit; ids padded with -1
are masked graphs. Nothing here reads a value back to the host, and nothing
checks capacities on the device: the caller's sampler honours the spec.

The sampler on the device (``alias_sampler``/``sample_ids``) draws the
oversampling distribution with an alias table: the table is built on the
host in float64, bit-equal to the JAX package's; the draws use a
``torch.Generator`` (Philox on the card), so they follow the same
distribution as JAX's draws but not the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from molkgnn_torch.graphs.batch import BatchSpec, DegreeBucket, GraphBatch
from molkgnn_torch.graphs.molgraph import MAX_DEGREE
from molkgnn_torch.graphs.packed import PackedGraphs


@dataclasses.dataclass
class DeviceDataset:
    """The flat dataset arrays, as tensors on one device."""

    x: torch.Tensor  # [sumN, F]
    p: torch.Tensor  # [sumN, 3]
    node_count: torch.Tensor  # [G] int32
    node_start: torch.Tensor  # [G] int32
    edge_local: torch.Tensor  # [sumE, 2] int32
    edge_attr: torch.Tensor  # [sumE, Fe]
    edge_count: torch.Tensor  # [G] int32
    edge_start: torch.Tensor  # [G] int32
    y: torch.Tensor  # [G]
    deg_focal: Tuple[torch.Tensor, ...]  # per degree
    deg_nei: Tuple[torch.Tensor, ...]
    deg_ea: Tuple[torch.Tensor, ...]
    deg_count: Tuple[torch.Tensor, ...]
    deg_start: Tuple[torch.Tensor, ...]

    @classmethod
    def from_packed(
        cls, packed: PackedGraphs, device="cpu"
    ) -> "DeviceDataset":
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def i32(a):
            return dev(np.asarray(a, np.int32))

        return cls(
            x=dev(packed.x),
            p=dev(packed.p),
            node_count=i32(packed.node_count),
            node_start=i32(packed.node_start),
            edge_local=i32(packed.edge_local),
            edge_attr=dev(packed.edge_attr),
            edge_count=i32(packed.edge_count),
            edge_start=i32(packed.edge_start),
            y=dev(packed.y),
            deg_focal=tuple(i32(a) for a in packed.deg_focal),
            deg_nei=tuple(i32(a) for a in packed.deg_nei),
            deg_ea=tuple(dev(a) for a in packed.deg_ea),
            deg_count=tuple(i32(a) for a in packed.deg_count),
            deg_start=tuple(i32(a) for a in packed.deg_start),
        )


def _ranged_gather(ids, lens, starts, cap: int):
    """(src [cap], graph_of_pos [cap], within-range mask [cap]).

    src indexes the flat dataset array; padded positions point at 0.
    """
    b = ids.shape[0]
    ends = torch.cumsum(lens, 0, dtype=torch.int32)
    pos = torch.arange(cap, dtype=torch.int32, device=ids.device)
    gop = torch.searchsorted(ends, pos, right=True, out_int32=True)
    gop_c = torch.clamp(gop, max=b - 1)
    excl = ends - lens  # exclusive cumsum
    within = pos - excl[gop_c]
    src = starts[ids[gop_c]] + within
    mask = pos < ends[-1]
    return torch.where(mask, src, 0), gop_c, mask


def gather_batch(
    data: DeviceDataset, ids: torch.Tensor, spec: BatchSpec
) -> GraphBatch:
    """Assemble a padded GraphBatch on ``ids``' device from graph ids [B].

    ``ids`` shorter than the batch are padded with -1 (``pad_ids``); those
    graphs are masked. No overflow check can run without a readback, so the
    caller keeps every batch within ``spec`` (as the host packer, which
    does raise, requires).
    """
    valid = ids >= 0
    ids_c = torch.where(valid, ids, 0)

    nlens = torch.where(valid, data.node_count[ids_c], 0)
    boff = torch.cumsum(nlens, 0, dtype=torch.int32) - nlens  # node offsets
    nsrc, ngop, nmask = _ranged_gather(
        ids_c, nlens, data.node_start, spec.num_nodes
    )
    x = torch.where(nmask[:, None], data.x[nsrc], 0.0)
    p = torch.where(nmask[:, None], data.p[nsrc], 0.0)
    node_graph_id = torch.where(nmask, ngop, 0)

    elens = torch.where(valid, data.edge_count[ids_c], 0)
    esrc, egop, emask = _ranged_gather(
        ids_c, elens, data.edge_start, spec.num_edges
    )
    pair = data.edge_local[esrc] + boff[egop][:, None]
    pair = torch.where(emask[:, None], pair, 0)
    edge_attr = torch.where(emask[:, None], data.edge_attr[esrc], 0.0)

    buckets = []
    for d in range(MAX_DEGREE):
        cap = spec.deg_capacity[d]
        if data.deg_focal[d].shape[0] == 0:
            # No degree-(d+1) atom anywhere in the dataset: a gather from
            # the empty flat array is invalid even fully masked, so the
            # bucket is all padding.
            fe = data.deg_ea[d].shape[-1]
            buckets.append(
                DegreeBucket(
                    focal_index=ids.new_zeros((cap,), dtype=torch.int32),
                    nei_index=ids.new_zeros((cap, d + 1), dtype=torch.int32),
                    nei_edge_attr=data.x.new_zeros((cap, d + 1, fe)),
                    mask=torch.zeros(cap, dtype=torch.bool, device=ids.device),
                )
            )
            continue
        dlens = torch.where(valid, data.deg_count[d][ids_c], 0)
        dsrc, dgop, dmask = _ranged_gather(
            ids_c, dlens, data.deg_start[d], cap
        )
        off = boff[dgop]
        buckets.append(
            DegreeBucket(
                focal_index=torch.where(
                    dmask, data.deg_focal[d][dsrc] + off, 0
                ),
                nei_index=torch.where(
                    dmask[:, None], data.deg_nei[d][dsrc] + off[:, None], 0
                ),
                nei_edge_attr=torch.where(
                    dmask[:, None, None], data.deg_ea[d][dsrc], 0.0
                ),
                mask=dmask,
            )
        )

    return GraphBatch(
        x=x,
        p=p,
        node_mask=nmask,
        node_graph_id=node_graph_id,
        edge_src=pair[:, 0].contiguous(),
        edge_dst=pair[:, 1].contiguous(),
        edge_attr=edge_attr,
        edge_mask=emask,
        deg1=buckets[0],
        deg2=buckets[1],
        deg3=buckets[2],
        deg4=buckets[3],
        y=torch.where(valid, data.y[ids_c], 0.0),
        graph_mask=valid,
    )


def pad_ids(ids: np.ndarray, batch_size: int) -> np.ndarray:
    """``ids`` padded with -1 to ``batch_size`` (int32)."""
    out = np.full((batch_size,), -1, np.int32)
    out[: len(ids)] = ids
    return out


class AliasTable(NamedTuple):
    """Walker alias table over sampler positions: a uniform draw into
    bucket i keeps i with probability ``prob[i]``, else takes ``alias[i]``.
    Alias probabilities are per-bucket values of order 1, so float32 holds
    them to ~1e-7 relative at any n (a float32 cumulative distribution
    would merge neighbouring positions near 1.0 at millions of rows)."""

    prob: np.ndarray  # [n] float32
    alias: np.ndarray  # [n] int32


def alias_sampler(weights: np.ndarray) -> AliasTable:
    """The alias table of unnormalized per-position ``weights`` (Vose's
    O(n) algorithm in float64 on the host), bit-equal to
    ``molkgnn_tpu.graphs.device_pack.alias_sampler``."""
    w = np.asarray(weights, np.float64)
    n = w.size
    p = w / w.sum() * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    # fp-drift leftovers on either worklist keep prob 1.0 (exact).
    return AliasTable(prob, alias)


def sample_ids(
    generator: torch.Generator,
    prob: torch.Tensor,
    alias: torch.Tensor,
    train_ids: torch.Tensor,
    batch_size: int,
) -> torch.Tensor:
    """``batch_size`` i.i.d. weighted draws of ``train_ids`` (int32 [B]) on
    the tensors' device, from ``generator``: i ~ U{0..n-1} and u ~ U[0, 1);
    keep i if u < prob[i], else take alias[i]. P(position i) is its
    normalized weight: the reference's WeightedRandomSampler with
    replacement. No host readback; capturable in a CUDA graph."""
    n = prob.shape[0]
    device = prob.device
    i = torch.randint(
        0, n, (batch_size,), generator=generator, device=device
    )
    u = torch.rand(
        (batch_size,), generator=generator, device=device,
        dtype=torch.float32,
    )
    idx = torch.where(u < prob[i], i, alias[i].long())
    return train_ids[idx]
