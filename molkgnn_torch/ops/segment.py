"""Segment (scatter/gather) aggregation primitives.

Port of ``molkgnn_tpu/ops/segment.py``. Indices are static-shape with
boolean masks; padded entries contribute zero.

Every sum of two or more terms goes through one op,
``torch.ops.molkgnn.segment_sum(values, row, rowptr)``, over a CSR plan
(``SegmentPlan``) and in a fixed order, as XLA's ``segment_sum`` sums on
the TPU and the CPU: one molecule and one set of weights give one score on
the card too. Its implementations:

  * CUDA: the hand-written kernel ``csrc/segment_sum.cu`` (no atomics),
    counted in ``segment_sum.launches``;
  * CPU: the plain version, ``index_add_`` in list order, the order of
    ``np.add.at``; the kernel adds each output's terms in that order, so
    the two are bit-equal;
  * fake (meta): the output's shape, for ``torch.export``.

``segment_plan`` builds a plan on the tensors' device with a stable sort
and ``searchsorted``, with no host synchronisation, so that a plan can be
built inside a CUDA graph capture. Callers that sum over one index many
times (the kgnn layers, the halo forward) build their plans once per
forward and pass them in; the others build them per call here. Plans are
for the kernel: for tensors that ``planned`` turns down (CPU tensors) the
builders (``edge_plans``, ``bucket_plans``) return None and the functions
below take the plain version straight away (``index_add_`` of the terms
in list order, and ``index_select``'s own gradient, which is that), the
same sums without a sort; given a plan, any device runs through the op.
The tests force ``planned`` to run the card's path on the CPU.

Gradients go through ``torch.autograd.Function``s whose backward is the
same op over the transposed plan: the gradient of a gather
(``take_rows``, the gather of ``gather_scatter_add``) is a segment sum,
and the gradient of a segment sum is a gather (``index_select``, exact).
CUDA ``index_add_`` and the gradient of ``index_select`` or of advanced
indexing (sorting ``index_put_``; 250 of 285 ms of device time in a
flagship train step at batch 1024 on an NVIDIA H100 80GB HBM3 at 700 W,
PERF.md) are not used on the card.

``segment_min`` and ``segment_max`` stay ``scatter_reduce``: a minimum or
a maximum is exact in any order.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional

import torch

_DTYPES = {torch.float32: 0, torch.float64: 1}


class SegmentPlan(NamedTuple):
    """A CSR plan of a segment sum over ``num_segments`` segments.

    ``row`` [E] int32: the row of ``values`` that each term reads, segment
    after segment, each segment's terms in list order. ``rowptr`` [S + 2]
    int32: segment s's terms are ``row[rowptr[s]:rowptr[s + 1]]``; segment
    S holds the masked terms and is dropped. ``ids`` [E] int64: each term's
    segment in list order (S where masked), for the gradient's gather.
    """

    row: torch.Tensor
    rowptr: torch.Tensor
    ids: torch.Tensor

    @property
    def num_segments(self) -> int:
        return self.rowptr.shape[0] - 2


def segment_plan(
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    gather: Optional[torch.Tensor] = None,
) -> SegmentPlan:
    """The plan of ``out[s] = sum of values[gather[i]] over i with
    ids[i] == s and mask[i]`` (``gather`` None reads row i). ``ids`` of
    any shape, flattened; entries in [0, num_segments)."""
    ids = ids.reshape(-1).long()
    if mask is not None:
        ids = torch.where(mask.reshape(-1), ids, num_segments)
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 2, device=ids.device)
    rowptr = torch.searchsorted(sorted_ids, bounds)
    row = order if gather is None else gather.reshape(-1).long()[order]
    return SegmentPlan(row.int(), rowptr.int(), ids)


def planned(t: torch.Tensor) -> bool:
    """Whether sums over ``t`` take the planned path (the op over
    ``SegmentPlan``s): CUDA tensors, whose op is the kernel."""
    return t.is_cuda


def edge_plans(src, dst, num_nodes, edge_mask=None, backward=True,
               num_src=None):
    """(plan, transposed plan) of message passing ``gather_scatter_add``:
    destinations gathering sources, and sources (``num_src`` rows, default
    ``num_nodes``) gathering destinations, for the gradient (None when
    ``backward`` is False); None where ``planned`` turns ``src`` down."""
    if not planned(src):
        return None
    plan = segment_plan(dst, num_nodes, edge_mask, gather=src)
    plan_t = (segment_plan(src, num_nodes if num_src is None else num_src,
                           edge_mask, gather=dst)
              if backward else None)
    return plan, plan_t


def bucket_plans(buckets, num_nodes: int):
    """Per kgnn degree bucket, the plans of its focal and neighbour
    gathers from ``num_nodes`` rows, (focal, neighbour), for their
    gradients; None without autograd or where ``planned`` turns them
    down. A padded row's
    score is masked to zero, so its gathers' gradient is zero: the plans
    leave padded rows out (they point at node 0, which would otherwise sum
    them all)."""
    if not torch.is_grad_enabled() or not planned(buckets[0].focal_index):
        return None
    return [(segment_plan(b.focal_index, num_nodes, b.mask),
             segment_plan(b.nei_index, num_nodes,
                          b.mask[:, None].expand(b.nei_index.shape)))
            for b in buckets]


def segment_sum_plain(values, row, rowptr):
    """Plain version: ``index_add_`` of the planned terms in list order
    into zeros, the dump segment dropped."""
    s = rowptr.shape[0] - 2
    seg = torch.repeat_interleave(
        torch.arange(s + 1, device=values.device),
        rowptr.diff().long(), output_size=row.shape[0])
    out = values.new_zeros((s + 1,) + values.shape[1:])
    out.index_add_(0, seg, values.index_select(0, row.long()))
    return out[:s]


def _kernel_lib() -> ctypes.CDLL:
    """The built segment-sum library, with its C signatures declared."""
    from molkgnn_torch.ops._build import library

    lib = library("segment_sum")
    if lib.molkgnn_segment_sum.argtypes is None:
        lib.molkgnn_segment_sum.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.molkgnn_segment_sum.restype = ctypes.c_int
        lib.molkgnn_segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.molkgnn_segment_sum_error_string.restype = ctypes.c_char_p
    return lib


def _launch(values, row, rowptr, out) -> None:
    """One launch of the kernel; raises on refused arguments or a failed
    launch."""
    if values.dtype not in _DTYPES:
        raise TypeError(f"segment sum kernel takes float32 or float64, got "
                        f"{values.dtype}")
    if row.dtype != torch.int32 or rowptr.dtype != torch.int32:
        raise TypeError("segment sum kernel takes int32 row and rowptr")
    devices = {t.device for t in (values, row, rowptr, out)}
    if len(devices) != 1:
        raise ValueError(f"segment sum inputs on several devices: {devices}")
    f = out[0].numel() if out.shape[0] else 0
    device = out.device
    lib = _kernel_lib()
    same = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(device):
        err = lib.molkgnn_segment_sum(
            _DTYPES[values.dtype], values.data_ptr(), row.data_ptr(),
            rowptr.data_ptr(), out.data_ptr(), out.shape[0], f,
            torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        msg = lib.molkgnn_segment_sum_error_string(err).decode()
        raise RuntimeError(f"segment sum kernel launch failed: {msg} "
                           f"({err})")


@torch.library.custom_op(
    "molkgnn::segment_sum", mutates_args=(), device_types="cpu"
)
def segment_sum_op(values: torch.Tensor, row: torch.Tensor,
                   rowptr: torch.Tensor) -> torch.Tensor:
    """out [S, ...] = per segment s, the sum of ``values[row[i]]`` over
    ``i in [rowptr[s], rowptr[s + 1])`` in ascending i, S = len(rowptr) - 2
    (see the module doc). This body is the CPU version."""
    return segment_sum_plain(values, row, rowptr)


@segment_sum_op.register_kernel("cuda")
def _segment_sum_cuda(values, row, rowptr):
    out = values.new_empty((rowptr.shape[0] - 2,) + values.shape[1:])
    if out.numel():
        _launch(values.contiguous(), row, rowptr, out)
        segment_sum.launches += 1
    return out


@segment_sum_op.register_fake
def _segment_sum_fake(values, row, rowptr):
    return values.new_empty((rowptr.shape[0] - 2,) + values.shape[1:])


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The plan's sums of ``values`` [R, ...] -> [S, ...], not
    differentiable: the plain version for CPU tensors, one kernel launch
    for CUDA tensors (counted in ``segment_sum.launches``)."""
    return segment_sum_op(values, plan.row, plan.rowptr)


segment_sum.launches = 0


def _gather_back(grad: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each term's share of a segment sum's gradient: ``grad[ids]``, zero
    for the dump segment (masked terms). Exact."""
    pad = grad.new_zeros((1,) + grad.shape[1:])
    return torch.cat([grad, pad]).index_select(0, ids)


class _PlanSum(torch.autograd.Function):
    """``segment_sum(values, plan)`` differentiable in ``values``.

    With ``plan_t`` (a gathering plan: message passing) the gradient is
    the segment sum of the output gradient over the transposed plan; with
    None (the plan reads each row of ``values`` once) it is the gather
    ``grad[plan.ids]``."""

    @staticmethod
    def forward(ctx, values, plan, plan_t):
        ctx.plan, ctx.plan_t = plan, plan_t
        return segment_sum(values, plan)

    @staticmethod
    def backward(ctx, grad):
        if ctx.plan_t is not None:
            return segment_sum(grad.contiguous(), ctx.plan_t), None, None
        return _gather_back(grad, ctx.plan.ids), None, None


class _TakeRows(torch.autograd.Function):
    """``index_select`` along ``dim`` whose gradient is the segment sum of
    the output gradient over ``plan`` (the plan of ``idx``).

    Without a plan the backward builds one that leaves out the gradient's
    rows that are zero throughout: a zero term changes no sum from +0, so
    the result is the same to the bit, and the padding that batches point
    at row 0 (whose gradient is zero) does not pile up there as one long
    segment, which a thread would walk term by term."""

    @staticmethod
    def forward(ctx, t, idx, dim, plan):
        ctx.dim, ctx.n, ctx.plan = dim, t.shape[dim], plan
        ctx.shape = t.shape
        ctx.save_for_backward(idx)
        return t.index_select(dim, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        dim, shape = ctx.dim, ctx.shape
        g = grad.movedim(dim, 0).contiguous()
        rest = g.shape[1:]
        g = g.reshape(g.shape[0], -1)
        plan = ctx.plan
        if plan is None:
            plan = segment_plan(idx, ctx.n, mask=(g != 0).any(dim=1))
        out = segment_sum(g, plan)
        return out.reshape((ctx.n,) + rest).movedim(0, dim).reshape(
            shape), None, None, None


def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def take_rows(t: torch.Tensor, idx: torch.Tensor, dim: int = 0,
              plan: Optional[SegmentPlan] = None):
    """``t`` gathered along ``dim`` at ``idx`` of any shape:
    ``t.shape[:dim] + idx.shape + t.shape[dim + 1:]``. ``plan``: the plan
    of ``segment_plan(idx, t.shape[dim])`` for the gradient, if the caller
    has one."""
    flat = idx.reshape(-1)
    if _records(t) and (planned(t) or plan is not None):
        out = _TakeRows.apply(t, flat, dim, plan)
    else:
        out = t.index_select(dim, flat)
    return out.reshape(t.shape[:dim] + idx.shape + t.shape[dim + 1:])


def _index_add(values, ids, num_segments, mask):
    """The plain version without a plan, for CPU tensors: ``index_add_``
    of the (masked) terms in list order, as the op's CPU body adds them."""
    if mask is not None:  # one flag a row of values, of any rank
        values = torch.where(
            mask.reshape(mask.shape + (1,) * (values.dim() - 1)), values, 0)
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, ids, values)


def _plan_sum(values, plan, plan_t=None):
    if _records(values):
        return _PlanSum.apply(values, plan, plan_t)
    return segment_sum(values, plan)


def segment_sum_nodes(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """Sum ``values`` [N, F] into ``num_segments`` buckets by ``segment_ids``.

    Padded rows must either carry a False ``mask`` or already be zero.
    ``plan``: ``segment_plan(segment_ids, num_segments, mask)``, if the
    caller has one.
    """
    if plan is None and not planned(values):
        return _index_add(values, segment_ids, num_segments, mask)
    if plan is None:
        plan = segment_plan(segment_ids, num_segments, mask)
    return _plan_sum(values, plan)


def gather_scatter_add(
    values: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
    plans: Optional[tuple] = None,
) -> torch.Tensor:
    """Message passing h'_i = sum_{(j->i) in E} values_j (sum aggregation):
    gather at edge sources, segment-sum at destinations. ``plans``:
    ``edge_plans(src, dst, num_nodes, edge_mask)``, if the caller has
    them."""
    if plans is None and not planned(values):
        return _index_add(take_rows(values, src), dst, num_nodes, edge_mask)
    if plans is None:
        plans = edge_plans(src, dst, num_nodes, edge_mask,
                           backward=_records(values),
                           num_src=values.shape[0])
    plan, plan_t = plans
    if plan_t is None and _records(values):
        raise ValueError("gather_scatter_add: the gradient needs the "
                         "transposed plan (edge_plans(..., backward=True))")
    return _plan_sum(values, plan, plan_t)


def global_add_pool(
    node_values: torch.Tensor,
    node_graph_id: torch.Tensor,
    num_graphs: int,
    node_mask: torch.Tensor | None = None,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """Node -> graph segment sum (PyG ``global_add_pool``)."""
    return segment_sum_nodes(
        node_values, node_graph_id, num_graphs, mask=node_mask, plan=plan
    )


def segment_min(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Least of ``values`` [N] per segment (``jax.ops.segment_min``); a
    segment with no entry holds ``inf``. Padded entries should carry
    ``inf``. A minimum is exact, so the result does not depend on the
    order in which entries arrive."""
    out = values.new_full((num_segments,), float("inf"))
    return out.scatter_reduce(0, segment_ids.long(), values, "amin",
                              include_self=False)


def segment_max(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Greatest of ``values`` [N, ...] per segment along dim 0
    (``jax.ops.segment_max``); a segment with no entry holds ``-inf``.
    Padded entries should carry ``-inf``. A maximum is exact, so the
    result does not depend on the order in which entries arrive."""
    out = values.new_full((num_segments,) + values.shape[1:],
                          float("-inf"))
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=False)
