"""Differentiable collectives over explicit process groups.

The model-parallel forwards (``parallel/halo.py``, ``parallel/hybrid.py``,
``parallel/edge_partition.py``) differentiate through their collectives, as
the JAX package's ``jax.grad`` does through ``all_to_all`` and ``psum``:

  * ``exchange(send, group)``: ``dist.all_to_all_single`` with equal splits
    over the leading axis (``send[r]`` goes to rank ``r`` of ``group``; row
    ``r`` of the result came from rank ``r``), the counterpart of
    ``jax.lax.all_to_all(split_axis=0, concat_axis=0)``. Its backward is the
    same exchange of the gradient: the transpose of an all-to-all is the
    reverse all-to-all. With ``pending`` (a list) the forward's exchange is
    started asynchronously and its work handle appended there; the caller
    waits on it before reading the result, and may run independent work in
    between;
  * ``all_reduce_sum(x, group)``: a SUM all-reduce whose backward is a SUM
    all-reduce of the gradient (``psum``'s transpose is ``psum``). The
    gradient accounting of the halo step rests on it: differentiating
    through the pooled embeddings' sum hands every shard the cotangent
    scaled by the shard count, so a mean of the shards' gradients is the
    whole batch's gradient. A plain, non-differentiable ``dist.all_reduce``
    would leave every encoder gradient short by that factor.

Both run on any backend: NCCL on the card (also inside a captured CUDA
graph, where the work is waited on before the graph ends), gloo on the CPU
and, in a gloo world that shares one card, on CUDA tensors (gloo stages
them through host memory itself). ``torch.distributed.nn`` is not used: it
is deprecated in this torch.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, group, pending):
        ctx.group = group
        send = send.contiguous()
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return recv

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def exchange(send: torch.Tensor, group,
             pending: Optional[List] = None) -> torch.Tensor:
    """All-to-all of ``send`` [world, ...] over ``group`` (see the module
    doc); asynchronous when ``pending`` is a list."""
    return _Exchange.apply(send, group, pending)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``x`` over ``group``, differentiable (see the module
    doc)."""
    return _AllReduceSum.apply(x, group)
