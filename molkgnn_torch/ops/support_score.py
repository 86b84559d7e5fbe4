"""Permutation-max support scorer: CUDA kernel wrappers and plain versions.

Port of ``molkgnn_tpu/ops/pallas_kernels.py``. For row-normalized
neighborhoods ``a`` [M, K] (K = d*F) and permuted supports ``b`` [P, K, L]:

    best[m, l] = max_p sum_k a[m, k] * b[p, k, l]      (a sum-cosine; the
    idx[m, l]  = first p reaching the max (int32)       caller divides by d)

``fused_support_score`` scores one bucket, ``grouped_support_score`` all
buckets of a layer in one launch. Both go through one registered torch op,
``torch.ops.molkgnn.support_score(a_list, b_list, fused)``, so that
``torch.export`` records the scorer as one node of the exported graph (a
ctypes call on raw pointers cannot be traced). The op returns two flat
buffers, every group's ``best`` one after another and every group's
``idx`` likewise (an op's outputs may not alias each other or its inputs);
the wrappers take the per-group views outside it. Its implementations:

  * CUDA: the kernel, ``csrc/support_score.cu`` (after a small kernel in
    the same call that packs B into scratch for it), counted in the
    ``launches`` attribute of the wrapper that ``fused`` names. The count
    lives here, so an exported program's run counts its launches too;
  * CPU: the plain PyTorch version (``support_score_plain``), uncounted;
  * fake (meta): the output shapes, from the input shapes alone.

A tensor on the CPU takes the plain version only because it lies there; a
CUDA tensor launches the kernel or raises. Inside a CUDA graph capture the
op records its launch and counts it as usual; the replays launch it. A
caller that captures (the ``Trainer``'s train step, the block scorer of
``serving/blocks.py``) takes the capture's count back with
``take_launches`` (a capture runs nothing) and adds it at every replay with
``add_launches``, so that ``launches`` counts the kernel's launches on the
card. The registry (``SCORERS``) holds the segment sum's wrapper too.

Gradients: when autograd records (grad enabled and an input requires grad),
both wrappers go through one ``torch.autograd.Function`` over G groups,
``_SupportScore``. Its backward is the JAX custom VJP
(``pallas_kernels.py:251-268``) in plain torch: the gradient flows only
through the chosen permutation: one scatter of the output gradient to it
and two products per group. The JAX backward is XLA, not Pallas, so it has
no kernel of its own here either.
Without autograd (``torch.no_grad``/``inference_mode``) the wrappers call
the op directly and the Function costs nothing. The Function stays around
the op (rather than ``torch.library.register_autograd``) so that the
per-group views and the saved argmaxes are those of the training slice.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from molkgnn_torch.ops.segment import segment_sum

MAX_GROUPS = 16  # kMaxGroups in csrc/support_score.cu


def support_score_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain version: einsum, then max/argmax over p (first max wins).

    Computes in the inputs' dtype (fp32 on the card, fp64 in the CPU parity
    tests). Returns (best [M, L], idx [M, L] int32).
    """
    sc = torch.einsum("mk,pkl->mlp", a, b)
    best, idx = sc.max(dim=2)
    return best, idx.to(torch.int32)


def _device_of(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"support scorer inputs on several devices: {devices}"
        )
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"support scorer: unsupported device {device}")
    return device


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(
            f"support kernel takes float32, got {a.dtype} and {b.dtype}"
        )
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"support kernel shapes: a [M, K] and b [P, K, L], got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if b.shape[0] < 1:
        raise ValueError("support kernel needs at least one permutation")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("support kernel takes contiguous a and b")


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from molkgnn_torch.ops._build import library

    lib = library("support_score")
    if lib.molkgnn_support_score.argtypes is None:
        lib.molkgnn_support_score.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.molkgnn_support_score.restype = ctypes.c_int
        lib.molkgnn_support_score_scratch.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.molkgnn_support_score_scratch.restype = ctypes.c_int64
        lib.molkgnn_support_score_facts.argtypes = [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.molkgnn_support_score_facts.restype = ctypes.c_int
        lib.molkgnn_error_string.argtypes = [ctypes.c_int]
        lib.molkgnn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.molkgnn_error_string(err).decode()
        raise RuntimeError(
            f"support score kernel {what} failed: {msg} ({err})"
        )


def block_order(shapes) -> list[int]:
    """Order in which the kernel lays out the groups' blocks: heaviest
    first by M*K*L*P (ties keep their order), so that the light groups'
    small tiles fill the tail of the launch. shapes: [(M, K, L, P)]."""
    def weight(i):
        m, k, l, p = shapes[i]
        return m * k * l * p

    return sorted(range(len(shapes)), key=lambda i: -weight(i))


def output_offsets(shapes) -> tuple[list[int], int]:
    """Element offsets of the groups' [M, L] outputs in one flat buffer,
    and the buffer's length. shapes: [(M, K, L, P)]."""
    offsets, n = [], 0
    for m, _, l, _ in shapes:
        offsets.append(n)
        n += m * l
    return offsets, n


@functools.lru_cache(maxsize=256)
def _plan(shapes: tuple):
    """(block order, output offsets, outputs' length, scratch floats) for
    groups of these (M, K, L, P); the scratch size is asked of the kernel
    library, which lays out the packed B."""
    lib = _kernel_lib()
    args = [v for shape in shapes for v in (0, 0, 0, 0, *shape)]
    scratch = lib.molkgnn_support_score_scratch(
        len(shapes), (ctypes.c_int64 * len(args))(*args)
    )
    if scratch < 0:
        raise ValueError(f"support kernel does not take groups {shapes}")
    offsets, n_out = output_offsets(shapes)
    return tuple(block_order(shapes)), tuple(offsets), n_out, scratch


def _launch(a_list, b_list):
    """Launch the kernel once over all groups; returns the flat (best,
    idx) buffers, group after group at ``output_offsets``.

    B packed by the kernel goes to a scratch buffer of its own, released
    (stream-ordered) when the launch returns. The arguments travel in one
    int64 array, which keeps the host's share of a launch small.
    """
    g = len(a_list)
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(
            f"support kernel takes 1..{MAX_GROUPS} groups, got {g}"
        )
    shapes = []
    for a, b in zip(a_list, b_list):
        _check(a, b)
        shapes.append((a.shape[0], a.shape[1], b.shape[2], b.shape[0]))
    shapes = tuple(shapes)
    order, offsets, n_out, scratch = _plan(shapes)
    device = a_list[0].device
    best = torch.empty(n_out, dtype=torch.float32, device=device)
    idx = torch.empty(n_out, dtype=torch.int32, device=device)
    packed_b = torch.empty(scratch, dtype=torch.float32, device=device)
    fp, ip = best.data_ptr(), idx.data_ptr()
    args = []
    for i in order:
        args += (
            a_list[i].data_ptr(), b_list[i].data_ptr(),
            fp + 4 * offsets[i], ip + 4 * offsets[i], *shapes[i],
        )
    lib = _kernel_lib()
    same = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(device):
        err = lib.molkgnn_support_score(
            g, (ctypes.c_int64 * len(args))(*args), packed_b.data_ptr(),
            scratch,
            torch._C._cuda_getCurrentRawStream(device.index),
        )
    _raise_on(lib, err, "launch")
    return best, idx


@torch.library.custom_op(
    "molkgnn::support_score", mutates_args=(), device_types="cpu"
)
def support_score_op(
    a_list: List[torch.Tensor], b_list: List[torch.Tensor], fused: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scorer over G groups as one op: (best, idx) flat, group after
    group (see the module doc). ``fused`` names the wrapper whose
    ``launches`` count the CUDA launch. This body is the CPU version."""
    outs = [support_score_plain(a, b) for a, b in zip(a_list, b_list)]
    return (torch.cat([best.reshape(-1) for best, _ in outs]),
            torch.cat([idx.reshape(-1) for _, idx in outs]))


@support_score_op.register_kernel("cuda")
def _support_score_cuda(a_list, b_list, fused):
    out = _launch(a_list, b_list)
    (fused_support_score if fused else grouped_support_score).launches += 1
    return out


@support_score_op.register_fake
def _support_score_fake(a_list, b_list, fused):
    _, n = output_offsets(
        [(a.shape[0], 0, b.shape[2], 0) for a, b in zip(a_list, b_list)])
    return (a_list[0].new_empty(n),
            a_list[0].new_empty(n, dtype=torch.int32))


FACT_NAMES = (
    "registers", "static_smem_bytes", "dynamic_smem_bytes", "blocks_per_sm",
    "local_bytes", "perm_chunk", "block_rows", "block_kernels", "threads",
)


def kernel_facts() -> list[dict]:
    """The built kernel's facts on the current device, one dict per tile
    shape (see ``molkgnn_support_score_facts`` in csrc/support_score.cu)."""
    lib = _kernel_lib()
    out = (ctypes.c_int * (len(FACT_NAMES) * 4))()
    _raise_on(lib, lib.molkgnn_support_score_facts(out), "query")
    n = len(FACT_NAMES)
    return [dict(zip(FACT_NAMES, out[t * n:(t + 1) * n])) for t in range(4)]


def _scores(wrapper, a_list, b_list):
    """[(best, idx)] per group, through the op: the plain version on the
    CPU, one kernel launch for CUDA tensors, counted in
    ``wrapper.launches``. The groups' outputs are views of the op's two
    flat buffers."""
    _device_of([*a_list, *b_list])  # raises on mixed or other devices
    best, idx = support_score_op(
        list(a_list), list(b_list), wrapper is fused_support_score
    )
    outs, o = [], 0
    for a, b in zip(a_list, b_list):
        m, l = a.shape[0], b.shape[2]
        outs.append((best[o:o + m * l].view(m, l),
                     idx[o:o + m * l].view(m, l)))
        o += m * l
    return outs


class _SupportScore(torch.autograd.Function):
    """The scorer over G groups, differentiable in every a and b.

    ``apply(wrapper, g, *a_list, *b_list)`` returns ``(*bests, *idxs)``;
    ``wrapper`` is the public function whose ``launches`` count the kernel's
    launches. The idxs are not differentiable. Saved for backward: a, b and
    idx of every group; the outputs are views of the op's two flat
    buffers, and the float one is not saved, so it is freed with the last
    view of a ``best``.

    Backward, per group: the output gradient g [M, L] is scattered to the
    chosen permutation, gp[m, idx[m, l], l] = g[m, l] (zero elsewhere), then
    da = sum_{p,l} gp[m,p,l] b[p,k,l] and db[p] = a^T gp[:, p].
    """

    @staticmethod
    def forward(ctx, wrapper, g: int, *ab):
        a_list, b_list = ab[:g], ab[g:]
        outs = _scores(wrapper, a_list, b_list)
        idxs = [idx for _, idx in outs]
        ctx.mark_non_differentiable(*idxs)
        ctx.save_for_backward(*a_list, *b_list, *idxs)
        ctx.groups = g
        return (*[best for best, _ in outs], *idxs)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.groups
        saved = ctx.saved_tensors
        need_a = ctx.needs_input_grad[2:2 + g]
        need_b = ctx.needs_input_grad[2 + g:]
        das, dbs = [], []
        for i in range(g):
            a, b, idx = saved[i], saved[g + i], saved[2 * g + i]
            m, l = idx.shape
            gp = grads[i].new_zeros(m, b.shape[0], l).scatter_(
                1, idx.long().unsqueeze(1), grads[i].unsqueeze(1)
            )  # [M, P, L]
            das.append(torch.einsum("mpl,pkl->mk", gp, b) if need_a[i]
                       else None)
            dbs.append(torch.einsum("mk,mpl->pkl", a, gp) if need_b[i]
                       else None)
        return (None, None, *das, *dbs)


def _run(wrapper, a_list, b_list):
    """[(best, idx)] per group, through ``_SupportScore`` when autograd
    records, else straight to the forward."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*a_list, *b_list)
    ):
        g = len(a_list)
        flat = _SupportScore.apply(wrapper, g, *a_list, *b_list)
        return list(zip(flat[:g], flat[g:]))
    return _scores(wrapper, a_list, b_list)


def fused_support_score(a: torch.Tensor, b: torch.Tensor):
    """Score one bucket: a [M, K], b [P, K, L] -> (best [M, L], idx [M, L])."""
    ((best, idx),) = _run(fused_support_score, [a], [b])
    return best, idx


fused_support_score.launches = 0


def grouped_support_score(a_list, b_list):
    """Score G groups in one launch.

    a_list[g]: [M_g, K_g]; b_list[g]: [P_g, K_g, L_g].
    Returns [(best [M_g, L_g], idx [M_g, L_g] int32)] * G.
    """
    if len(a_list) != len(b_list):
        raise ValueError("a_list and b_list differ in length")
    return _run(grouped_support_score, list(a_list), list(b_list))


grouped_support_score.launches = 0


# The counted kernel wrappers, whose ``launches`` a captured graph's replays
# add to: the scorer's two and the segment sum's (``ops/segment.py``).
SCORERS = (fused_support_score, grouped_support_score, segment_sum)


def launch_counts() -> List[int]:
    """The ``launches`` of every wrapper in ``SCORERS``."""
    return [w.launches for w in SCORERS]


def take_launches(before: Sequence[int]) -> List[int]:
    """The launches counted since ``launch_counts()`` gave ``before``,
    taken back from the counts: what a CUDA graph capture recorded, which
    ran nothing. Each replay adds them with ``add_launches``."""
    taken = [w.launches - n for w, n in zip(SCORERS, before)]
    for w, n in zip(SCORERS, before):
        w.launches = n
    return taken


def add_launches(counts: Sequence[int]) -> None:
    """Count one replay's launches (``take_launches``)."""
    for w, n in zip(SCORERS, counts):
        w.launches += n
