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
card. The registry (``SCORERS``) holds the backward's wrapper, the segment
sum's and its plan builder's too.

Gradients: when autograd records (grad enabled and an input requires grad),
both wrappers go through one ``torch.autograd.Function`` over G groups,
``_SupportScore``. Its backward is the JAX custom VJP
(``pallas_kernels.py:76`` and ``:251``): the gradient flows only through
the chosen permutation,

    da[m, k]    = sum_l g[m, l] * b[idx[m, l], k, l]
    db[p, k, l] = sum_m [idx[m, l] == p] * a[m, k] * g[m, l],

for the groups and inputs that need it (``needs_input_grad``), through one
more registered op, ``torch.ops.molkgnn.support_score_backward``:

  * CUDA: the kernels of ``csrc/support_score_bwd.cu``, one call for all
    the groups, counted in ``support_score_backward.launches``: both
    gradients as dense products with the one-hot matrix
    S[m, p * L + l] = g[m, l] [idx[m, l] == p] on the tensor cores, in
    3xTF32 (every fp32 operand split into TF32 hi and lo parts, three
    products; ``support_score_backward_3xtf32`` emulates the split), each
    tensor-core accumulator added into an fp32 sum every few steps
    (``support_score_backward_emulated`` models that rounding):
    b packed for da, da, db's partial sums over fixed ranges of rows, then
    their sum in a fixed order. No atomics and no host sync: a call repeats
    bit for bit and a CUDA graph captures it;
  * CPU: the plain version, ``support_score_backward_plain`` (the output
    gradient scattered to the chosen permutation of a zero [M, P, L]
    tensor, then two products), uncounted;
  * fake (meta): the output shapes.

A CUDA tensor launches the kernels or raises; it never reaches the plain
version. Without autograd (``torch.no_grad``/``inference_mode``) the
wrappers call the forward op directly and the Function costs nothing. The
Function stays around the ops (rather than
``torch.library.register_autograd``) so that the per-group views and the
saved argmaxes are those of the training slice.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from molkgnn_torch.ops.segment import segment_plan, segment_sum

MAX_GROUPS = 16  # kMaxGroups in csrc/support_score.cu


def support_score_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain version: einsum, then max/argmax over p (first max wins).

    Computes in the inputs' dtype (fp32 on the card, fp64 in the CPU parity
    tests). Returns (best [M, L], idx [M, L] int32).
    """
    sc = torch.einsum("mk,pkl->mlp", a, b)
    best, idx = sc.max(dim=2)
    return best, idx.to(torch.int32)


def support_score_backward_plain(a: torch.Tensor, b: torch.Tensor,
                                 g: torch.Tensor, idx: torch.Tensor,
                                 need_a: bool = True, need_b: bool = True):
    """Plain version of one group's backward, the dense route: the output
    gradient g [M, L] scattered to the chosen permutation of a zero
    [M, P, L] tensor, gp[m, idx[m, l], l] = g[m, l], then
    da = sum_{p,l} gp[m, p, l] b[p, k, l] and db[p] = a^T gp[:, p].

    Computes in the inputs' dtype. Returns (da [M, K] or None, db [P, K, L]
    or None), each None where it is not needed.
    """
    gp = g.new_zeros(idx.shape[0], b.shape[0], idx.shape[1]).scatter_(
        1, idx.long().unsqueeze(1), g.unsqueeze(1))
    da = torch.einsum("mpl,pkl->mk", gp, b) if need_a else None
    db = torch.einsum("mk,mpl->pkl", a, gp) if need_b else None
    return da, db


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 stored mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``: an fp32 tensor whose 13
    low mantissa bits are 0 (finite values; the sign is left alone, so the
    magnitude rounds)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)): x = hi + lo up to about 2^-22
    of |x|, the split of ``split_tf32`` in csrc/support_score_bwd.cu."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def support_score_backward_3xtf32(a: torch.Tensor, b: torch.Tensor,
                                  g: torch.Tensor, idx: torch.Tensor,
                                  need_a: bool = True, need_b: bool = True,
                                  terms: int = 3):
    """The arithmetic of the CUDA backward kernels for one group, emulated
    in plain PyTorch (a check of the split; nothing on a model path calls
    it). The one-hot S [M, P, L] (g at the chosen permutation), a and b
    are split into TF32 hi and lo parts (``split_tf32``), and each gradient
    is lo*hi + hi*lo + hi*hi of the dense products, each product exact in
    fp32 and summed in fp32 by its own einsum. The kernels add the three
    into one accumulator a step of 8 terms, and the tensor cores round each
    such addition toward zero, which this does not model
    (``support_score_backward_emulated`` does).
    ``terms=1`` keeps hi*hi alone: plain TF32. Returns
    (da [M, K] or None, db [P, K, L] or None) in fp32."""
    if terms not in (1, 3):
        raise ValueError(f"terms is 1 or 3, got {terms}")
    a, b, g = (t.to(torch.float32) for t in (a, b, g))
    s = g.new_zeros(idx.shape[0], b.shape[0], idx.shape[1]).scatter_(
        1, idx.long().unsqueeze(1), g.unsqueeze(1))

    def product(eq, x, y):
        (x_hi, x_lo), (y_hi, y_lo) = split_tf32(x), split_tf32(y)
        out = torch.einsum(eq, x_hi, y_hi)
        if terms == 3:
            out = (torch.einsum(eq, x_lo, y_hi) + torch.einsum(eq, x_hi, y_lo)
                   + out)
        return out

    da = product("mpl,pkl->mk", s, b) if need_a else None
    db = product("mk,mpl->pkl", a, s) if need_b else None
    return da, db


# The kernels' promotion intervals in k8 steps: kDaPromoteSteps, and 4
# kDbPromoteChunks (a chunk of db is 32 rows), of csrc/support_score_bwd.cu.
DA_PROMOTE_STEPS = 4
DB_PROMOTE_STEPS = 4


def _round_fp32(x: torch.Tensor, toward_zero: bool) -> torch.Tensor:
    """fp64 ``x`` rounded to fp32, toward zero or to nearest (even), as an
    fp32 tensor."""
    r = x.to(torch.float32)
    if not toward_zero:
        return r
    over = (r.double().abs() > x.abs()).to(torch.int32)
    return (r.view(torch.int32) - over).view(torch.float32)


def _tensor_core_sum(steps, promote, toward_zero):
    """The sum of the k8 steps' products as the kernels take it: ``steps``
    yields each step's three exact (fp64) products lo*hi, hi*lo, hi*hi,
    each added into the fp32 accumulator and rounded (toward zero on the
    tensor cores); every ``promote`` steps (None: at the end only) the
    accumulator is added into an fp32 sum, rounded to nearest, and starts
    again from the next product."""
    total = acc = None
    for t, products in enumerate(steps):
        if promote is not None and t % promote == 0 and acc is not None:
            total = acc if total is None else total + acc
            acc = None
        for x in products:
            acc = _round_fp32(x if acc is None else acc.double() + x,
                              toward_zero)
    if acc is not None:
        total = acc if total is None else total + acc
    return total


def support_score_backward_emulated(a: torch.Tensor, b: torch.Tensor,
                                    g: torch.Tensor, idx: torch.Tensor,
                                    need_a: bool = True, need_b: bool = True,
                                    *, da_promote=DA_PROMOTE_STEPS,
                                    db_promote=DB_PROMOTE_STEPS,
                                    db_rows=None, toward_zero: bool = True):
    """The CUDA backward kernels' arithmetic for one group, emulated in
    plain PyTorch (a model of their rounding; nothing on a model path calls
    it). The operands are taken as fp32 and split into TF32 hi and lo
    (``split_tf32``). da sums over n' = l P + p and db over the rows of each
    range of ``db_rows`` rows (a multiple of 8; None: one range of all M),
    8 terms a k8 step: each step's products lo*hi, hi*lo and hi*hi are
    taken exactly (fp64) and added into an fp32 accumulator, rounded toward
    zero as the tensor cores round (to nearest with ``toward_zero=False``);
    every ``da_promote`` / ``db_promote`` steps (None: never) the
    accumulator is added into the fp32 sum, rounded to nearest
    (``_tensor_core_sum``). db adds its ranges' sums in eight fp32 running
    sums, range r into sum r % 8 in ascending r, then ((s0 + s1) + (s2 +
    s3)) + ((s4 + s5) + (s6 + s7)), as ``score_grad_db_sum_kernel`` does.
    Returns (da [M, K] or None, db [P, K, L] or None) in fp32."""
    a, b, g = (t.to(torch.float32) for t in (a, b, g))
    m, k = a.shape
    p, _, l = b.shape
    s = g.new_zeros(m, p, l).scatter_(1, idx.long().unsqueeze(1),
                                      g.unsqueeze(1))
    da = db = None
    if need_a:
        # S [M, n'] and Bt [n', K] over n' = l P + p, 8 n' a step.
        s_hl = split_tf32(s.transpose(1, 2).reshape(m, l * p))
        bt_hl = split_tf32(b.permute(2, 0, 1).reshape(l * p, k))
        (s_hi, s_lo), (bt_hi, bt_lo) = ([x.double() for x in pair]
                                        for pair in (s_hl, bt_hl))

        def da_steps():
            for n0 in range(0, l * p, 8):
                c = slice(n0, n0 + 8)
                yield (s_lo[:, c] @ bt_hi[c], s_hi[:, c] @ bt_lo[c],
                       s_hi[:, c] @ bt_hi[c])

        da = (_tensor_core_sum(da_steps(), da_promote, toward_zero)
              if l * p else a.new_zeros(m, k))
    if need_b:
        # a^T [ranges][K, rows] and S [ranges][rows, n], n = p L + l, rows
        # past M zero.
        rows = m if db_rows is None else db_rows
        ranges = max(1, -(-m // rows))
        pad = ranges * rows - m
        a_hl = split_tf32(torch.nn.functional.pad(a, (0, 0, 0, pad)))
        s_hl = split_tf32(torch.nn.functional.pad(
            s.reshape(m, p * l), (0, 0, 0, pad)))
        a_hi, a_lo = (x.double().reshape(ranges, rows, k).transpose(1, 2)
                      for x in a_hl)
        s_hi, s_lo = (x.double().reshape(ranges, rows, p * l) for x in s_hl)

        def db_steps():
            for r0 in range(0, rows, 8):
                c = slice(r0, r0 + 8)
                yield (a_lo[..., c] @ s_hi[:, c], a_hi[..., c] @ s_lo[:, c],
                       a_hi[..., c] @ s_hi[:, c])

        part = (_tensor_core_sum(db_steps(), db_promote, toward_zero)
                if rows else a.new_zeros(ranges, k, p * l))
        sums = [part[j] for j in range(min(8, ranges))]
        for r in range(8, ranges):
            sums[r % 8] = sums[r % 8] + part[r]
        sums += [torch.zeros_like(part[0])] * (8 - len(sums))
        out = (((sums[0] + sums[1]) + (sums[2] + sums[3]))
               + ((sums[4] + sums[5]) + (sums[6] + sums[7])))
        db = out.reshape(k, p, l).transpose(0, 1).contiguous()
    return da, db


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


def backward_offsets(shapes, need_a, need_b):
    """Element offsets of the groups' da [M, K] and db [P, K, L] in two flat
    buffers (a gradient that is not needed takes no room), and the two
    buffers' lengths: (da offsets, da length, db offsets, db length).
    shapes: [(M, K, L, P)]."""
    da_off, db_off, n_da, n_db = [], [], 0, 0
    for (m, k, l, p), want_a, want_b in zip(shapes, need_a, need_b):
        da_off.append(n_da)
        db_off.append(n_db)
        n_da += m * k if want_a else 0
        n_db += p * k * l if want_b else 0
    return da_off, n_da, db_off, n_db


def _bwd_lib() -> ctypes.CDLL:
    """The built backward library, with its C signatures declared."""
    from molkgnn_torch.ops._build import library

    lib = library("support_score_bwd")
    if lib.molkgnn_support_score_backward.argtypes is None:
        args = ctypes.POINTER(ctypes.c_int64)
        lib.molkgnn_support_score_backward.argtypes = [
            ctypes.c_int, args, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.molkgnn_support_score_backward.restype = ctypes.c_int
        lib.molkgnn_support_score_backward_scratch.argtypes = [
            ctypes.c_int, args,
        ]
        lib.molkgnn_support_score_backward_scratch.restype = ctypes.c_int64
        lib.molkgnn_support_score_backward_facts.argtypes = [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.molkgnn_support_score_backward_facts.restype = ctypes.c_int
        lib.molkgnn_support_score_backward_error_string.argtypes = [
            ctypes.c_int
        ]
        lib.molkgnn_support_score_backward_error_string.restype = (
            ctypes.c_char_p)
    return lib


def _raise_on_backward(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.molkgnn_support_score_backward_error_string(err).decode()
        raise RuntimeError(
            f"support score backward kernels {what} failed: {msg} ({err})"
        )


@functools.lru_cache(maxsize=256)
def _backward_scratch(shapes: tuple, need_a: tuple, need_b: tuple) -> int:
    """Floats of scratch (the packed b and db's partial sums) for groups
    of these (M, K, L, P) and needs, in launch order; asked of the library,
    which lays them out."""
    lib = _bwd_lib()
    args = [v for shape, want_a, want_b in zip(shapes, need_a, need_b)
            for v in (0, 0, 0, 0, int(want_a), int(want_b), *shape)]
    n = lib.molkgnn_support_score_backward_scratch(
        len(shapes), (ctypes.c_int64 * len(args))(*args))
    if n < 0:
        raise ValueError(f"support backward does not take groups {shapes}")
    return n


def _check_backward(a, b, g, idx) -> None:
    _check(a, b)
    m, l = a.shape[0], b.shape[2]
    if g.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"support backward takes a float32 gradient and int32 argmaxes, "
            f"got {g.dtype} and {idx.dtype}"
        )
    if g.shape != (m, l) or idx.shape != (m, l):
        raise ValueError(
            f"support backward: gradient and argmaxes of shape {(m, l)}, got "
            f"{tuple(g.shape)} and {tuple(idx.shape)}"
        )
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("support backward takes a contiguous gradient and "
                         "argmaxes")


def _backward_launch(a_list, b_list, g_list, idx_list, need_a, need_b):
    """One call of the backward kernels over all groups; returns the flat
    (da, db) buffers at ``backward_offsets``. The packed b (for da) and
    db's partial sums go to a scratch buffer of their own, released
    (stream-ordered) when the call returns."""
    n = len(a_list)
    if not 1 <= n <= MAX_GROUPS:
        raise ValueError(
            f"support backward takes 1..{MAX_GROUPS} groups, got {n}"
        )
    shapes = []
    for a, b, g, idx in zip(a_list, b_list, g_list, idx_list):
        _check_backward(a, b, g, idx)
        shapes.append((a.shape[0], a.shape[1], b.shape[2], b.shape[0]))
    da_off, n_da, db_off, n_db = backward_offsets(shapes, need_a, need_b)
    device = a_list[0].device
    da = torch.empty(n_da, dtype=torch.float32, device=device)
    db = torch.empty(n_db, dtype=torch.float32, device=device)
    order = block_order(shapes)
    scratch = _backward_scratch(tuple(shapes[i] for i in order),
                                tuple(need_a[i] for i in order),
                                tuple(need_b[i] for i in order))
    part = torch.empty(scratch, dtype=torch.float32, device=device)
    args = []
    for i in order:
        args += (
            a_list[i].data_ptr(), b_list[i].data_ptr(), g_list[i].data_ptr(),
            idx_list[i].data_ptr(),
            da.data_ptr() + 4 * da_off[i] if need_a[i] else 0,
            db.data_ptr() + 4 * db_off[i] if need_b[i] else 0, *shapes[i],
        )
    lib = _bwd_lib()
    same = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(device):
        err = lib.molkgnn_support_score_backward(
            n, (ctypes.c_int64 * len(args))(*args), part.data_ptr(), scratch,
            torch._C._cuda_getCurrentRawStream(device.index),
        )
    _raise_on_backward(lib, err, "launch")
    return da, db


@torch.library.custom_op(
    "molkgnn::support_score_backward", mutates_args=(), device_types="cpu"
)
def support_score_backward_op(
    a_list: List[torch.Tensor], b_list: List[torch.Tensor],
    g_list: List[torch.Tensor], idx_list: List[torch.Tensor],
    need_a: List[bool], need_b: List[bool],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scorer's backward over G groups as one op: (da, db) flat, group
    after group at ``backward_offsets`` (see the module doc). This body is
    the CPU version, the plain one."""
    das, dbs = [], []
    for a, b, g, idx, want_a, want_b in zip(a_list, b_list, g_list,
                                            idx_list, need_a, need_b):
        da, db = support_score_backward_plain(a, b, g, idx, want_a, want_b)
        if da is not None:
            das.append(da.reshape(-1))
        if db is not None:
            dbs.append(db.reshape(-1))
    empty = a_list[0].new_empty(0)
    return (torch.cat(das) if das else empty,
            torch.cat(dbs) if dbs else empty.clone())


@support_score_backward_op.register_kernel("cuda")
def _support_score_backward_cuda(a_list, b_list, g_list, idx_list, need_a,
                                 need_b):
    out = _backward_launch(a_list, b_list, g_list, idx_list, need_a, need_b)
    support_score_backward.launches += 1
    return out


@support_score_backward_op.register_fake
def _support_score_backward_fake(a_list, b_list, g_list, idx_list, need_a,
                                 need_b):
    _, n_da, _, n_db = backward_offsets(
        [(a.shape[0], a.shape[1], b.shape[2], b.shape[0])
         for a, b in zip(a_list, b_list)], need_a, need_b)
    return a_list[0].new_empty(n_da), a_list[0].new_empty(n_db)


def support_score_backward(a_list, b_list, g_list, idx_list, need_a=None,
                           need_b=None):
    """The scorer's backward over G groups: ([da_g or None], [db_g or None])
    for a_list[g] [M, K], b_list[g] [P, K, L], the output gradients
    g_list[g] [M, L] and the forward's argmaxes idx_list[g] [M, L] (int32),
    each gradient only where ``need_a``/``need_b`` (default: all) asks for
    it. Through the op: the plain version on the CPU, one call of the
    kernels for CUDA tensors, counted in ``support_score_backward.launches``.
    The gradients are views of the op's two flat buffers."""
    n = len(a_list)
    need_a = [True] * n if need_a is None else [bool(x) for x in need_a]
    need_b = [True] * n if need_b is None else [bool(x) for x in need_b]
    if not (len(b_list) == len(g_list) == len(idx_list) == len(need_a)
            == len(need_b) == n):
        raise ValueError("support backward: argument lists differ in length")
    if not any(need_a) and not any(need_b):
        return [None] * n, [None] * n
    _device_of([*a_list, *b_list, *g_list, *idx_list])  # raises on mixed
    shapes = [(a.shape[0], a.shape[1], b.shape[2], b.shape[0])
              for a, b in zip(a_list, b_list)]
    da, db = support_score_backward_op(
        list(a_list), list(b_list), [g.contiguous() for g in g_list],
        list(idx_list), need_a, need_b)
    da_off, _, db_off, _ = backward_offsets(shapes, need_a, need_b)
    das, dbs = [], []
    for (m, k, l, p), o_a, o_b, want_a, want_b in zip(
            shapes, da_off, db_off, need_a, need_b):
        das.append(da[o_a:o_a + m * k].view(m, k) if want_a else None)
        dbs.append(db[o_b:o_b + p * k * l].view(p, k, l) if want_b else None)
    return das, dbs


support_score_backward.launches = 0

BACKWARD_FACT_NAMES = ("registers", "static_smem_bytes", "local_bytes",
                       "blocks_per_sm")
BACKWARD_KERNELS = ("pack", "da", "db", "db_sum")


def backward_facts() -> dict:
    """The built backward kernels' facts on the current device, by kernel
    (see ``molkgnn_support_score_backward_facts`` in
    csrc/support_score_bwd.cu)."""
    lib = _bwd_lib()
    n = len(BACKWARD_FACT_NAMES)
    out = (ctypes.c_int * (n * len(BACKWARD_KERNELS)))()
    _raise_on_backward(lib, lib.molkgnn_support_score_backward_facts(out),
                       "query")
    return {name: dict(zip(BACKWARD_FACT_NAMES, out[i * n:(i + 1) * n]))
            for i, name in enumerate(BACKWARD_KERNELS)}


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

    Backward: ``support_score_backward`` over every group at once, for the
    inputs that need a gradient (fixed kernel sets give b without one; a
    fixed-set layer passes one a to two groups, and autograd adds the two
    results).
    """

    @staticmethod
    def forward(ctx, wrapper, g: int, *ab):
        a_list, b_list = ab[:g], ab[g:]
        outs = _scores(wrapper, a_list, b_list)
        idxs = [idx for _, idx in outs]
        ctx.mark_non_differentiable(*idxs)
        ctx.save_for_backward(*a_list, *b_list, *idxs)
        ctx.groups = g
        # No zero gradients made for the argmaxes (or for an unused best).
        ctx.set_materialize_grads(False)
        return (*[best for best, _ in outs], *idxs)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.groups
        saved = ctx.saved_tensors
        a_list, idxs = saved[:g], saved[2 * g:]
        g_list = [grad if grad is not None
                  else idx.new_zeros(idx.shape, dtype=a.dtype)
                  for grad, a, idx in zip(grads[:g], a_list, idxs)]
        das, dbs = support_score_backward(
            a_list, saved[g:2 * g], g_list, idxs,
            ctx.needs_input_grad[2:2 + g], ctx.needs_input_grad[2 + g:])
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
# add to: the scorer's two, its backward's, the segment sum's and its plan
# builder's (``ops/segment.py``).
SCORERS = (fused_support_score, grouped_support_score, support_score_backward,
           segment_sum, segment_plan)


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
