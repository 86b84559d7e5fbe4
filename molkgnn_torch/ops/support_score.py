"""Permutation-max support scorer: CUDA kernel wrappers and plain versions.

Port of ``molkgnn_tpu/ops/pallas_kernels.py``. For row-normalized
neighborhoods ``a`` [M, K] (K = d*F) and permuted supports ``b`` [P, K, L]:

    best[m, l] = max_p sum_k a[m, k] * b[p, k, l]      (a sum-cosine; the
    idx[m, l]  = first p reaching the max (int32)       caller divides by d)

``fused_support_score`` scores one bucket, ``grouped_support_score`` all
buckets of a layer in one launch. Both launch the same kernel,
``csrc/support_score.cu``. A wrapper takes the plain PyTorch version
(``support_score_plain``) only when its tensors lie on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in its ``launches`` attribute.

Forward only: the scores are not differentiable through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

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
        ptrs = ctypes.POINTER(ctypes.c_uint64)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.molkgnn_support_score.argtypes = [
            ctypes.c_int, ptrs, ptrs, ptrs, ptrs, ints, ints, ints, ints,
            ctypes.c_void_p,
        ]
        lib.molkgnn_support_score.restype = ctypes.c_int
        lib.molkgnn_error_string.argtypes = [ctypes.c_int]
        lib.molkgnn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(a_list, b_list):
    """Launch the kernel once over all groups; returns [(best, idx)]."""
    g = len(a_list)
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(
            f"support kernel takes 1..{MAX_GROUPS} groups, got {g}"
        )
    for a, b in zip(a_list, b_list):
        _check(a, b)
    device = a_list[0].device
    outs = []
    for a, b in zip(a_list, b_list):
        shape = (a.shape[0], b.shape[2])
        outs.append((
            torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device),
        ))
    lib = _kernel_lib()
    ptrs = ctypes.c_uint64 * g
    ints = ctypes.c_int * g
    with torch.cuda.device(device):
        err = lib.molkgnn_support_score(
            g,
            ptrs(*(a.data_ptr() for a in a_list)),
            ptrs(*(b.data_ptr() for b in b_list)),
            ptrs(*(best.data_ptr() for best, _ in outs)),
            ptrs(*(idx.data_ptr() for _, idx in outs)),
            ints(*(a.shape[0] for a in a_list)),
            ints(*(a.shape[1] for a in a_list)),
            ints(*(b.shape[2] for b in b_list)),
            ints(*(b.shape[0] for b in b_list)),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        msg = lib.molkgnn_error_string(err).decode()
        raise RuntimeError(
            f"support score kernel launch failed: {msg} ({err})"
        )
    return outs


def fused_support_score(a: torch.Tensor, b: torch.Tensor):
    """Score one bucket: a [M, K], b [P, K, L] -> (best [M, L], idx [M, L])."""
    if _device_of([a, b]).type == "cpu":
        return support_score_plain(a, b)
    ((best, idx),) = _launch([a], [b])
    fused_support_score.launches += 1
    return best, idx


fused_support_score.launches = 0


def grouped_support_score(a_list, b_list):
    """Score G groups in one launch.

    a_list[g]: [M_g, K_g]; b_list[g]: [P_g, K_g, L_g].
    Returns [(best [M_g, L_g], idx [M_g, L_g] int32)] * G.
    """
    if len(a_list) != len(b_list):
        raise ValueError("a_list and b_list differ in length")
    if _device_of([*a_list, *b_list]).type == "cpu":
        return [support_score_plain(a, b) for a, b in zip(a_list, b_list)]
    outs = _launch(list(a_list), list(b_list))
    grouped_support_score.launches += 1
    return outs


grouped_support_score.launches = 0
