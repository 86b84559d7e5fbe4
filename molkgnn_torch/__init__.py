"""molkgnn_torch — the MolKGNN framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``molkgnn_tpu`` (the JAX/Pallas reference, kept beside it) with
the same module layout and names. Plain tensor code is PyTorch; the
support-attribute permutation scorer, the one Pallas kernel of the
reference, is a hand-written CUDA kernel (``csrc/support_score.cu``) that
is compiled with ``nvcc`` and loaded on its first CUDA call.

Importing this package, or any of its subpackages, loads neither CUDA code
nor JAX. The subpackages export the names the JAX package's do
(``from molkgnn_torch.training import Trainer``); ``native`` holds the
host C++ graph utilities, built with ``g++`` on first use.

Importing it sets one default for ``torch.profiler``: ``TEARDOWN_CUPTI=1``,
so that every profiler session detaches CUPTI, the card's tracing library,
at its end (see below).
"""

import os

__version__ = "0.1.0"

# With CUPTI left attached between profiler sessions, a CUDA graph captured
# after one session and replayed under a later one crashed the process (a
# segmentation fault inside CUDAGraph.replay: a Trainer's captured step,
# NVIDIA H100, torch 2.11 with CUDA 12.8); with it detached at each
# session's end, the same replays ran. An explicit setting wins.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch  # noqa: F401
