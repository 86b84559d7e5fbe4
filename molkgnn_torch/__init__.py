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
"""

__version__ = "0.1.0"

from molkgnn_torch.graphs.batch import DegreeBucket, GraphBatch  # noqa: F401
