"""molkgnn_torch — the MolKGNN framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``molkgnn_tpu`` (the JAX/Pallas reference, kept beside it) with
the same module layout and names. Plain tensor code is PyTorch; the
support-attribute permutation scorer, the one Pallas kernel of the
reference, is a hand-written CUDA kernel (``csrc/support_score.cu``) that
is compiled with ``nvcc`` and loaded on its first CUDA call.

Importing this package loads neither CUDA code nor JAX.
"""

__version__ = "0.1.0"
