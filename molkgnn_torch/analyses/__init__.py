"""Analyses of trained models: kernel decoding, embedding comparison,
fixed kernel sets and their score capture.

Port of ``molkgnn_tpu/analyses``; the same names are exported here
(``embedding_compare.enantiomer_separation`` is imported by module, as in
the JAX package).
"""

from molkgnn_torch.analyses.kernel_reader import (
    decode_kernels,
    interpret_kernel,
)
from molkgnn_torch.analyses.embedding_compare import compare_embeddings
from molkgnn_torch.analyses.fixed_kernels import (
    capture_layer0_scores,
    dump_scores,
    load_customized_kernels,
    save_customized_kernels,
)

__all__ = [
    "decode_kernels",
    "interpret_kernel",
    "compare_embeddings",
    "capture_layer0_scores",
    "dump_scores",
    "load_customized_kernels",
    "save_customized_kernels",
]
