"""The encoders: MolKGNN and the baselines.

Port of ``molkgnn_tpu/models``; the same names are exported here (the
kgnn modules). The baselines are imported by module, or by family name
through ``models.registry.get_family``.
"""

from molkgnn_torch.models.kgnn import (
    KernelConv,
    KernelSetConv,
    MolGCN,
    MolKGNNNet,
)

__all__ = [
    "KernelConv",
    "KernelSetConv",
    "MolGCN",
    "MolKGNNNet",
]
