"""Training: metrics, the schedule, the optimizer, the model with its head,
the ``Trainer`` and the checkpoint bridge.

Port of ``molkgnn_tpu/training``; the same names are exported here. They
load on first access (module ``__getattr__``): the lower layers import
``training.metrics`` and ``training.optim``, and the ``Trainer`` imports
them, so eager imports here would be circular.
"""

import importlib

# name -> the module that defines it
_EXPORTS = {
    "calculate_logAUC": "molkgnn_torch.training.metrics",
    "calculate_auc": "molkgnn_torch.training.metrics",
    "calculate_ppv": "molkgnn_torch.training.metrics",
    "calculate_accuracy": "molkgnn_torch.training.metrics",
    "calculate_f1_score": "molkgnn_torch.training.metrics",
    "compute_metrics": "molkgnn_torch.training.metrics",
    "polynomial_warmup_decay": "molkgnn_torch.training.schedule",
    "make_optimizer": "molkgnn_torch.training.optim",
    "GNNModel": "molkgnn_torch.training.model",
    "Trainer": "molkgnn_torch.training.trainer",
    "TrainConfig": "molkgnn_torch.training.trainer",
    "from_torch_state_dict": "molkgnn_torch.training.checkpoint",
    "load_torch_checkpoint": "molkgnn_torch.training.checkpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
