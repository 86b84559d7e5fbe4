"""Inference: the ``Predictor`` (batched scoring, screening, export).

Port of ``molkgnn_tpu/serving``; the same names are exported here.
"""

from molkgnn_torch.serving.predictor import Predictor

__all__ = ["Predictor"]
