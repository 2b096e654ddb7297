"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu.

A second package beside ``metrics_tpu`` (the JAX reference, left unchanged).
It imports torch and numpy and never JAX or ``metrics_tpu``. Metric state
lives on CUDA unless a metric is built with ``device="cpu"``; the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use.
"""
from metrics_tpu_torch.classification import (
    Accuracy,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    F1Score,
    FBetaScore,
    Precision,
    Recall,
    StatScores,
)
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.text import BERTScore

__all__ = [
    "Accuracy",
    "BERTScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CompositionalMetric",
    "F1Score",
    "FBetaScore",
    "MeanAveragePrecision",
    "Metric",
    "MetricCollection",
    "Precision",
    "Recall",
    "StatScores",
]
