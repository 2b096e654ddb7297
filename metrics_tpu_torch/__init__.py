"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu.

A second package beside ``metrics_tpu`` (the JAX reference, left unchanged).
It imports torch and numpy and never JAX or ``metrics_tpu``. Metric state
lives on CUDA unless a metric is built with ``device="cpu"``; the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use. ``update()`` and ``compute()`` replay a captured CUDA
graph from the second call of each input signature (``core/engine.py``; the
switches below turn that off).
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
from metrics_tpu_torch.core.engine import (
    compiled_compute_enabled,
    compiled_update_enabled,
    fused_update_enabled,
    probation_cooldown,
    set_compiled_compute,
    set_compiled_update,
    set_fused_update,
    set_probation,
)
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.parallel import bucketed_sync_enabled, set_bucketed_sync
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
    "bucketed_sync_enabled",
    "compiled_compute_enabled",
    "compiled_update_enabled",
    "fused_update_enabled",
    "probation_cooldown",
    "set_bucketed_sync",
    "set_compiled_compute",
    "set_compiled_update",
    "set_fused_update",
    "set_probation",
]
