"""Functional metrics on tensors."""
from metrics_tpu_torch.ops.classification.accuracy import accuracy
from metrics_tpu_torch.ops.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.ops.classification.precision_recall import precision, precision_recall, recall
from metrics_tpu_torch.ops.classification.stat_scores import stat_scores

__all__ = ["accuracy", "f1_score", "fbeta_score", "precision", "precision_recall", "recall", "stat_scores"]
