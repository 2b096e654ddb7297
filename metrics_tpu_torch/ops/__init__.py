"""Functional metrics on tensors."""
from metrics_tpu_torch.ops.classification import (
    accuracy,
    auc,
    auroc,
    average_precision,
    calibration_error,
    cohen_kappa,
    confusion_matrix,
    coverage_error,
    dice,
    dice_score,
    f1_score,
    fbeta_score,
    hamming_distance,
    hinge_loss,
    jaccard_index,
    kl_divergence,
    label_ranking_average_precision,
    label_ranking_loss,
    matthews_corrcoef,
    precision,
    precision_recall,
    precision_recall_curve,
    recall,
    roc,
    specificity,
    stat_scores,
)
from metrics_tpu_torch.ops.text.bert import bert_score

__all__ = [
    "accuracy", "auc", "auroc", "average_precision", "bert_score", "calibration_error", "cohen_kappa",
    "confusion_matrix", "coverage_error", "dice", "dice_score", "f1_score", "fbeta_score", "hamming_distance",
    "hinge_loss", "jaccard_index", "kl_divergence", "label_ranking_average_precision", "label_ranking_loss",
    "matthews_corrcoef", "precision", "precision_recall", "precision_recall_curve", "recall", "roc",
    "specificity", "stat_scores",
]
