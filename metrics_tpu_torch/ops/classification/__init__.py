"""Functional classification metrics on tensors (counterpart of
``metrics_tpu/ops/classification/__init__.py``)."""
from metrics_tpu_torch.ops.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.ops.classification.auc import auc  # noqa: F401
from metrics_tpu_torch.ops.classification.auroc import auroc  # noqa: F401
from metrics_tpu_torch.ops.classification.average_precision import average_precision  # noqa: F401
from metrics_tpu_torch.ops.classification.calibration_error import calibration_error  # noqa: F401
from metrics_tpu_torch.ops.classification.cohen_kappa import cohen_kappa  # noqa: F401
from metrics_tpu_torch.ops.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.ops.classification.dice import dice, dice_score  # noqa: F401
from metrics_tpu_torch.ops.classification.f_beta import f1_score, fbeta_score  # noqa: F401
from metrics_tpu_torch.ops.classification.hamming import hamming_distance  # noqa: F401
from metrics_tpu_torch.ops.classification.hinge import hinge_loss  # noqa: F401
from metrics_tpu_torch.ops.classification.jaccard import jaccard_index  # noqa: F401
from metrics_tpu_torch.ops.classification.kl_divergence import kl_divergence  # noqa: F401
from metrics_tpu_torch.ops.classification.matthews_corrcoef import matthews_corrcoef  # noqa: F401
from metrics_tpu_torch.ops.classification.precision_recall import precision, precision_recall, recall  # noqa: F401
from metrics_tpu_torch.ops.classification.precision_recall_curve import precision_recall_curve  # noqa: F401
from metrics_tpu_torch.ops.classification.ranking import (  # noqa: F401
    coverage_error,
    label_ranking_average_precision,
    label_ranking_loss,
)
from metrics_tpu_torch.ops.classification.roc import roc  # noqa: F401
from metrics_tpu_torch.ops.classification.specificity import specificity  # noqa: F401
from metrics_tpu_torch.ops.classification.stat_scores import stat_scores  # noqa: F401
