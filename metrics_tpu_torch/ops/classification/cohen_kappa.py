"""Cohen's kappa over a confusion matrix (counterpart of
``metrics_tpu/ops/classification/cohen_kappa.py``).

The expected matrix ``sum1 @ sum0`` there is an outer product (K = 1): here
the broadcast ``sum1 * sum0``, one rounding per entry as XLA's dot, and out
of reach of any TF32 setting.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.confusion_matrix import _confusion_matrix_compute, _confusion_matrix_update

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    confmat = _confusion_matrix_compute(confmat).to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[None, :] - idx[:, None]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'")

    k = (w_mat * confmat).sum() / (w_mat * expected).sum()
    return 1 - k


def cohen_kappa(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> Tensor:
    """Inter-annotator agreement.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import cohen_kappa
        >>> round(float(cohen_kappa(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2)), 4)
        0.5
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
