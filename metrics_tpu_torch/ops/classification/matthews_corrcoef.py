"""Matthews correlation coefficient over a confusion matrix (counterpart of
``metrics_tpu/ops/classification/matthews_corrcoef.py``)."""
from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    i = confmat.dtype
    tk = confmat.sum(dim=1, dtype=i).to(torch.float32)
    pk = confmat.sum(dim=0, dtype=i).to(torch.float32)
    c = torch.trace(confmat).to(i).to(torch.float32)
    s = confmat.sum(dtype=i).to(torch.float32)

    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()

    denom = cov_ypyp * cov_ytyt
    return torch.where(denom == 0, 0.0, cov_ytyp / torch.sqrt(torch.where(denom == 0, 1.0, denom)))


def matthews_corrcoef(preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5) -> Tensor:
    """The correlation between predicted and true labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import matthews_corrcoef
        >>> round(float(matthews_corrcoef(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2)), 4)
        0.5774
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
