"""Matthews correlation coefficient over a confusion matrix (counterpart of
``metrics_tpu/ops/classification/matthews_corrcoef.py``)."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.ops.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor, group=None) -> Tensor:
    """The coefficient of a confusion matrix. With a ``group`` the matrix is
    this rank's block of rows (the sharded compute): the row sums are
    block-local (one small gather); the column partials, the block's share
    of the diagonal and its total fold through one integer ``psum``, exact,
    so the float32 casts match the replicated path bit for bit. O(C) bytes
    cross instead of the O(C^2) reshard."""
    from metrics_tpu_torch.parallel import sync as _psync  # at call time: parallel imports core, core the metrics

    i = confmat.dtype
    nrows = confmat.shape[0]
    row_start = 0 if group is None else dist.get_rank(group) * nrows
    tk_local = confmat.sum(dim=1, dtype=i)
    pk_local = confmat.sum(dim=0, dtype=i)
    c_local = torch.diagonal(confmat[:, row_start : row_start + nrows]).sum(dtype=i)
    s_local = confmat.sum(dtype=i)
    combined = _psync.psum_result(torch.cat([pk_local, c_local.reshape(1), s_local.reshape(1)]), group)
    tk = _psync.gather_result(tk_local, group).to(torch.float32)
    num_classes = combined.shape[0] - 2
    pk = combined[:num_classes].to(torch.float32)
    c = combined[num_classes].to(torch.float32)
    s = combined[num_classes + 1].to(torch.float32)

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
