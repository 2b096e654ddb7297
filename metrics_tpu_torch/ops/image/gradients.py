"""Image gradients by one-step finite differences (counterpart of
``metrics_tpu/ops/image/gradients.py``)."""
from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    # zero-pad the last row/column so gradients keep the input shape
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """``(dy, dx)`` finite-difference gradients of an (N, C, H, W) batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import image_gradients
        >>> img = torch.arange(25, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, 0].tolist()
        [5.0, 5.0, 5.0, 5.0, 5.0]
        >>> dx[0, 0, 0].tolist()
        [1.0, 1.0, 1.0, 1.0, 0.0]
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
