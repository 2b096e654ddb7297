"""Box operations (counterpart of ``metrics_tpu/ops/detection/boxes.py``).

The same operations in the same order as the JAX package, each an IEEE
float32 op, so results agree bit for bit with its eager ``box_iou``.
``mask_iou`` and ``mask_area`` wait for the ``segm`` path.
"""
from __future__ import annotations

import torch
from torch import Tensor

_FORMATS = ("xyxy", "xywh", "cxcywh")


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert [N, 4] boxes between xyxy / xywh / cxcywh formats.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.boxes import box_convert
        >>> box_convert(torch.tensor([[1.0, 1.0, 2.0, 2.0]]), 'xywh', 'xyxy').tolist()
        [[1.0, 1.0, 3.0, 3.0]]
    """
    if in_fmt not in _FORMATS or out_fmt not in _FORMATS:
        raise ValueError(f"Unsupported box format: {in_fmt} -> {out_fmt}; supported: {_FORMATS}")
    if in_fmt == out_fmt:
        return boxes
    if boxes.numel() == 0:
        return boxes.reshape(0, 4)
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        xyxy = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    else:
        xyxy = boxes
    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """[..., 4] xyxy boxes -> [...] areas.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.boxes import box_area
        >>> box_area(torch.tensor([[0.0, 0.0, 2.0, 2.0], [1.0, 1.0, 3.0, 3.0]])).tolist()
        [4.0, 4.0]
    """
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M],
    0 where the union is not positive.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.boxes import box_iou
        >>> a = torch.tensor([[0.0, 0.0, 2.0, 2.0], [1.0, 1.0, 3.0, 3.0]])
        >>> b = torch.tensor([[1.0, 1.0, 2.0, 2.0]])
        >>> [[round(float(v), 4) for v in row] for row in box_iou(a, b)]
        [[0.25], [0.25]]
    """
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    diff = rb - lt
    # jnp.clip(diff, 0, None), written out so the CUDA kernel can repeat it
    # exactly: NaN passes through, every negative becomes 0
    wh = torch.where(diff < 0, torch.zeros_like(diff), diff)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
