"""Box and mask operations (counterpart of ``metrics_tpu/ops/detection/boxes.py``).

The same operations in the same order as the JAX package, each an IEEE
float32 op, so results agree bit for bit with its eager ``box_iou``.
``mask_iou`` counts pixels with one float32 matrix product: every partial sum
is an integer below 2**24 for masks of fewer than 2**24 pixels (307,200 at
480 x 640), so it is exact in any summation order, TF32 included (0 and 1
are exact there and the sums are float32), and ``inter / union`` is the JAX
package's value bit for bit.
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


def mask_iou(masks1: Tensor, masks2: Tensor) -> Tensor:
    """Pairwise IoU of dense binary masks: [N, H, W] x [M, H, W] -> [N, M]
    float32, 0 where the union is empty: intersections as one matrix
    product of the flattened masks, unions from their areas.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.boxes import mask_iou
        >>> m1 = torch.zeros((1, 4, 4)); m1[0, :2, :2] = 1
        >>> m2 = torch.zeros((1, 4, 4)); m2[0, :4, :2] = 1
        >>> [[round(float(v), 4) for v in row] for row in mask_iou(m1, m2)]
        [[0.5]]
    """
    m1 = masks1.flatten(1).to(torch.float32)
    m2 = masks2.flatten(1).to(torch.float32)
    inter = m1 @ m2.T
    area1 = m1.sum(dim=-1)
    area2 = m2.sum(dim=-1)
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def mask_area(masks: Tensor) -> Tensor:
    """[N, H, W] binary masks -> [N] pixel areas, float32 (bool and integer
    masks count in int32, as ``jnp.sum`` does).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.boxes import mask_area
        >>> m = torch.zeros((1, 4, 4)); m[0, :4, :2] = 1
        >>> mask_area(m).tolist()
        [8.0]
    """
    flat = masks.flatten(1)
    return flat.sum(dim=-1, dtype=None if flat.is_floating_point() else torch.int32).to(torch.float32)
