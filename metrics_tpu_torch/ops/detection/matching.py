"""COCO greedy detection-to-groundtruth matching for one image
(counterpart of ``metrics_tpu/ops/detection/matching.py``).

The JAX package runs ``vmap(vmap(vmap(scan)))``: one score-ordered scan over
the detections for every (class, area range, IoU threshold). Here the scan
is a Python loop over the D detections, each step one set of tensor
operations on (K, A, T, G): the three vmapped axes become tensor axes.

``MeanAveragePrecision`` does not call this: its routes hand whole chunks of
images to the merged-class matcher kernel
(:func:`~metrics_tpu_torch.ops.kernels.iou_matching.greedy_match`), which
gives the same matches for the classes a detection belongs to.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

__all__ = ["match_image"]


def match_image(
    ious: Tensor,  # (D, G) full-image IoU matrix, dets in score-desc order
    det_class_valid: Tensor,  # (K, D) det belongs to class k and within per-class max_det
    gt_class_valid: Tensor,  # (K, G)
    gt_ignore_area: Tensor,  # (A, G) area-ignored flags per area range
    thresholds: Tensor,  # (T,)
) -> Tuple[Tensor, Tensor]:
    """All (class, area, threshold) greedy matchings for one image.

    For each detection in order, the candidates are the unmatched,
    non-ignored ground truths of its class; the first of the largest IoU
    wins if it exceeds the threshold. Returns ``det_matches (K, A, T, D)``
    and ``gt_matches (K, A, T, G)``, bool.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.detection.matching import match_image
        >>> ious = torch.tensor([[0.9, 0.2], [0.8, 0.6]])
        >>> dets, gts = match_image(ious, torch.ones(1, 2, dtype=torch.bool), torch.ones(1, 2, dtype=torch.bool),
        ...                         torch.zeros(1, 2, dtype=torch.bool), torch.tensor([0.5, 0.7]))
        >>> dets[0, 0].tolist(), gts[0, 0].tolist()
        ([[True, True], [True, False]], [[True, True], [True, False]])
    """
    d, g = ious.shape
    k, a, t = det_class_valid.shape[0], gt_ignore_area.shape[0], thresholds.shape[0]
    device = ious.device
    det_matches = torch.zeros((k, a, t, d), dtype=torch.bool, device=device)
    gt_matches = torch.zeros((k, a, t, g), dtype=torch.bool, device=device)
    if g == 0:
        return det_matches, gt_matches
    gt_valid = gt_class_valid[:, None, :]  # (K, 1, G)
    gt_ignore = gt_ignore_area[None, :, :] & gt_valid  # (K, A, G), as the JAX package passes it
    eligible = (~gt_ignore & gt_valid)[:, :, None, :]  # (K, A, 1, G)
    gidx = torch.arange(g, device=device)
    for step in range(d):
        candidates = ~gt_matches & eligible
        gt_ious = ious[step] * candidates  # float32 times bool, as the JAX scan
        m = torch.argmax(gt_ious, dim=-1)  # first index of the maximum
        ok = (torch.amax(gt_ious, dim=-1) > thresholds) & det_class_valid[:, step, None, None]
        gt_matches = gt_matches | ((gidx == m[..., None]) & ok[..., None])
        det_matches[..., step] = ok
    return det_matches, gt_matches
