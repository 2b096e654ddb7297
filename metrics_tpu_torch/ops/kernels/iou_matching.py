"""Pairwise IoU and greedy COCO matching over padded detection buffers.

Counterpart of ``metrics_tpu/ops/kernels/iou_matching.py``. One call of
:func:`evaluate_matches` evaluates a padded batch of images: the per-image
score sort, box areas, area-range ignores, per-class rank caps, the pairwise
IoU matrix and one merged-class greedy matcher for all classes at once.

Its two hot steps are hand-written CUDA kernels, each with a plain PyTorch
version beside it:

- :func:`pairwise_iou` launches ``csrc/pairwise_iou.cu`` (the TPU kernel
  ``_iou_kernel``, ``iou_matching.py:41``, with ``_image_eval``'s zeroing of
  invalid pairs folded in); :func:`pairwise_iou_plain` is ``box_iou``
  batched, then ``torch.where`` over the valid pairs.
- :func:`greedy_match` launches ``csrc/greedy_match.cu`` (the ``lax.scan`` of
  ``_merged_greedy_match``, ``iou_matching.py:83``); :func:`greedy_match_plain`
  is a Python loop over the detections.

For CUDA tensors each wrapper launches its kernel or raises; it never falls
back. Only for CPU tensors, or with ``plain=True`` (a check hook), does it run
the plain version. Both versions give the same bits.

Unlike the JAX function, :func:`evaluate_matches` returns the merged matches
``(B, A, T, D)`` and not their class broadcast ``(B, K, A, T, D)``: a
detection matches only within its own class, so the per-class result is
``merged[:, None] & det_class_valid[:, :, None, None, :]``, and the caller
selects a class's detections from ``merged`` directly.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.detection.boxes import box_area, box_iou
from metrics_tpu_torch.ops.kernels import KERNELS, check_kernel_inputs, current_stream

__all__ = ["evaluate_matches", "greedy_match", "greedy_match_plain", "pairwise_iou", "pairwise_iou_plain"]

IOU_KERNEL = KERNELS["pairwise_iou"]
MATCH_KERNEL = KERNELS["greedy_match"]

_MAX_GRID_YZ = 65535


def _u8(x: Tensor) -> Tensor:
    return x.view(torch.uint8)


# --------------------------------------------------------------------------- #
# pairwise IoU (kernel B2)
# --------------------------------------------------------------------------- #
def _valid_pairs(det_counts: Tensor, gt_counts: Tensor, d: int, g: int) -> Tensor:
    """(B, D, G) bool: d < det_counts[b] and g < gt_counts[b]."""
    det_ok = torch.arange(d, device=det_counts.device)[None, :] < det_counts[:, None]
    gt_ok = torch.arange(g, device=gt_counts.device)[None, :] < gt_counts[:, None]
    return det_ok[:, :, None] & gt_ok[:, None, :]


def pairwise_iou_plain(det_boxes: Tensor, gt_boxes: Tensor, det_counts: Optional[Tensor] = None,
                       gt_counts: Optional[Tensor] = None) -> Tensor:
    """The plain version: ``box_iou`` per image, (B, D, 4) x (B, G, 4) -> (B, D, G),
    then ``torch.where(valid, iou, 0.0)`` where counts are given."""
    ious = box_iou(det_boxes, gt_boxes)
    if det_counts is None:
        return ious
    valid = _valid_pairs(det_counts, gt_counts, ious.shape[1], ious.shape[2])
    return torch.where(valid, ious, torch.zeros((), dtype=ious.dtype, device=ious.device))


def pairwise_iou(det_boxes: Tensor, gt_boxes: Tensor, det_counts: Optional[Tensor] = None,
                 gt_counts: Optional[Tensor] = None, *, plain: bool = False) -> Tensor:
    """Batched pairwise IoU of xyxy boxes: (B, D, 4) x (B, G, 4) -> (B, D, G)
    float32, in ``box_iou``'s operations and order, 0 where the union is not
    positive. With the (B,) counts, a pair is valid where ``d < det_counts[b]``
    and ``g < gt_counts[b]``, and every other pair is +0.0 whatever its boxes
    (``_image_eval``'s zeroing). The counts come both or not at all; without
    them every pair is valid.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream or raise. ``plain=True`` runs the plain version on any
    device, so that a check can hold the kernel against it.
    """
    if (
        det_boxes.ndim != 3 or gt_boxes.ndim != 3 or det_boxes.shape[-1] != 4 or gt_boxes.shape[-1] != 4
        or det_boxes.shape[0] != gt_boxes.shape[0]
    ):
        raise ValueError(
            f"pairwise_iou takes (B, D, 4) and (B, G, 4) boxes, got {tuple(det_boxes.shape)} and {tuple(gt_boxes.shape)}"
        )
    b = det_boxes.shape[0]
    for name, counts in (("det_counts", det_counts), ("gt_counts", gt_counts)):
        if counts is not None and counts.shape != (b,):
            raise ValueError(f"pairwise_iou takes (B,) {name}, got {tuple(counts.shape)} for B={b}")
    if (det_counts is None) != (gt_counts is None):
        raise ValueError("pairwise_iou takes det_counts and gt_counts together, or neither")
    if plain or det_boxes.device.type == "cpu":
        return pairwise_iou_plain(det_boxes, gt_boxes, det_counts, gt_counts)
    if det_boxes.device.type != "cuda":
        raise ValueError(f"pairwise_iou runs on CPU or CUDA tensors, got {det_boxes.device}")
    counts = {} if det_counts is None else {
        "det_counts": (det_counts, torch.int32), "gt_counts": (gt_counts, torch.int32)}
    check_kernel_inputs(
        "pairwise_iou", det_boxes.device, det_boxes=(det_boxes, torch.float32), gt_boxes=(gt_boxes, torch.float32),
        **counts,
    )
    d, g = det_boxes.shape[1], gt_boxes.shape[1]
    out = torch.empty((b, d, g), dtype=torch.float32, device=det_boxes.device)  # the kernel writes every element
    if out.numel() == 0:
        return out
    if max(b, d, g) >= 2**31:
        raise ValueError(f"pairwise_iou kernel: shape {(b, d, g)} exceeds its int32 indices")
    lib = IOU_KERNEL.lib()
    args = (
        det_boxes.data_ptr(), gt_boxes.data_ptr(), 0 if det_counts is None else det_counts.data_ptr(),
        0 if gt_counts is None else gt_counts.data_ptr(), out.data_ptr(), b, d, g, current_stream(det_boxes),
    )
    if det_boxes.device.index == torch.cuda.current_device():
        err = lib.pairwise_iou_launch(*args)
    else:
        with torch.cuda.device(det_boxes.device):
            err = lib.pairwise_iou_launch(*args)
    if err != 0:
        raise RuntimeError(f"pairwise_iou kernel launch failed with CUDA error {err}")
    IOU_KERNEL.launches += 1
    return out


# --------------------------------------------------------------------------- #
# greedy matcher
# --------------------------------------------------------------------------- #
def greedy_match_plain(
    ious: Tensor, det_ok: Tensor, det_labels: Tensor, gt_labels: Tensor, gt_ok: Tensor, gt_ignore: Tensor,
    thresholds: Tensor,
) -> Tensor:
    """The plain version: ``_merged_greedy_match`` for every image, as a
    Python loop over the D detections on (B, A, T, G) tensors."""
    b, d, g = ious.shape
    a, t = gt_ignore.shape[1], thresholds.shape[0]
    eligible = (gt_ok[:, None, :] & ~gt_ignore)[:, :, None, :]  # (B, A, 1, G)
    gidx = torch.arange(g, device=ious.device)
    matched = torch.zeros((b, a, t, g), dtype=torch.bool, device=ious.device)
    out = torch.zeros((b, a, t, d), dtype=torch.bool, device=ious.device)
    for step in range(d):
        same_label = (gt_labels == det_labels[:, step, None])[:, None, None, :]  # (B, 1, 1, G)
        candidates = same_label & eligible & ~matched
        gt_ious = ious[:, step, None, None, :] * candidates  # float32 times bool, as the JAX scan
        m = torch.argmax(gt_ious, dim=-1)  # first index of the maximum
        ok = (torch.amax(gt_ious, dim=-1) > thresholds) & det_ok[:, step, None, None]
        matched = matched | ((gidx == m[..., None]) & ok[..., None])
        out[..., step] = ok
    return out


def greedy_match(
    ious: Tensor,  # (B, D, G) float32, score-descending detections, 0 outside valid pairs
    det_ok: Tensor,  # (B, D) bool: valid for its own class, after the max-det cap
    det_labels: Tensor,  # (B, D) int32, score-descending order
    gt_labels: Tensor,  # (B, G) int32
    gt_ok: Tensor,  # (B, G) bool: valid for some evaluated class
    gt_ignore: Tensor,  # (B, A, G) bool: outside the area range
    thresholds: Tensor,  # (T,) float32
    *,
    plain: bool = False,
) -> Tensor:
    """Greedy COCO matching for every image, area range and IoU threshold in
    one pass over the detections: (B, A, T, D) bool, equal to
    ``_merged_greedy_match`` image by image.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream or raise. ``plain=True`` runs the plain version anywhere.
    """
    if ious.ndim != 3:
        raise ValueError(f"greedy_match takes (B, D, G) IoUs, got {tuple(ious.shape)}")
    b, d, g = ious.shape
    if (
        det_ok.shape != (b, d) or det_labels.shape != (b, d) or gt_labels.shape != (b, g) or gt_ok.shape != (b, g)
        or gt_ignore.ndim != 3 or gt_ignore.shape[0] != b or gt_ignore.shape[2] != g or thresholds.ndim != 1
    ):
        raise ValueError("greedy_match: inputs do not agree with the (B, D, G) IoU shape")
    if g == 0:
        raise ValueError("greedy_match needs at least one ground-truth column (pad with an invalid one)")
    if plain or ious.device.type == "cpu":
        return greedy_match_plain(ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thresholds)
    if ious.device.type != "cuda":
        raise ValueError(f"greedy_match runs on CPU or CUDA tensors, got {ious.device}")
    check_kernel_inputs(
        "greedy_match", ious.device,
        ious=(ious, torch.float32), det_ok=(det_ok, torch.bool), det_labels=(det_labels, torch.int32),
        gt_labels=(gt_labels, torch.int32), gt_ok=(gt_ok, torch.bool), gt_ignore=(gt_ignore, torch.bool),
        thresholds=(thresholds, torch.float32),
    )
    a, t = gt_ignore.shape[1], thresholds.shape[0]
    out = torch.empty((b, a, t, d), dtype=torch.bool, device=ious.device)  # the kernel writes every element
    if out.numel() == 0:
        return out
    lib = MATCH_KERNEL.lib()
    if g > lib.greedy_match_max_g():
        raise ValueError(f"greedy_match kernel takes at most {lib.greedy_match_max_g()} ground-truth columns, got {g}")
    if b * a >= 2**31 or t > _MAX_GRID_YZ:
        raise ValueError(f"greedy_match kernel: shape {(b, a, t, d, g)} exceeds its grid")
    with torch.cuda.device(ious.device):
        err = lib.greedy_match_launch(
            ious.data_ptr(), _u8(det_ok).data_ptr(), det_labels.data_ptr(), gt_labels.data_ptr(),
            _u8(gt_ok).data_ptr(), _u8(gt_ignore).data_ptr(), thresholds.data_ptr(), _u8(out).data_ptr(),
            b, a, t, d, g, current_stream(ious),
        )
    if err != 0:
        raise RuntimeError(f"greedy_match kernel launch failed with CUDA error {err}")
    MATCH_KERNEL.launches += 1
    return out


# --------------------------------------------------------------------------- #
# the batched image evaluation
# --------------------------------------------------------------------------- #
def match_inputs(
    det_boxes: Tensor, det_scores: Tensor, det_labels: Tensor, det_counts: Tensor,
    gt_boxes: Tensor, gt_labels: Tensor, gt_counts: Tensor,
    class_ids: Tensor, class_mask: Tensor, area_ranges: Tensor, max_det: int,
) -> Dict[str, Tensor]:
    """Everything ``_image_eval`` computes before the IoU and the matcher,
    written out over the batch axis: the stable score sort with pads last,
    sorted boxes, scores and labels, areas, area-ignore flags and the
    per-class rank cap."""
    b, d = det_scores.shape
    g = gt_labels.shape[1]
    device = det_scores.device
    det_valid = torch.arange(d, device=device)[None, :] < det_counts[:, None]  # (B, D)
    gt_valid = torch.arange(g, device=device)[None, :] < gt_counts[:, None]  # (B, G)

    # score-descending stable sort with pads forced last; exactly the first
    # n_det slots are valid after it
    order = torch.argsort(torch.where(det_valid, -det_scores, float("inf")), dim=1, stable=True)
    scores_sorted = torch.gather(det_scores, 1, order)
    labels_sorted = torch.gather(det_labels, 1, order)
    boxes_sorted = torch.gather(det_boxes, 1, order[..., None].expand(b, d, 4))

    lo, hi = area_ranges[None, :, 0:1], area_ranges[None, :, 1:2]  # (1, A, 1)
    det_areas = box_area(boxes_sorted)[:, None, :]  # (B, 1, D)
    gt_areas = box_area(gt_boxes)[:, None, :]
    det_area_ignore = (det_areas < lo) | (det_areas > hi)  # (B, A, D)
    gt_area_ignore = (gt_areas < lo) | (gt_areas > hi)  # (B, A, G)

    classes = class_ids[None, :, None]
    det_class = (labels_sorted[:, None, :] == classes) & det_valid[:, None, :] & class_mask[None, :, None]
    rank_in_class = torch.cumsum(det_class, dim=2, dtype=torch.int32)
    det_class_valid = det_class & (rank_in_class <= max_det)  # (B, K, D)
    gt_class_valid = (gt_labels[:, None, :] == classes) & gt_valid[:, None, :] & class_mask[None, :, None]
    return {
        "boxes_sorted": boxes_sorted,
        "scores_sorted": scores_sorted,
        "labels_sorted": labels_sorted,
        "det_class_valid": det_class_valid,
        "det_area_ignore": det_area_ignore,
        "gt_class_valid": gt_class_valid,
        "gt_area_ignore": gt_area_ignore,
    }


def evaluate_matches(
    det_boxes: Tensor,  # (B, D, 4) float32 xyxy
    det_scores: Tensor,  # (B, D) float32
    det_labels: Tensor,  # (B, D) int32
    det_counts: Tensor,  # (B,) int32
    gt_boxes: Tensor,  # (B, G, 4) float32
    gt_labels: Tensor,  # (B, G) int32
    gt_counts: Tensor,  # (B,) int32
    class_ids: Tensor,  # (K,) int32 (padded; padding rows masked off)
    class_mask: Tensor,  # (K,) bool
    area_ranges: Tensor,  # (A, 2) float32
    thresholds: Tensor,  # (T,) float32
    max_det: int,
    *,
    plain: bool = False,
) -> Dict[str, Tensor]:
    """Evaluate a padded batch of images. All inputs lie on one device.

    Returns batched tensors (leading axis B): ``merged (B, A, T, D)``,
    ``scores_sorted (B, D)``, ``det_class_valid (B, K, D)``,
    ``det_area_ignore (B, A, D)``, ``gt_class_valid (B, K, G)`` and
    ``gt_area_ignore (B, A, G)``. Pad rows and columns are all-False or
    garbage and are sliced to the true per-image counts by the caller.
    ``plain=True`` runs both kernels' plain versions.
    """
    prep = match_inputs(
        det_boxes, det_scores, det_labels, det_counts, gt_boxes, gt_labels, gt_counts,
        class_ids, class_mask, area_ranges, max_det,
    )
    # pads sort last, so a pair is valid where d < det_counts and g < gt_counts;
    # the kernel writes every other pair as 0
    ious = pairwise_iou(prep["boxes_sorted"].contiguous(), gt_boxes.contiguous(), det_counts.contiguous(),
                        gt_counts.contiguous(), plain=plain)
    merged = greedy_match(
        ious,
        prep["det_class_valid"].any(dim=1),
        prep["labels_sorted"].contiguous(),
        gt_labels.contiguous(),
        prep["gt_class_valid"].any(dim=1),
        prep["gt_area_ignore"].contiguous(),
        thresholds.contiguous(),
        plain=plain,
    )
    return {
        "merged": merged,
        "scores_sorted": prep["scores_sorted"],
        "det_class_valid": prep["det_class_valid"],
        "det_area_ignore": prep["det_area_ignore"],
        "gt_class_valid": prep["gt_class_valid"],
        "gt_area_ignore": prep["gt_area_ignore"],
    }
