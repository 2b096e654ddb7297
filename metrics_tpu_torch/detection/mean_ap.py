"""MeanAveragePrecision (COCO mAP / mAR), counterpart of
``metrics_tpu/detection/mean_ap.py``. Three routes:

- ``iou_type="bbox"`` with ``device_state=True`` (the default for boxes): the
  per-image detections and ground truths live in padded ``CatBuffer`` states
  on the metric's device, and ``compute`` feeds them to
  :func:`~metrics_tpu_torch.ops.kernels.iou_matching.evaluate_matches` in
  chunks of 256 images.
- ``device_state=False`` with boxes, the host-list route: five list states
  of per-image tensors on the metric's device, every detection kept. At
  ``compute`` the images with a detection or a ground truth are grouped by
  their ``(pd, pg)`` bucket (powers of two, at least 8); each bucket goes in
  chunks of at most 256 images, padded to a power of two of at least 8,
  through ``evaluate_matches``.
- ``iou_type="segm"`` (always host-listed): dense ``torch.bool`` masks per
  image on the metric's device; RLE input is decoded on the host at update.
  At ``compute`` each image's mask IoUs (``mask_iou``, one matrix product)
  and pixel areas are padded into its bucket's chunk, which goes through
  :func:`~metrics_tpu_torch.ops.kernels.iou_matching.evaluate_given_ious`.

Every route's hot steps are CUDA kernels: the pairwise IoU (boxes) and the
greedy matcher, one launch of each per chunk. The JAX package's segm route
calls ``match_image`` per image; here the chunk's images share one launch of
the merged-class matcher, which gives the same matches (see
``match_given_ious``).

What differs from the JAX package, and why:

- ``update`` pads on the device. The per-image counts come from the inputs'
  shapes, which the host knows; the scatter index is built on the host and
  sent in one copy from pinned memory, so ``update`` never waits for the card.
  The dense append is what the compiled update engine captures, as the JAX
  package compiles it: from the second batch of a shape it is one graph
  replay into the buffers (``_engine_accepts``).
- ``compute`` fetches the merged matches ``(A, T, D)`` per image, not their
  class broadcast ``(K, A, T, D)``; ``_calculate`` selects a class's
  detections from them, which gives the same ``(T, n)`` slices bit for bit.
  Each chunk is sliced to its true sizes on the device and comes to the host
  in one copy.
- The list routes sort and flag the detections on the device, in the
  chunk, where the JAX package does it per image on the host (the same
  stable sort and the same float32 areas). An image without detections or
  without ground truths goes through the kernels too, which take zero
  counts; the JAX package evaluates it on the host.
- ``_calculate`` is the JAX package's host numpy code, unchanged, in float64.
- There is no ``use_pallas``: CUDA state always runs the kernels. The check
  hook ``_plain_kernels`` runs their plain versions instead.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.detection.boxes import box_convert, mask_area, mask_iou
from metrics_tpu_torch.ops.detection.rle import is_rle, masks_from_rle_list
from metrics_tpu_torch.ops.kernels.iou_matching import evaluate_given_ious, evaluate_matches
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.prints import rank_zero_warn

_BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
_CHUNK_IMAGES = 256
# the list routes' states: per-image geometry (boxes or masks), scores and labels
_LIST_STATES = ("detections", "detection_scores", "detection_labels", "groundtruths", "groundtruth_labels")


def _input_validator(preds: Sequence[Dict], targets: Sequence[Dict], iou_type: str = "bbox") -> None:
    """Validate the COCO-style list-of-dicts inputs."""
    item_val_name = "boxes" if iou_type == "bbox" else "masks"
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")
    for k in (item_val_name, "scores", "labels"):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in (item_val_name, "labels"):
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")
    for item in preds:
        if len(item[item_val_name]) != len(item["scores"]) or len(item[item_val_name]) != len(item["labels"]):
            raise ValueError(
                f"Input {item_val_name}, scores and labels of sample must have a length equal to each other"
            )
    for item in targets:
        if len(item[item_val_name]) != len(item["labels"]):
            raise ValueError(f"Input {item_val_name} and labels of sample must have a length equal to each other")


def _next_bucket(n: int, minimum: int = 8) -> int:
    """The smallest power of two times ``minimum`` that holds ``n``."""
    size = minimum
    while size < n:
        size *= 2
    return size


def _pack_bytes(parts: List[Tensor]) -> Tensor:
    """The parts' bytes end to end, so one copy brings them all to the host."""
    return torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])


def _unpack_bytes(raw: np.ndarray, like: List[Tensor]) -> List[np.ndarray]:
    out, start = [], 0
    for part in like:
        dtype = torch.empty((), dtype=part.dtype).numpy().dtype
        stop = start + part.numel() * dtype.itemsize
        out.append(raw[start:stop].view(dtype).reshape(tuple(part.shape)))
        start = stop
    return out


def _fetch_chunk(out: Dict[str, Tensor], idx: List[int], n_det: List[int], n_gt: List[int], k: int,
                 evals: List[Optional[Dict[str, np.ndarray]]]) -> None:
    """One chunk's evaluation sliced to its true sizes on the device and
    fetched in one copy; image ``idx[b]``'s entry of ``evals`` becomes a dict
    of numpy views cut to its counts (left None for an empty image)."""
    nb, n_max, g_max = len(idx), max(n_det), max(n_gt)
    parts = [  # the float32 part first, so its bytes stay aligned
        out["scores_sorted"][:nb, :n_max],
        out["merged"][:nb, :, :, :n_max],
        out["det_class_valid"][:nb, :k, :n_max],
        out["det_area_ignore"][:nb, :, :n_max],
        out["gt_class_valid"][:nb, :k, :g_max],
        out["gt_area_ignore"][:nb, :, :g_max],
    ]
    scores, merged, dcv, dai, gcv, gai = _unpack_bytes(_pack_bytes(parts).cpu().numpy(), parts)
    for b, i in enumerate(idx):
        n, g = n_det[b], n_gt[b]
        if n == 0 and g == 0:
            continue
        evals[i] = {
            "merged": merged[b][:, :, :n],
            "scores_sorted": scores[b][:n],
            "det_class_valid": dcv[b][:, :n],
            "det_area_ignore": dai[b][:, :n],
            "gt_class_valid": gcv[b][:, :g],
            "gt_area_ignore": gai[b][:, :g],
        }


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR over 10 IoU x 101 recall thresholds, 4 area ranges and 3
    max-detection thresholds, with per-class values when ``class_metrics``.

    Matching follows the JAX package (and the reference it ports), which
    excludes area-ignored ground truths from matching.

    State with ``device_state=True`` (the default for ``iou_type="bbox"``):
    seven ``CatBuffer`` states of ``buffer_capacity`` images (default 1024,
    growing by doubling), with ``detections_capacity`` and
    ``groundtruths_capacity`` (rounded up to powers of two, default 128) rows
    per image. An image with more detections keeps its top-scoring ones, in
    their original order, with a warning; extra ground truths are truncated.
    With ``device_state=False``, and always for ``iou_type="segm"`` (dense
    masks, or COCO RLE dicts decoded on the host), five lists of per-image
    tensors keep every detection; the update is not captured.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [dict(
        ...     boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...     scores=torch.tensor([0.536]),
        ...     labels=torch.tensor([0]),
        ... )]
        >>> target = [dict(
        ...     boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...     labels=torch.tensor([0]),
        ... )]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result["map"]), 2), round(float(result["map_50"]), 2)
        (0.6, 1.0)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    # check hook: True makes compute() run the plain PyTorch versions of the
    # IoU and matcher kernels; it lets a check hold one against the other
    _plain_kernels: bool = False

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        device_state: Optional[bool] = None,
        detections_capacity: int = 128,
        groundtruths_capacity: int = 128,
        **kwargs: Any,
    ) -> None:
        allowed_iou_types = ("segm", "bbox")
        if iou_type not in allowed_iou_types:
            raise ValueError(f"Expected argument `iou_type` to be one of {allowed_iou_types} but got {iou_type}")
        if device_state is None:
            device_state = iou_type == "bbox"
        elif device_state and iou_type != "bbox":
            raise ValueError("`device_state=True` requires `iou_type='bbox'` (masks stay host-listed)")
        self._device_state = bool(device_state)
        if self._device_state:
            # the JAX package's defaults for device state: compute() slices
            # the buffers to per-image counts on the host, and ragged image
            # batches reuse log2(N) captured update steps
            kwargs.setdefault("compiled_compute", False)
            kwargs.setdefault("batch_buckets", True)
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_type = iou_type

        self.iou_thresholds = iou_thresholds or np.arange(0.5, 1.0, 0.05).round(2).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        self.bbox_area_ranges = _BBOX_AREA_RANGES

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        if not self._device_state:
            for name in _LIST_STATES:
                self.add_state(name, default=[], dist_reduce_fx=None)
            return
        for name, cap in (("detections_capacity", detections_capacity), ("groundtruths_capacity", groundtruths_capacity)):
            if not isinstance(cap, int) or cap <= 0:
                raise ValueError(f"Expected argument `{name}` to be a positive int but got {cap}")
        self._det_cap = _next_bucket(detections_capacity, minimum=1)
        self._gt_cap = _next_bucket(groundtruths_capacity, minimum=1)
        images = self.buffer_capacity or 1024
        for name, item, dtype in (
            ("det_boxes", (self._det_cap, 4), torch.float32),
            ("det_scores", (self._det_cap,), torch.float32),
            ("det_labels", (self._det_cap,), torch.int32),
            ("det_counts", (), torch.int32),
            ("gt_boxes", (self._gt_cap, 4), torch.float32),
            ("gt_labels", (self._gt_cap,), torch.int32),
            ("gt_counts", (), torch.int32),
        ):
            self.add_state(name, CatBuffer.empty(images, item, dtype), dist_reduce_fx="cat")

    @property
    def device_state(self) -> bool:
        """Whether state lives in padded device buffers (the bbox default)."""
        return self._device_state

    # ------------------------------------------------------------------ #
    # update
    # ------------------------------------------------------------------ #
    def _engine_accepts(self, args: Tuple, kwargs: Dict) -> bool:
        """The compiled update's per-call gate, the JAX package's: only the
        dense padded dict form (two dicts with ``boxes`` and ``count``, no
        keywords) is captured. COCO list-of-dicts inputs are declined without
        tripping the engine's permanent fallback; :meth:`update` pads them
        eagerly and hands the dense form back to the engine."""
        if not self._device_state or kwargs or len(args) != 2:
            return False
        return all(isinstance(a, dict) and "boxes" in a and "count" in a for a in args)

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:  # type: ignore[override]
        if not self._device_state:
            self._append_lists(preds, target)
            return
        if isinstance(preds, dict) and isinstance(target, dict):
            self._append_dense(preds, target)  # the dense padded form pad_inputs produces
            return
        _input_validator(preds, target, iou_type=self.iou_type)
        dense_preds, dense_target = self.pad_inputs(preds, target)
        engine = self._maybe_engine()
        if engine is None or not engine.dispatch((dense_preds, dense_target), {}):
            self._append_dense(dense_preds, dense_target)

    def _get_safe_item_values(self, item: Dict[str, Any]) -> Tensor:
        """One image's boxes (converted to xyxy) or masks, on the metric's
        device. Masks are ``torch.bool`` (N, H, W); RLE dicts are decoded on
        the host."""
        if self.iou_type == "bbox":
            return box_convert(self._tensor(item["boxes"], torch.float32, (-1, 4)), in_fmt=self.box_format,
                               out_fmt="xyxy")
        raw = item["masks"]
        if isinstance(raw, (list, tuple)) and raw and is_rle(raw[0]):
            masks = masks_from_rle_list(raw, device=self.device)
        else:
            masks = torch.as_tensor(raw, device=self.device).to(torch.bool)
        if masks.numel() == 0 and masks.ndim != 3:
            return masks.reshape(0, 0, 0)
        return masks

    def _append_lists(self, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> None:
        """The list routes' update: each image's tensors appended to the five
        lists (new lists, so a snapshot of the old ones keeps them)."""
        _input_validator(preds, target, iou_type=self.iou_type)
        self.detections = self.detections + [self._get_safe_item_values(p) for p in preds]
        self.detection_labels = self.detection_labels + [self._tensor(p["labels"], torch.int32, (-1,)) for p in preds]
        self.detection_scores = self.detection_scores + [self._tensor(p["scores"], torch.float32, (-1,)) for p in preds]
        self.groundtruths = self.groundtruths + [self._get_safe_item_values(t) for t in target]
        self.groundtruth_labels = self.groundtruth_labels + [self._tensor(t["labels"], torch.int32, (-1,)) for t in target]

    def _tensor(self, value: Any, dtype: torch.dtype, shape: Tuple[int, ...]) -> Tensor:
        return torch.as_tensor(value, device=self.device).reshape(shape).to(dtype)

    def _index_tensor(self, host: np.ndarray) -> Tensor:
        """An int64 host array on the metric's device without a blocking copy:
        from pinned memory, asynchronously, on CUDA."""
        if self.device.type != "cuda":
            return torch.from_numpy(host).to(self.device)
        pinned = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
        pinned.numpy()[...] = host
        return pinned.to(self.device, non_blocking=True)

    def pad_inputs(
        self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Convert COCO list-of-dicts inputs to the dense padded dict form
        (``boxes (B, cap, 4)`` / ``scores`` / ``labels`` / ``count``) on the
        metric's device. Pads are 0 for boxes and scores and -1 for labels.
        Detections beyond ``detections_capacity`` keep the top-scoring
        ``cap`` (in original order); ground truths truncate.

        The copy into the padded tensors is one ``index_copy_`` per tensor;
        every count comes from a shape, so nothing is read from the device.
        """
        n_img = len(preds)
        dcap, gcap = self._det_cap, self._gt_cap

        def cat(items: Sequence[Dict], key: str, dtype: torch.dtype, item_shape: Tuple[int, ...]) -> Tensor:
            parts = [self._tensor(it[key], dtype, (-1, *item_shape)) for it in items]
            return torch.cat(parts) if parts else torch.zeros((0, *item_shape), dtype=dtype, device=self.device)

        det_n = [len(p["labels"]) for p in preds]
        gt_n = [len(t["labels"]) for t in target]
        det_keep = [min(n, dcap) for n in det_n]
        gt_keep = [min(n, gcap) for n in gt_n]
        det_boxes = box_convert(cat(preds, "boxes", torch.float32, (4,)), in_fmt=self.box_format, out_fmt="xyxy")
        det_scores = cat(preds, "scores", torch.float32, ())
        det_labels = cat(preds, "labels", torch.int32, ())
        gt_boxes = box_convert(cat(target, "boxes", torch.float32, (4,)), in_fmt=self.box_format, out_fmt="xyxy")
        gt_labels = cat(target, "labels", torch.int32, ())
        if det_labels.shape[0] != sum(det_n) or gt_labels.shape[0] != sum(gt_n):
            raise ValueError("Expected `labels` of every sample to be one-dimensional")

        # rows kept from the concatenated inputs: all of them, unless an image
        # overflows its capacity
        det_src = gt_src = None
        if det_keep != det_n:
            pieces, start = [], 0
            for n in det_n:
                if n > dcap:
                    rank_zero_warn(
                        f"MeanAveragePrecision: an image carries {n} detections, above "
                        f"`detections_capacity={dcap}`; keeping the top {dcap} by score. "
                        "Raise `detections_capacity` for exact handling.",
                        UserWarning,
                    )
                    top = torch.argsort(-det_scores[start : start + n], stable=True)[:dcap]
                    pieces.append(torch.sort(top).values + start)
                else:
                    pieces.append(torch.arange(start, start + n, device=self.device))
                start += n
            det_src = torch.cat(pieces)
        if gt_keep != gt_n:
            pieces, start = [], 0
            for n in gt_n:
                if n > gcap:
                    rank_zero_warn(
                        f"MeanAveragePrecision: an image carries {n} groundtruths, above "
                        f"`groundtruths_capacity={gcap}`; truncating. Raise `groundtruths_capacity` "
                        "for exact handling.",
                        UserWarning,
                    )
                pieces.append(torch.arange(start, start + min(n, gcap), device=self.device))
                start += n
            gt_src = torch.cat(pieces)
        if det_src is not None:
            det_boxes, det_scores, det_labels = det_boxes[det_src], det_scores[det_src], det_labels[det_src]
        if gt_src is not None:
            gt_boxes, gt_labels = gt_boxes[gt_src], gt_labels[gt_src]

        # the destination rows and the counts, built on the host, sent in one copy
        def rows(keep: List[int], cap: int) -> np.ndarray:
            if not keep:
                return np.zeros(0, np.int64)
            return np.concatenate([i * cap + np.arange(n, dtype=np.int64) for i, n in enumerate(keep)])

        host = np.concatenate([rows(det_keep, dcap), rows(gt_keep, gcap), np.asarray(det_keep + gt_keep, np.int64)])
        index = self._index_tensor(host)
        nd, ng = sum(det_keep), sum(gt_keep)
        det_dst, gt_dst = index[:nd], index[nd : nd + ng]
        counts = index[nd + ng :].to(torch.int32)

        def scatter(values: Tensor, dst: Tensor, cap: int, fill: float) -> Tensor:
            out = torch.full((n_img * cap, *values.shape[1:]), fill, dtype=values.dtype, device=self.device)
            out.index_copy_(0, dst, values)
            return out.reshape(n_img, cap, *values.shape[1:])

        dense_preds = {
            "boxes": scatter(det_boxes, det_dst, dcap, 0),
            "scores": scatter(det_scores, det_dst, dcap, 0),
            "labels": scatter(det_labels, det_dst, dcap, -1),
            "count": counts[:n_img],
        }
        dense_target = {
            "boxes": scatter(gt_boxes, gt_dst, gcap, 0),
            "labels": scatter(gt_labels, gt_dst, gcap, -1),
            "count": counts[n_img:],
        }
        return dense_preds, dense_target

    def _append_dense(self, preds: Dict[str, Tensor], target: Dict[str, Tensor]) -> None:
        self.det_boxes.append(preds["boxes"])
        self.det_scores.append(preds["scores"])
        self.det_labels.append(preds["labels"])
        self.det_counts.append(preds["count"])
        self.gt_boxes.append(target["boxes"])
        self.gt_labels.append(target["labels"])
        self.gt_counts.append(target["count"])

    def _get_classes(self) -> List[int]:
        if not self._device_state:
            labels = self.detection_labels + self.groundtruth_labels
            return torch.unique(torch.cat(labels)).tolist() if labels else []
        labels = []
        for label_buf, count_buf in ((self.det_labels, self.det_counts), (self.gt_labels, self.gt_counts)):
            if len(count_buf) == 0:
                continue
            lab = label_buf.to_array()  # (N, cap)
            cnt = count_buf.to_array()  # (N,)
            labels.append(lab[torch.arange(lab.shape[1], device=lab.device)[None, :] < cnt[:, None]])
        if not labels:
            return []
        return torch.unique(torch.cat(labels)).tolist()

    # ------------------------------------------------------------------ #
    # device evaluation
    # ------------------------------------------------------------------ #
    def _consts(self, class_ids: List[int]) -> Tuple:
        """The padded class ids, class mask, area ranges, IoU thresholds and
        max-det cap that the evaluation takes, on the metric's device."""
        k = len(class_ids)
        k_pad = _next_bucket(max(k, 1), minimum=1)
        cid = torch.zeros(k_pad, dtype=torch.int32)
        cid[:k] = torch.tensor(class_ids, dtype=torch.int32)
        return (
            cid.to(self.device),
            (torch.arange(k_pad) < k).to(self.device),
            torch.tensor(list(self.bbox_area_ranges.values()), dtype=torch.float32, device=self.device),
            torch.tensor(self.iou_thresholds, dtype=torch.float32, device=self.device),
            self.max_detection_thresholds[-1],
        )

    def _evaluation_inputs(self, class_ids: List[int]) -> Tuple[List[Tensor], Tuple, np.ndarray, np.ndarray]:
        """What :func:`evaluate_matches` takes for all images: the seven
        buffers (trimmed to the power-of-two bucket of the largest true
        count; the pad columns are all invalid), then the padded class ids,
        class mask, area ranges, IoU thresholds and max-det cap; and the two
        count arrays on the host."""
        det_counts = self.det_counts.to_array()
        gt_counts = self.gt_counts.to_array()
        det_counts_host = det_counts.cpu().numpy()
        gt_counts_host = gt_counts.cpu().numpy()
        d_used = _next_bucket(max(int(det_counts_host.max(initial=0)), 1), minimum=1)
        g_used = _next_bucket(max(int(gt_counts_host.max(initial=0)), 1), minimum=1)
        arrays = [
            self.det_boxes.to_array()[:, :d_used], self.det_scores.to_array()[:, :d_used],
            self.det_labels.to_array()[:, :d_used], det_counts,
            self.gt_boxes.to_array()[:, :g_used], self.gt_labels.to_array()[:, :g_used], gt_counts,
        ]
        return arrays, self._consts(class_ids), det_counts_host, gt_counts_host

    def _evaluate_images(self, class_ids: List[int]) -> List[Optional[Dict[str, np.ndarray]]]:
        """The buffers feed :func:`evaluate_matches` in chunks of 256 images,
        padded to a power of two. Each chunk's outputs are sliced to its true
        sizes on the device and fetched in one copy; each image's entry is a
        dict of numpy views cut to its counts (None for an empty image)."""
        if not self._device_state:
            return self._evaluate_lists(class_ids)
        n_images = len(self.det_counts)
        evals: List[Optional[Dict[str, np.ndarray]]] = [None] * n_images
        if n_images == 0:
            return evals
        arrays, consts, det_counts, gt_counts = self._evaluation_inputs(class_ids)
        k = len(class_ids)

        for start in range(0, n_images, _CHUNK_IMAGES):
            stop = min(start + _CHUNK_IMAGES, n_images)
            nb = stop - start
            b_pad = _next_bucket(nb, minimum=1)

            def chunk(x: Tensor) -> Tensor:
                piece = x[start:stop]
                if b_pad == nb:
                    return piece
                return torch.cat([piece, torch.zeros((b_pad - nb, *x.shape[1:]), dtype=x.dtype, device=x.device)])

            out = evaluate_matches(*(chunk(x) for x in arrays), *consts, plain=self._plain_kernels)
            idx = list(range(start, stop))
            _fetch_chunk(out, idx, [int(det_counts[i]) for i in idx], [int(gt_counts[i]) for i in idx], k, evals)
        return evals

    # ------------------------------------------------------------------ #
    # the list routes
    # ------------------------------------------------------------------ #
    def _evaluate_lists(self, class_ids: List[int]) -> List[Optional[Dict[str, np.ndarray]]]:
        """The list routes' evaluation: every image with a detection or a
        ground truth joins its ``(pd, pg)`` bucket (a count of 0 takes the
        smallest, 8), each bucket goes through the kernels in chunks of at
        most 256 images (one launch of each per chunk); an image with
        neither stays None."""
        n_images = len(self.groundtruths)
        evals: List[Optional[Dict[str, np.ndarray]]] = [None] * n_images
        n_det = [int(x.shape[0]) for x in self.detection_labels]
        n_gt = [int(x.shape[0]) for x in self.groundtruth_labels]
        by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for i in range(n_images):
            if n_det[i] > 0 or n_gt[i] > 0:
                by_bucket.setdefault((_next_bucket(n_det[i]), _next_bucket(n_gt[i])), []).append(i)
        if not by_bucket:
            return evals
        consts = self._consts(class_ids)
        evaluate = self._evaluate_bbox_chunk if self.iou_type == "bbox" else self._evaluate_segm_chunk
        for (pd, pg), idxs in by_bucket.items():
            for start in range(0, len(idxs), _CHUNK_IMAGES):
                chunk = idxs[start : start + _CHUNK_IMAGES]
                out = evaluate(chunk, pd, pg, _next_bucket(len(chunk)), consts)
                _fetch_chunk(out, chunk, [n_det[i] for i in chunk], [n_gt[i] for i in chunk], len(class_ids), evals)
        return evals

    def _padded(self, items: List[Tensor], b_pad: int, width: int, fill: float) -> Tensor:
        """The chunk's per-image tensors (n_i, *item) padded into one
        (b_pad, width, *item) tensor: one ``cat`` and one ``index_copy_``,
        the destination rows built on the host from the shapes."""
        values = torch.cat(items)
        item = values.shape[1:]
        dst = np.concatenate([b * width + np.arange(x.shape[0], dtype=np.int64) for b, x in enumerate(items)])
        out = torch.full((b_pad * width, *item), fill, dtype=values.dtype, device=self.device)
        out.index_copy_(0, self._index_tensor(dst), values)
        return out.reshape(b_pad, width, *item)

    def _chunk_counts(self, chunk: List[int], b_pad: int) -> Tuple[Tensor, Tensor]:
        counts = np.zeros((2, b_pad), np.int64)
        counts[0, : len(chunk)] = [self.detection_labels[i].shape[0] for i in chunk]
        counts[1, : len(chunk)] = [self.groundtruth_labels[i].shape[0] for i in chunk]
        both = self._index_tensor(counts.reshape(-1)).to(torch.int32)
        return both[:b_pad], both[b_pad:]

    def _evaluate_bbox_chunk(self, chunk: List[int], pd: int, pg: int, b_pad: int, consts: Tuple) -> Dict[str, Tensor]:
        """One chunk of the host-list bbox route: B2 on its sorted boxes,
        then the matcher (``evaluate_matches``)."""
        det_counts, gt_counts = self._chunk_counts(chunk, b_pad)
        return evaluate_matches(
            self._padded([self.detections[i] for i in chunk], b_pad, pd, 0),
            self._padded([self.detection_scores[i] for i in chunk], b_pad, pd, 0),
            self._padded([self.detection_labels[i] for i in chunk], b_pad, pd, -1),
            det_counts,
            self._padded([self.groundtruths[i] for i in chunk], b_pad, pg, 0),
            self._padded([self.groundtruth_labels[i] for i in chunk], b_pad, pg, -1),
            gt_counts,
            *consts, plain=self._plain_kernels,
        )

    def _evaluate_segm_chunk(self, chunk: List[int], pd: int, pg: int, b_pad: int, consts: Tuple) -> Dict[str, Tensor]:
        """One chunk of the segm route: each image's mask IoUs (one matrix
        product, in float32 for one image at a time) padded into the chunk's
        (b_pad, pd, pg) tensor with +0.0 outside the valid pairs, its pixel
        areas likewise, then the matcher (``evaluate_given_ious``)."""
        ious = torch.zeros((b_pad, pd, pg), dtype=torch.float32, device=self.device)
        for b, i in enumerate(chunk):
            det, gt = self.detections[i], self.groundtruths[i]
            if det.shape[0] and gt.shape[0]:
                ious[b, : det.shape[0], : gt.shape[0]] = mask_iou(det, gt)
        det_counts, gt_counts = self._chunk_counts(chunk, b_pad)
        return evaluate_given_ious(
            ious,
            self._padded([mask_area(self.detections[i]) for i in chunk], b_pad, pd, 0),
            self._padded([self.detection_scores[i] for i in chunk], b_pad, pd, 0),
            self._padded([self.detection_labels[i] for i in chunk], b_pad, pd, -1),
            det_counts,
            self._padded([mask_area(self.groundtruths[i]) for i in chunk], b_pad, pg, 0),
            self._padded([self.groundtruth_labels[i] for i in chunk], b_pad, pg, -1),
            gt_counts,
            *consts, plain=self._plain_kernels,
        )

    # ------------------------------------------------------------------ #
    # host-side curve aggregation (the JAX package's code, unchanged)
    # ------------------------------------------------------------------ #
    def _calculate(
        self, class_ids: List[int], evals: Optional[List[Optional[Dict[str, np.ndarray]]]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        nb_iou_thrs = len(self.iou_thresholds)
        nb_rec_thrs = len(self.rec_thresholds)
        nb_classes = len(class_ids)
        nb_areas = len(self.bbox_area_ranges)
        nb_mdt = len(self.max_detection_thresholds)

        precision = -np.ones((nb_iou_thrs, nb_rec_thrs, nb_classes, nb_areas, nb_mdt))
        recall = -np.ones((nb_iou_thrs, nb_classes, nb_areas, nb_mdt))
        rec_thrs = np.asarray(self.rec_thresholds)

        if evals is None:
            evals = self._evaluate_images(class_ids)

        for idx_cls in range(nb_classes):
            for idx_area in range(nb_areas):
                img_data = []
                npig = 0
                for ev in evals:
                    if ev is None:
                        continue
                    det_sel = ev["det_class_valid"][idx_cls]  # (D,) bool
                    gt_sel = ev["gt_class_valid"][idx_cls]
                    if not det_sel.any() and not gt_sel.any():
                        continue
                    npig += int(np.sum(gt_sel & ~ev["gt_area_ignore"][idx_area]))
                    img_data.append(
                        (
                            ev["scores_sorted"][det_sel],
                            ev["merged"][idx_area][:, det_sel],  # (T, n)
                            ev["det_area_ignore"][idx_area][det_sel],  # (n,)
                        )
                    )
                if npig == 0 or not img_data:
                    continue
                for idx_mdt, max_det in enumerate(self.max_detection_thresholds):
                    det_scores = np.concatenate([s[:max_det] for s, _, _ in img_data])
                    matches = np.concatenate([m[:, :max_det] for _, m, _ in img_data], axis=1)  # (T, N)
                    area_ign = np.concatenate([a[:max_det] for _, _, a in img_data])  # (N,)
                    inds = np.argsort(-det_scores, kind="stable")
                    matches = matches[:, inds]
                    area_ign_s = area_ign[inds]
                    # unmatched detections outside the area range are ignored
                    det_ignore = (~matches) & area_ign_s[None, :]

                    tps = matches & ~det_ignore
                    fps = (~matches) & ~det_ignore
                    tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                    for idx_iou in range(nb_iou_thrs):
                        tp, fp = tp_sum[idx_iou], fp_sum[idx_iou]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.finfo(np.float64).eps)
                        recall[idx_iou, idx_cls, idx_area, idx_mdt] = rc[-1] if nd else 0
                        # monotone envelope from the right (zigzag removal)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        i_thr = np.searchsorted(rc, rec_thrs, side="left")
                        num_inds = int(i_thr.argmax()) if i_thr.max() >= nd else nb_rec_thrs
                        prec = np.zeros(nb_rec_thrs)
                        prec[:num_inds] = pr[i_thr[:num_inds]]
                        precision[idx_iou, :, idx_cls, idx_area, idx_mdt] = prec
        return precision, recall

    def _summarize(
        self,
        precision: np.ndarray,
        recall: np.ndarray,
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> np.float32:
        area_idx = list(self.bbox_area_ranges.keys()).index(area_range)
        mdet_idx = self.max_detection_thresholds.index(max_dets)
        if avg_prec:
            prec = precision[..., area_idx, mdet_idx]
            if iou_threshold is not None:
                prec = prec[self.iou_thresholds.index(iou_threshold)]
        else:
            prec = recall[..., area_idx, mdet_idx]
            if iou_threshold is not None:
                prec = prec[self.iou_thresholds.index(iou_threshold)]
        valid = prec[prec > -1]
        return np.float32(-1.0 if valid.size == 0 else valid.mean())

    def _summarize_results(self, precision: np.ndarray, recall: np.ndarray) -> Dict[str, np.float32]:
        last_mdt = self.max_detection_thresholds[-1]
        res: Dict[str, np.float32] = {}
        res["map"] = self._summarize(precision, recall, True, max_dets=last_mdt)
        res["map_50"] = (
            self._summarize(precision, recall, True, iou_threshold=0.5, max_dets=last_mdt)
            if 0.5 in self.iou_thresholds
            else np.float32(-1.0)
        )
        res["map_75"] = (
            self._summarize(precision, recall, True, iou_threshold=0.75, max_dets=last_mdt)
            if 0.75 in self.iou_thresholds
            else np.float32(-1.0)
        )
        res["map_small"] = self._summarize(precision, recall, True, area_range="small", max_dets=last_mdt)
        res["map_medium"] = self._summarize(precision, recall, True, area_range="medium", max_dets=last_mdt)
        res["map_large"] = self._summarize(precision, recall, True, area_range="large", max_dets=last_mdt)
        for max_det in self.max_detection_thresholds:
            res[f"mar_{max_det}"] = self._summarize(precision, recall, False, max_dets=max_det)
        res["mar_small"] = self._summarize(precision, recall, False, area_range="small", max_dets=last_mdt)
        res["mar_medium"] = self._summarize(precision, recall, False, area_range="medium", max_dets=last_mdt)
        res["mar_large"] = self._summarize(precision, recall, False, area_range="large", max_dets=last_mdt)
        return res

    def compute(self) -> Dict[str, Tensor]:
        """The results as float32 tensors on the metric's device: 0-d
        scalars, and ``map_per_class`` / ``mar_{max}_per_class`` of one
        value per class (``[-1]`` unless ``class_metrics``)."""
        classes = self._get_classes()
        precision, recall = self._calculate(classes)
        metrics = self._summarize_results(precision, recall)

        map_per_class = np.asarray([-1.0], np.float32)
        mar_per_class = np.asarray([-1.0], np.float32)
        if self.class_metrics and classes:
            map_list, mar_list = [], []
            for class_idx in range(len(classes)):
                cls_res = self._summarize_results(
                    precision[:, :, class_idx : class_idx + 1], recall[:, class_idx : class_idx + 1]
                )
                map_list.append(cls_res["map"])
                mar_list.append(cls_res[f"mar_{self.max_detection_thresholds[-1]}"])
            map_per_class = np.asarray(map_list, np.float32)
            mar_per_class = np.asarray(mar_list, np.float32)
        names = list(metrics)
        scalars = torch.from_numpy(np.asarray([metrics[n] for n in names], np.float32)).to(self.device)
        out = dict(zip(names, scalars.unbind()))
        out["map_per_class"] = torch.from_numpy(map_per_class).to(self.device)
        out[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = torch.from_numpy(mar_per_class).to(self.device)
        return out

    # ------------------------------------------------------------------ #
    # distributed sync of the list routes: per-image tensors keep their
    # boundaries, so the gather goes image by image
    # ------------------------------------------------------------------ #
    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        """Device state syncs as seven ``cat`` buffers (the generic path).
        The list routes first agree on the per-rank image counts, then run
        one gather round per image up to the largest count, a short rank
        sending empties that are dropped by count (an image with no boxes is
        an image); masks are padded to the largest (H, W) first. The lists
        come back in rank-major order. A world of one runs the same rounds,
        as every other state syncs there too."""
        if self._device_state or dist_sync_fn is not None:
            return super()._sync_dist(dist_sync_fn, process_group)
        group = self._sync_group(process_group)
        local = torch.tensor([len(self.detections)], dtype=torch.int64, device=self.device)
        counts = torch.cat(_sync.gather_all_arrays(local, group)).tolist()
        state = {name: list(getattr(self, name)) for name in _LIST_STATES}
        if self.iou_type == "segm":
            hw = [0, 0]
            for m in state["detections"] + state["groundtruths"]:
                if m.ndim == 3 and m.shape[0] > 0:
                    hw = [max(hw[0], m.shape[1]), max(hw[1], m.shape[2])]
            all_hw = torch.stack(_sync.gather_all_arrays(torch.tensor(hw, dtype=torch.int64, device=self.device), group))
            h_max, w_max = all_hw.amax(dim=0).tolist()

            def pad(m: Tensor) -> Tensor:
                m = m.reshape(-1, *(m.shape[1:] if m.ndim == 3 else (0, 0)))
                out = torch.zeros((m.shape[0], h_max, w_max), dtype=torch.bool, device=m.device)
                out[:, : m.shape[1], : m.shape[2]] = m
                return out

            state["detections"] = [pad(m) for m in state["detections"]]
            state["groundtruths"] = [pad(m) for m in state["groundtruths"]]
            geom_empty = torch.zeros((0, h_max, w_max), dtype=torch.bool, device=self.device)
        else:
            geom_empty = torch.zeros((0, 4), dtype=torch.float32, device=self.device)
        # dtype- and shape-correct dummies, so every rank's gather round agrees
        empties = {
            "detections": geom_empty,
            "groundtruths": geom_empty,
            "detection_scores": torch.zeros((0,), dtype=torch.float32, device=self.device),
            "detection_labels": torch.zeros((0,), dtype=torch.int32, device=self.device),
            "groundtruth_labels": torch.zeros((0,), dtype=torch.int32, device=self.device),
        }
        synced: Dict[str, List[Tensor]] = {}
        for name in _LIST_STATES:
            rounds = [
                _sync.gather_all_arrays(state[name][i] if i < len(state[name]) else empties[name], group)
                for i in range(max(counts))
            ]
            synced[name] = [rounds[i][r] for r in range(len(counts)) for i in range(counts[r])]
        self.set_state(synced)
