"""MeanAveragePrecision (COCO mAP / mAR), bbox with device-resident state.

Counterpart of ``metrics_tpu/detection/mean_ap.py`` on its default path,
``iou_type="bbox"`` with ``device_state=True``: the per-image detections and
ground truths live in padded ``CatBuffer`` states on the metric's device, and
``compute`` feeds them to :func:`~metrics_tpu_torch.ops.kernels.iou_matching.evaluate_matches`
in chunks of 256 images. Its two hot steps are CUDA kernels: the pairwise IoU
and the greedy matcher.

What differs from the JAX package, and why:

- ``update`` pads on the device. The per-image counts come from the inputs'
  shapes, which the host knows; the scatter index is built on the host and
  sent in one copy from pinned memory, so ``update`` never waits for the card.
- ``compute`` fetches the merged matches ``(A, T, D)`` per image, not their
  class broadcast ``(K, A, T, D)``; ``_calculate`` selects a class's
  detections from them, which gives the same ``(T, n)`` slices bit for bit.
  Each 256-image chunk is sliced to its true sizes on the device and comes to
  the host in one copy.
- ``_calculate`` is the JAX package's host numpy code, unchanged, in float64.
- There is no ``use_pallas``: CUDA state always runs the kernels. The check
  hook ``_plain_kernels`` runs their plain versions instead.

Not ported yet: ``iou_type="segm"`` (mask IoU and RLE decoding) and
``device_state=False`` (the host-list path); both raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.detection.boxes import box_convert
from metrics_tpu_torch.ops.kernels.iou_matching import evaluate_matches
from metrics_tpu_torch.utils.prints import rank_zero_warn

_BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
_CHUNK_IMAGES = 256


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


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR over 10 IoU x 101 recall thresholds, 4 area ranges and 3
    max-detection thresholds, with per-class values when ``class_metrics``.

    Matching follows the JAX package (and the reference it ports), which
    excludes area-ignored ground truths from matching.

    State: seven ``CatBuffer`` states of ``buffer_capacity`` images (default
    1024, growing by doubling), with ``detections_capacity`` and
    ``groundtruths_capacity`` (rounded up to powers of two, default 128) rows
    per image. An image with more detections keeps its top-scoring ones, in
    their original order, with a warning; extra ground truths are truncated.

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
        if iou_type == "segm":
            raise NotImplementedError("MeanAveragePrecision(iou_type='segm') is not ported to metrics_tpu_torch yet")
        if device_state is not None and not device_state:
            raise NotImplementedError(
                "MeanAveragePrecision(device_state=False), the host-list path, is not ported to metrics_tpu_torch yet"
            )
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
        """State lives in padded device buffers (the only path ported)."""
        return True

    # ------------------------------------------------------------------ #
    # update
    # ------------------------------------------------------------------ #
    def _engine_accepts(self, args: Tuple, kwargs: Dict) -> bool:
        """The compiled update's per-call gate: it declines every call. The
        ``CatBuffer`` fill counts are python ints, which a captured graph
        cannot carry, so the update stays eager; the JAX package compiles its
        dense dict updates (``metrics_tpu/detection/mean_ap.py:292-298``)."""
        return False

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:  # type: ignore[override]
        if isinstance(preds, dict) and isinstance(target, dict):
            self._append_dense(preds, target)  # the dense padded form pad_inputs produces
            return
        _input_validator(preds, target, iou_type=self.iou_type)
        self._append_dense(*self.pad_inputs(preds, target))

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
        k = len(class_ids)
        k_pad = _next_bucket(max(k, 1), minimum=1)
        cid = torch.zeros(k_pad, dtype=torch.int32)
        cid[:k] = torch.tensor(class_ids, dtype=torch.int32)
        consts = (
            cid.to(self.device),
            (torch.arange(k_pad) < k).to(self.device),
            torch.tensor(list(self.bbox_area_ranges.values()), dtype=torch.float32, device=self.device),
            torch.tensor(self.iou_thresholds, dtype=torch.float32, device=self.device),
            self.max_detection_thresholds[-1],
        )
        return arrays, consts, det_counts_host, gt_counts_host

    def _evaluate_images(self, class_ids: List[int]) -> List[Optional[Dict[str, np.ndarray]]]:
        """The buffers feed :func:`evaluate_matches` in chunks of 256 images,
        padded to a power of two. Each chunk's outputs are sliced to its true
        sizes on the device and fetched in one copy; each image's entry is a
        dict of numpy views cut to its counts (None for an empty image)."""
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
            n_max = int(det_counts[start:stop].max())
            g_max = int(gt_counts[start:stop].max())
            parts = [  # the float32 part first, so its bytes stay aligned
                out["scores_sorted"][:nb, :n_max],
                out["merged"][:nb, :, :, :n_max],
                out["det_class_valid"][:nb, :k, :n_max],
                out["det_area_ignore"][:nb, :, :n_max],
                out["gt_class_valid"][:nb, :k, :g_max],
                out["gt_area_ignore"][:nb, :, :g_max],
            ]
            scores, merged, dcv, dai, gcv, gai = _unpack_bytes(_pack_bytes(parts).cpu().numpy(), parts)
            for b, i in enumerate(range(start, stop)):
                n, g = int(det_counts[i]), int(gt_counts[i])
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
        return evals

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
