"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: to
``metrics_tpu`` as JAX arrays, to ``metrics_tpu_torch`` as CPU tensors.
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
import torch


def strict_float32() -> None:
    """Full-precision float32 everywhere: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bitwise(got: Any, want: Any, msg: str = "") -> None:
    """Equal dtype, shape and bits (NaNs compare equal by their bits)."""
    g, w = as_numpy(got), as_numpy(want)
    assert g.dtype == w.dtype, f"{msg}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8), err_msg=msg)


def assert_close(got: Any, want: Any, rtol: float = 1e-6, atol: float = 1e-7, msg: str = "") -> None:
    """Within the stated tolerance; used where only the sum order may differ."""
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True, err_msg=msg)


class BodyGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    captured step's body (static inputs to static outputs), so the card's
    replay path of ``metrics_tpu_torch.core.engine.CapturedStep`` (input
    copies, in-place statics, backups of held statics, clones out) runs
    without a card."""

    def __init__(self, step: Any) -> None:
        self.step = step

    def replay(self) -> None:
        from metrics_tpu_torch.core import engine

        with engine._steady():
            self.step._body()


def use_card_replay_path(monkeypatch: Any) -> None:
    """Give every step the engines capture from now on a :class:`BodyGraph`."""
    from metrics_tpu_torch.core import engine

    probe = engine.CapturedStep.probe

    def probe_then_graph(self, state, args, kwargs):
        out = probe(self, state, args, kwargs)
        self.graph = BodyGraph(self)
        return out

    monkeypatch.setattr(engine.CapturedStep, "probe", probe_then_graph)


def both(x: np.ndarray):
    """The same numpy array as a JAX array and as a CPU tensor."""
    return jnp.asarray(x), torch.from_numpy(np.array(x, copy=True))


# --------------------------------------------------------------------------- #
# detection fixtures, shared by test_torch_iou_matching.py and test_torch_mean_ap.py
# --------------------------------------------------------------------------- #
# the class, area and threshold grids of tests/ops/test_heavy_kernels.py
CLASS_IDS = np.array([0, 1, 2, 0], np.int32)
CLASS_MASK = np.array([True, True, True, False])
AREA_RANGES = np.array([[0.0, 1e10], [0.0, 1024.0], [1024.0, 9216.0], [9216.0, 1e10]], np.float32)
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10).astype(np.float32)
COCO_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2).astype(np.float32)


def random_boxes(rng: np.random.Generator, n: int, low: float = 0.0, high: float = 80.0,
                 wh: tuple = (1.0, 40.0)) -> np.ndarray:
    """n float32 xyxy boxes: corners uniform in [low, high), sides in ``wh``."""
    xy = rng.uniform(low, high, size=(n, 2)).astype(np.float32)
    side = rng.uniform(*wh, size=(n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + side], axis=1)


def random_images(rng: np.random.Generator, n_images: int, max_det: int = 9, max_gt: int = 7,
                  pad_det: int = 16, pad_gt: int = 8, n_classes: int = 3) -> dict:
    """Padded ragged detection and ground-truth buffers with their counts, the
    shape of ``_random_images`` in tests/ops/test_heavy_kernels.py."""

    def boxes(n, pad):
        out = random_boxes(rng, pad)
        out[n:] = 0.0
        return out

    det_boxes, det_scores, det_labels, det_counts = [], [], [], []
    gt_boxes, gt_labels, gt_counts = [], [], []
    for _ in range(n_images):
        nd = int(rng.integers(0, max_det + 1))
        ng = int(rng.integers(0, max_gt + 1))
        det_boxes.append(boxes(nd, pad_det))
        scores = rng.uniform(0, 1, size=pad_det).astype(np.float32)
        scores[nd:] = 0.0
        det_scores.append(scores)
        lbl = rng.integers(0, n_classes, size=pad_det).astype(np.int32)
        lbl[nd:] = -1
        det_labels.append(lbl)
        det_counts.append(nd)
        gt_boxes.append(boxes(ng, pad_gt))
        glbl = rng.integers(0, n_classes, size=pad_gt).astype(np.int32)
        glbl[ng:] = -1
        gt_labels.append(glbl)
        gt_counts.append(ng)
    return dict(
        det_boxes=np.stack(det_boxes), det_scores=np.stack(det_scores),
        det_labels=np.stack(det_labels), det_counts=np.asarray(det_counts, np.int32),
        gt_boxes=np.stack(gt_boxes), gt_labels=np.stack(gt_labels),
        gt_counts=np.asarray(gt_counts, np.int32),
    )


def coco_dataset(rng: np.random.Generator, n_images: int, n_classes: int = 3, max_gt: int = 8,
                 max_det: int = 16, img_size: float = 200.0) -> tuple:
    """COCO list-of-dicts inputs in numpy: jittered copies of the ground truths
    (kept label with probability 0.9) plus random detections, the shape of
    ``_random_dataset`` in tests/detection/test_map.py at a smaller size."""
    preds, targets = [], []
    for _ in range(n_images):
        n_gt = int(rng.integers(0, max_gt + 1))
        gt = random_boxes(rng, n_gt, 0.0, img_size * 0.8, (2.0, img_size * 0.4))
        gt_labels = rng.integers(0, n_classes, size=n_gt).astype(np.int32)
        boxes, labels, scores = [], [], []
        for box, label in zip(gt, gt_labels):
            if rng.random() < 0.8 and len(boxes) < max_det:
                boxes.append(box + rng.normal(0, rng.uniform(0.5, 8.0), size=4).astype(np.float32))
                labels.append(label if rng.random() < 0.9 else rng.integers(0, n_classes))
                scores.append(rng.uniform(0.3, 1.0))
        n_noise = int(rng.integers(0, max_det - len(boxes) + 1))
        for box in random_boxes(rng, n_noise, 0.0, img_size * 0.8, (2.0, img_size * 0.4)):
            boxes.append(box)
            labels.append(rng.integers(0, n_classes))
            scores.append(rng.uniform(0.0, 0.7))
        preds.append({
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "scores": np.asarray(scores, np.float32),
            "labels": np.asarray(labels, np.int32),
        })
        targets.append({"boxes": gt, "labels": gt_labels})
    return preds, targets


def assert_iou_margin(ious: np.ndarray, valid: np.ndarray, thresholds: np.ndarray, ulps: int = 8) -> None:
    """Every valid IoU lies more than ``ulps`` float32 ulp from every
    threshold, so an IoU that differs by a few ulp between two correct
    implementations can never flip a match."""
    v = np.asarray(ious, np.float32)[np.asarray(valid, bool)]
    thr = np.asarray(thresholds, np.float32)
    gap = np.abs(v[:, None].astype(np.float64) - thr[None, :].astype(np.float64))
    assert not (gap <= ulps * np.spacing(thr)[None, :].astype(np.float64)).any(), \
        "an IoU lies within a few ulp of a threshold: pick another seed"
