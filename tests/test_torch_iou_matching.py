"""The port's IoU and greedy matcher against the JAX package's, on the CPU.

``metrics_tpu_torch.ops.kernels.iou_matching`` runs its plain PyTorch
versions here (CPU tensors); the CUDA kernels are held against those plain
versions, bit for bit, on the card by ``chip_smoke.py``.

Tolerances, and why:

- ``pairwise_iou`` is bitwise equal to the JAX package's eager ``box_iou``:
  both are the same IEEE float32 operations in the same order. With the
  per-image counts it is bitwise equal to eager ``box_iou`` under
  ``jnp.where(valid_pairs, ., 0.0)``, as ``_image_eval`` forms it.
- Against the jitted JAX paths (``jax.jit`` of ``box_iou`` and the Pallas
  body in interpret mode) the IoU is within 4 ulp (``rtol=2e-6, atol=0``):
  XLA's CPU code generation does not round those operations one by one.
- Every other output of ``evaluate_matches`` is bitwise. An IoU that differs
  by a few ulp could flip a match only where it lies within a few ulp of a
  threshold, so every seeded case first asserts that every valid IoU lies
  more than 8 ulp from every threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.detection.boxes import box_iou as jax_box_iou
from metrics_tpu.ops.kernels.iou_matching import _merged_greedy_match, _pairwise_iou_pallas
from metrics_tpu.ops.kernels.iou_matching import evaluate_matches as jax_evaluate_matches
from metrics_tpu_torch.ops.kernels import CUDA_KERNELS, launch_counts
from metrics_tpu_torch.ops.kernels.cosine_matching import maxsim, maxsim_plain
from metrics_tpu_torch.ops.kernels.iou_matching import (
    evaluate_matches,
    greedy_match,
    greedy_match_plain,
    match_inputs,
    pairwise_iou,
    pairwise_iou_plain,
)
from tests.detection.oracle import box_iou_np
from tests.helpers.torch_port import (
    AREA_RANGES,
    CLASS_IDS,
    CLASS_MASK,
    IOU_THRESHOLDS,
    assert_bitwise,
    assert_close,
    assert_iou_margin,
    random_boxes,
    random_images,
)

T = torch.from_numpy


def _port_eval(batch, thresholds=IOU_THRESHOLDS, max_det=100):
    return evaluate_matches(
        *(T(batch[k]) for k in ("det_boxes", "det_scores", "det_labels", "det_counts",
                                 "gt_boxes", "gt_labels", "gt_counts")),
        T(CLASS_IDS), T(CLASS_MASK), T(AREA_RANGES), T(thresholds), max_det,
    )


def _jax_eval(batch, use_pallas, thresholds=IOU_THRESHOLDS, max_det=100):
    return jax_evaluate_matches(
        **batch, class_ids=CLASS_IDS, class_mask=CLASS_MASK, area_ranges=AREA_RANGES,
        thresholds=thresholds, max_det=max_det, use_pallas=use_pallas,
    )


def _valid_pairs(batch):
    d, g = batch["det_scores"].shape[1], batch["gt_labels"].shape[1]
    return (np.arange(d)[None, :, None] < batch["det_counts"][:, None, None]) & (
        np.arange(g)[None, None, :] < batch["gt_counts"][:, None, None]
    )


def _grow(rng, batch, side: str, minimum: int) -> None:
    """Raise every image's count on one side to ``minimum``, with fresh boxes
    and labels in the rows that become valid."""
    counts = batch[f"{side}_counts"]
    for i, n in enumerate(counts):
        if n < minimum:
            batch[f"{side}_boxes"][i, n:minimum] = random_boxes(rng, minimum - n)
            batch[f"{side}_labels"][i, n:minimum] = rng.integers(0, 3, size=minimum - n)
            if side == "det":
                batch["det_scores"][i, n:minimum] = rng.uniform(0, 1, size=minimum - n)
    batch[f"{side}_counts"] = np.maximum(counts, minimum).astype(np.int32)


def _case(name: str) -> dict:
    rng = np.random.default_rng({"random": 0, "random_b5": 1, "no_dets": 2, "no_gts": 3,
                                 "duplicate_gts": 4, "degenerate": 5, "touching": 6}[name])
    batch = random_images(rng, 5 if name == "random_b5" else 8)
    if name == "no_dets":
        batch["det_counts"][:] = 0
    elif name == "no_gts":
        batch["gt_counts"][:] = 0
    elif name == "duplicate_gts":
        # two identical ground truths of one label, and detections on them:
        # the matcher's argmax meets exact ties and must take the lower index
        _grow(rng, batch, "gt", 3)
        _grow(rng, batch, "det", 4)
        batch["gt_boxes"][:, 1] = batch["gt_boxes"][:, 0]
        batch["gt_labels"][:, :3] = 1
        batch["det_boxes"][:, 0] = batch["gt_boxes"][:, 0]
        batch["det_boxes"][:, 1] = batch["gt_boxes"][:, 0]
        batch["det_boxes"][:, 2] = batch["gt_boxes"][:, 0] + np.float32(0.5)
        batch["det_labels"][:, :3] = 1
        batch["det_scores"] *= np.float32(0.5)
        batch["det_scores"][:, :4] = np.float32([0.9, 0.8, 0.7, 0.6])
    elif name == "degenerate":
        _grow(rng, batch, "det", 3)
        _grow(rng, batch, "gt", 2)
        batch["det_boxes"][:, 0, 2] = batch["det_boxes"][:, 0, 0]  # zero width
        batch["det_boxes"][:, 1, [0, 2]] = batch["det_boxes"][:, 1, [2, 0]]  # x2 < x1
        batch["gt_boxes"][:, 0, 3] = batch["gt_boxes"][:, 0, 1]  # zero height
        batch["gt_boxes"][:, 1, [1, 3]] = batch["gt_boxes"][:, 1, [3, 1]]  # y2 < y1
    elif name == "touching":
        # detections that share an edge or a corner with a ground truth: inter 0
        _grow(rng, batch, "det", 2)
        _grow(rng, batch, "gt", 1)
        gt0 = batch["gt_boxes"][:, 0]
        w, h = gt0[:, 2] - gt0[:, 0], gt0[:, 3] - gt0[:, 1]
        batch["det_boxes"][:, 0] = gt0 + np.stack([w, 0 * w, w, 0 * w], axis=1)
        batch["det_boxes"][:, 1] = gt0 + np.stack([w, h, w, h], axis=1)
        batch["det_labels"][:, :2] = batch["gt_labels"][:, :1]
    for side in ("det", "gt"):  # pads as the padded buffers hold them
        for i, n in enumerate(batch[f"{side}_counts"]):
            batch[f"{side}_labels"][i, n:] = -1
            batch[f"{side}_boxes"][i, n:] = 0.0
    batch["det_scores"][np.arange(batch["det_scores"].shape[1])[None, :] >= batch["det_counts"][:, None]] = 0.0
    return batch


CASES = ["random", "random_b5", "no_dets", "no_gts", "duplicate_gts", "degenerate", "touching"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou_bitwise_equals_eager_box_iou(seed):
    batch = random_images(np.random.default_rng(seed), 6)
    got = pairwise_iou(T(batch["det_boxes"]), T(batch["gt_boxes"]))
    for b in range(got.shape[0]):
        want = jax_box_iou(jnp.asarray(batch["det_boxes"][b]), jnp.asarray(batch["gt_boxes"][b]))
        assert_bitwise(got[b], want, msg=f"image {b}")


@pytest.mark.parametrize("impl", ["jit", "pallas_interpret"])
def test_pairwise_iou_within_4_ulp_of_the_jitted_paths(impl):
    batch = random_images(np.random.default_rng(7), 8)
    got = pairwise_iou(T(batch["det_boxes"]), T(batch["gt_boxes"]))
    det, gt = jnp.asarray(batch["det_boxes"]), jnp.asarray(batch["gt_boxes"])
    if impl == "jit":
        want = jax.jit(jax.vmap(jax_box_iou))(det, gt)
    else:
        want = _pairwise_iou_pallas(det, gt, interpret=True)
    assert_close(got, want, rtol=2e-6, atol=0.0, msg=impl)


def test_pairwise_iou_degenerate_and_touching_boxes():
    det = np.float32([[[0, 0, 0, 5], [5, 0, 0, 5], [10, 10, 20, 20], [0, 0, 2, 2], [1e6, 1e6, 1e6 + 3, 1e6 + 4]]])
    gt = np.float32([[[20, 10, 30, 20], [0, 0, 2, 2], [10, 20, 20, 30], [1e6 + 1, 1e6, 1e6 + 3, 1e6 + 4]]])
    got = pairwise_iou(T(det), T(gt))
    assert_bitwise(got[0], jax_box_iou(jnp.asarray(det[0]), jnp.asarray(gt[0])))
    np.testing.assert_allclose(got[0].numpy(), box_iou_np(det[0], gt[0]), rtol=1e-6, atol=0)
    assert float(got[0, 2, 0]) == 0.0 and float(got[0, 2, 2]) == 0.0  # touching: no overlap
    assert float(got[0, 3, 1]) == 1.0  # identical boxes


@pytest.mark.parametrize("use_pallas", ["force", "never"])
@pytest.mark.parametrize("case", CASES)
def test_evaluate_matches_bitwise(case, use_pallas):
    batch = _case(case)
    got = _port_eval(batch)
    ious = pairwise_iou_plain(T(batch["det_boxes"]), T(batch["gt_boxes"]), T(batch["det_counts"]), T(batch["gt_counts"]))
    assert_iou_margin(ious.numpy(), _valid_pairs(batch), IOU_THRESHOLDS)
    want = _jax_eval(batch, use_pallas)
    det_matches = got["merged"][:, None] & got["det_class_valid"][:, :, None, None, :]
    assert_bitwise(det_matches, want["det_matches"], msg="det_matches")
    for key in ("scores_sorted", "det_class_valid", "det_area_ignore", "gt_class_valid", "gt_area_ignore"):
        assert_bitwise(got[key], want[key], msg=key)
    if case == "duplicate_gts":  # the tie went to the lower index: both duplicates matched
        assert got["merged"][:, 0, 0, :2].all()


def test_evaluate_matches_small_max_det_cap():
    batch = _case("random")
    got = _port_eval(batch, max_det=2)
    want = _jax_eval(batch, "never", max_det=2)
    assert_bitwise(got["det_class_valid"], want["det_class_valid"])
    assert_bitwise(got["merged"][:, None] & got["det_class_valid"][:, :, None, None, :], want["det_matches"])
    assert int(got["det_class_valid"].sum(dim=2).max()) <= 2


def test_iou_of_exactly_one_half_does_not_match_at_one_half():
    """det [0,0,2,1] and gt [0,0,1,1]: inter 1, union 2, IoU exactly 0.5; the
    matcher needs IoU > threshold, so it matches at 0.45 and not at 0.5."""
    batch = dict(
        det_boxes=np.float32([[[0, 0, 2, 1]]]), det_scores=np.float32([[0.9]]), det_labels=np.int32([[0]]),
        det_counts=np.int32([1]), gt_boxes=np.float32([[[0, 0, 1, 1]]]), gt_labels=np.int32([[0]]),
        gt_counts=np.int32([1]),
    )
    thresholds = np.float32([0.45, 0.5])
    assert float(pairwise_iou(T(batch["det_boxes"]), T(batch["gt_boxes"]))[0, 0, 0]) == 0.5
    got = _port_eval(batch, thresholds=thresholds)["merged"][0, 0, :, 0].tolist()
    assert got == [True, False]
    want = _jax_eval(batch, "never", thresholds=thresholds)["det_matches"][0, 0, 0, :, 0]
    assert np.asarray(want).tolist() == got
    assert box_iou_np(batch["det_boxes"][0], batch["gt_boxes"][0])[0, 0] == 0.5  # the oracle's IoU


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_match_plain_equals_the_jax_scan_with_ties(seed):
    """IoUs drawn from a few values, so that rows tie and some equal a
    threshold: the plain matcher must follow the scan's argmax and its
    strict ``>``."""
    rng = np.random.default_rng(seed)
    b, d, g, a = 6, 12, 7, 3
    ious = rng.choice(np.float32([0.0, 0.3, 0.6, 0.6, 0.9, 1.0]), size=(b, d, g)).astype(np.float32)
    det_ok = rng.random((b, d)) < 0.8
    det_labels = rng.integers(0, 2, size=(b, d)).astype(np.int32)
    gt_labels = rng.integers(0, 2, size=(b, g)).astype(np.int32)
    gt_ok = rng.random((b, g)) < 0.85
    gt_ignore = rng.random((b, a, g)) < 0.2
    thresholds = np.float32([0.3, 0.5, 0.6, 0.95])
    got = greedy_match(T(ious), T(det_ok), T(det_labels), T(gt_labels), T(gt_ok), T(gt_ignore), T(thresholds))
    want = jax.vmap(_merged_greedy_match, in_axes=(0, 0, 0, 0, 0, 0, None))(
        jnp.asarray(ious), jnp.asarray(det_ok), jnp.asarray(det_labels), jnp.asarray(gt_labels),
        jnp.asarray(gt_ok), jnp.asarray(gt_ignore), jnp.asarray(thresholds),
    )
    assert_bitwise(got, want)


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    batch = random_images(np.random.default_rng(11), 4)
    before = launch_counts()
    det, gt = T(batch["det_boxes"]), T(batch["gt_boxes"])
    assert_bitwise(pairwise_iou(det, gt), pairwise_iou_plain(det, gt))
    assert_bitwise(pairwise_iou(det, gt, plain=True), pairwise_iou_plain(det, gt))
    _port_eval(batch)
    # maxsim on a TMA-describable shape (D=64) and on one that is not (D=7)
    rng = np.random.default_rng(12)
    for d in (64, 7):
        pe, te = (T(rng.normal(size=(2, 1, n, d)).astype(np.float32)) for n in (5, 3))
        for g, w in zip(maxsim(pe, te), maxsim_plain(pe, te)):
            assert_bitwise(g, w)
    assert launch_counts() == before
    assert all(kernel._lib is None for kernel in CUDA_KERNELS.values())


def test_wrappers_reject_other_devices_and_shapes():
    meta = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pairwise_iou(meta, meta)
    with pytest.raises(ValueError, match=r"\(B, D, 4\)"):
        pairwise_iou(torch.zeros((3, 4)), torch.zeros((3, 4)))
    ious = torch.zeros((1, 2, 0))
    with pytest.raises(ValueError, match="at least one ground-truth column"):
        greedy_match(ious, torch.ones((1, 2), dtype=torch.bool), torch.zeros((1, 2), dtype=torch.int32),
                     torch.zeros((1, 0), dtype=torch.int32), torch.zeros((1, 0), dtype=torch.bool),
                     torch.zeros((1, 4, 0), dtype=torch.bool), torch.tensor([0.5]))
    with pytest.raises(ValueError, match="do not agree"):
        greedy_match(torch.zeros((1, 2, 3)), torch.ones((1, 3), dtype=torch.bool), torch.zeros((1, 2), dtype=torch.int32),
                     torch.zeros((1, 3), dtype=torch.int32), torch.zeros((1, 3), dtype=torch.bool),
                     torch.zeros((1, 4, 3), dtype=torch.bool), torch.tensor([0.5]))
    assert greedy_match_plain is not None


def _count_pattern(batch, pattern):
    """The batch's counts, or all zero, all full, or beyond D and G."""
    d, g = batch["det_boxes"].shape[1], batch["gt_boxes"].shape[1]
    if pattern == "zero":
        batch["det_counts"][:], batch["gt_counts"][:] = 0, 0
    elif pattern == "full":
        batch["det_counts"][:], batch["gt_counts"][:] = d, g
    elif pattern == "beyond":
        batch["det_counts"][::2], batch["gt_counts"][1::2] = d + 3, g + 5
    return batch


@pytest.mark.parametrize("pattern", ["mixed", "zero", "full", "beyond"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_iou_with_counts_equals_box_iou_under_the_image_eval_mask(seed, pattern):
    """The plain version with counts against the JAX package's eager
    ``box_iou`` under ``jnp.where(valid_pairs, ., 0.0)``, image by image;
    the pads hold random boxes, which the mask must zero as +0.0."""
    rng = np.random.default_rng(20 + seed)
    batch = _count_pattern(random_images(rng, 6), pattern)
    batch["det_boxes"][:] = np.stack([random_boxes(rng, batch["det_boxes"].shape[1]) for _ in range(6)])
    batch["gt_boxes"][:] = np.stack([random_boxes(rng, batch["gt_boxes"].shape[1]) for _ in range(6)])
    det, gt, dc, gc = (T(batch[k]) for k in ("det_boxes", "gt_boxes", "det_counts", "gt_counts"))
    got = pairwise_iou_plain(det, gt, dc, gc)
    valid = _valid_pairs(batch)
    for b in range(got.shape[0]):
        iou = jax_box_iou(jnp.asarray(batch["det_boxes"][b]), jnp.asarray(batch["gt_boxes"][b]))
        assert_bitwise(got[b], jnp.where(jnp.asarray(valid[b]), iou, 0.0), msg=f"image {b}")
    assert not np.signbit(got.numpy()[~valid]).any()  # invalid pairs are +0.0
    assert_bitwise(pairwise_iou(det, gt, dc, gc), got)  # the wrapper on CPU tensors


@pytest.mark.parametrize("side", ["det_counts", "gt_counts"])
def test_pairwise_iou_takes_both_count_arrays_or_neither(side):
    batch = random_images(np.random.default_rng(30), 5)
    det, gt = T(batch["det_boxes"]), T(batch["gt_boxes"])
    with pytest.raises(ValueError, match="together"):
        pairwise_iou(det, gt, **{side: T(batch[side])})


def test_pairwise_iou_with_nan_boxes_inside_and_outside_the_valid_region():
    """A NaN corner makes its box's area NaN, so its union is NaN and its IoU
    0, as in ``box_iou``; a pad row or column is 0 whatever its boxes."""
    rng = np.random.default_rng(31)
    batch = random_images(rng, 4, max_det=9, max_gt=7)
    batch["det_boxes"][:] = np.stack([random_boxes(rng, 16) for _ in range(4)])
    batch["det_boxes"][:, ::3, 0] = np.nan
    batch["gt_boxes"][:, ::2, 3] = np.nan
    det, gt, dc, gc = (T(batch[k]) for k in ("det_boxes", "gt_boxes", "det_counts", "gt_counts"))
    got = pairwise_iou(det, gt, dc, gc)
    valid = _valid_pairs(batch)
    for b in range(4):
        iou = jax_box_iou(jnp.asarray(batch["det_boxes"][b]), jnp.asarray(batch["gt_boxes"][b]))
        assert_bitwise(got[b], jnp.where(jnp.asarray(valid[b]), iou, 0.0), msg=f"image {b}")
    assert not torch.isnan(got).any()


def test_match_inputs_leaves_the_valid_pairs_to_the_kernel():
    """``evaluate_matches`` hands the counts to ``pairwise_iou``; no (B, D, G)
    valid-pair mask is formed before it."""
    batch = _case("random")
    prep = match_inputs(
        *(T(batch[k]) for k in ("det_boxes", "det_scores", "det_labels", "det_counts", "gt_boxes", "gt_labels",
                                 "gt_counts")),
        T(CLASS_IDS), T(CLASS_MASK), T(AREA_RANGES), 100,
    )
    assert "valid_pairs" not in prep
    assert all(v.ndim < 3 or v.shape[1:] != (batch["det_boxes"].shape[1], batch["gt_boxes"].shape[1])
               for v in prep.values())


def test_pairwise_iou_rejects_counts_of_another_shape():
    boxes = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match=r"\(B,\) det_counts"):
        pairwise_iou(boxes, boxes, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B,\) gt_counts"):
        pairwise_iou(boxes, boxes, None, torch.zeros((2, 1), dtype=torch.int32))
