"""The rest of detection in the port against the JAX package on the CPU: the
RLE codec, ``mask_iou`` / ``mask_area``, ``match_image``, and
``MeanAveragePrecision``'s host-list route (``device_state=False``) and
``iou_type="segm"`` (dense and RLE masks), with the list sync in a gloo world
of 4 ranks.

Results are bitwise equal to the JAX package's. The JAX host-list bbox route
computes its IoUs in a jitted program, which may differ from the eager
``box_iou`` by 4 ulp, so every seeded bbox case first asserts that no IoU lies
within 8 ulp of a threshold (``tests/test_torch_mean_ap.py``). Mask IoUs are
exact pixel counts and one division in both packages. Inputs come from
seeded numpy generators.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.ops.detection import boxes as jboxes
from metrics_tpu.ops.detection import matching as jmatching
from metrics_tpu.ops.detection import rle as jrle
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.ops.detection import boxes as tboxes
from metrics_tpu_torch.ops.detection import matching as tmatching
from metrics_tpu_torch.ops.detection import rle as trle
from metrics_tpu_torch.ops.kernels import iou_matching as im
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise
from tests.test_torch_mean_ap import _assert_margin, _assert_results_bitwise, _dataset, _torch_items, _updates

pytestmark = pytest.mark.filterwarnings("ignore")

WORLD = 4
H, W = 24, 32  # segm image size in these tests


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


# --------------------------------------------------------------------------- #
# the RLE codec
# --------------------------------------------------------------------------- #
def _masks(rng, n, h=17, w=23, p=0.35):
    out = rng.random((n, h, w)) < p
    if n >= 4:  # the edge cases: empty, full, first pixel only, last pixel only
        out[0], out[1] = False, True
        out[2], out[3] = False, False
        out[2, 0, 0] = out[3, -1, -1] = True
    return out


@pytest.mark.parametrize("compress", [False, True], ids=["uncompressed", "compressed"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (17, 23), (48, 64)], ids=str)
def test_rle_encode_and_decode_equal_the_jax_codec(compress, shape):
    masks = _masks(np.random.default_rng(shape[0] * 100 + shape[1]), 6, *shape)
    for mask in masks:
        got, want = trle.rle_encode(mask, compress=compress), jrle.rle_encode(mask, compress=compress)
        assert got == want
        np.testing.assert_array_equal(trle.rle_decode(want), jrle.rle_decode(want))
        np.testing.assert_array_equal(trle.rle_decode(got), mask)
    batch = trle.masks_from_rle_list([trle.rle_encode(m, compress=compress) for m in masks])
    assert batch.dtype == torch.bool
    np.testing.assert_array_equal(batch.numpy(), jrle.masks_from_rle_list([jrle.rle_encode(m) for m in masks]))


def test_rle_validation_and_empty_lists_match_jax():
    assert trle.is_rle({"size": [1, 1], "counts": [1]}) and not trle.is_rle({"counts": [1]})
    for bad in ({"counts": [4]}, {"size": [2, 2], "counts": [1, 2]}):
        with pytest.raises(ValueError) as got:
            trle.rle_decode(bad)
        with pytest.raises(ValueError) as want:
            jrle.rle_decode(bad)
        assert str(got.value) == str(want.value)
    assert tuple(trle.masks_from_rle_list([]).shape) == (0, 0, 0)
    with pytest.raises(ValueError, match="share a size"):
        trle.masks_from_rle_list([trle.rle_encode(np.ones((2, 2), bool)), trle.rle_encode(np.ones((3, 2), bool))])


# --------------------------------------------------------------------------- #
# mask ops and the matcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.bool_, np.float32, np.uint8])
def test_mask_iou_and_area_bitwise(dtype):
    rng = np.random.default_rng(7)
    m1, m2 = _masks(rng, 9).astype(dtype), _masks(rng, 5, p=0.5).astype(dtype)
    assert_bitwise(tboxes.mask_iou(torch.from_numpy(m1), torch.from_numpy(m2)),
                   np.asarray(jboxes.mask_iou(jnp.asarray(m1), jnp.asarray(m2))), "mask_iou")
    assert_bitwise(tboxes.mask_area(torch.from_numpy(m1)), np.asarray(jboxes.mask_area(jnp.asarray(m1))), "mask_area")
    empty = np.zeros((0, 17, 23), dtype)
    assert tuple(tboxes.mask_iou(torch.from_numpy(empty), torch.from_numpy(m2)).shape) == (0, 5)


@pytest.mark.parametrize("seed", range(6))
def test_match_image_bitwise_with_ties(seed):
    rng = np.random.default_rng(seed)
    k, a, t, d, g = (int(v) for v in rng.integers(1, [4, 5, 7, 14, 11]))
    ious = rng.choice(np.float32([0.0, 0.3, 0.5, 0.55, 0.7, 0.7, 0.9]), size=(d, g))  # ties on purpose
    dcv, gcv, gia = rng.random((k, d)) < 0.7, rng.random((k, g)) < 0.7, rng.random((a, g)) < 0.3
    thresholds = np.linspace(0.5, 0.95, t).astype(np.float32)
    want = jmatching.match_image(*map(jnp.asarray, (ious, dcv, gcv, gia, thresholds)))
    got = tmatching.match_image(*map(torch.from_numpy, (ious, dcv, gcv, gia, thresholds)))
    for name, x, y in zip(("det_matches", "gt_matches"), got, want):
        assert_bitwise(x, np.asarray(y), name)


def test_evaluate_given_ious_is_evaluate_matches_on_box_ious():
    preds, targets = _dataset(60, n_images=6)
    b, d, g = len(preds), 16, 8
    det = np.zeros((b, d, 4), np.float32)
    scores, labels = np.zeros((b, d), np.float32), np.full((b, d), -1, np.int32)
    gt, gt_labels = np.zeros((b, g, 4), np.float32), np.full((b, g), -1, np.int32)
    dn, gn = np.zeros(b, np.int32), np.zeros(b, np.int32)
    for i, (p, t) in enumerate(zip(preds, targets)):
        n, m = min(len(p["labels"]), d), min(len(t["labels"]), g)
        det[i, :n], scores[i, :n], labels[i, :n], dn[i] = p["boxes"][:n], p["scores"][:n], p["labels"][:n], n
        gt[i, :m], gt_labels[i, :m], gn[i] = t["boxes"][:m], t["labels"][:m], m
    consts = (torch.tensor([0, 1, 2, 0], dtype=torch.int32), torch.tensor([True, True, True, False]),
              torch.tensor([[0.0, 1e10], [0.0, 1024.0], [1024.0, 9216.0], [9216.0, 1e10]]),
              torch.linspace(0.5, 0.95, 10), 5)
    T = torch.from_numpy
    want = im.evaluate_matches(T(det), T(scores), T(labels), T(dn), T(gt), T(gt_labels), T(gn), *consts)
    ious = im.pairwise_iou(T(det), T(gt), T(dn), T(gn))
    got = im.evaluate_given_ious(ious, tboxes.box_area(T(det)), T(scores), T(labels), T(dn),
                                 tboxes.box_area(T(gt)), T(gt_labels), T(gn), *consts)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# --------------------------------------------------------------------------- #
# MeanAveragePrecision: the host-list bbox route
# --------------------------------------------------------------------------- #
def _run_lists(preds, targets, **kwargs):
    ref = JaxMAP(device_state=False, **kwargs)
    port = MeanAveragePrecision(device="cpu", device_state=False, **kwargs)
    for p, t in _updates(preds, targets):
        ref.update(p, t)
        port.update(_torch_items(p), _torch_items(t))
    return ref, port


def _assert_list_states(port, ref):
    for name in ("detections", "detection_scores", "detection_labels", "groundtruths", "groundtruth_labels"):
        got, want = getattr(port, name), getattr(ref, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert_bitwise(g, np.asarray(w), name)


@pytest.mark.parametrize("class_metrics", [False, True])
@pytest.mark.parametrize("box_format", ["xyxy", "xywh", "cxcywh"])
def test_host_list_bbox_route_matches_jax_and_the_device_route(box_format, class_metrics):
    preds, targets = _dataset(70 + ["xyxy", "xywh", "cxcywh"].index(box_format), n_images=16, fmt=box_format)
    empty = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)}
    preds[2] = {**empty, "scores": np.zeros(0, np.float32)}  # no detections
    targets[5] = dict(empty)  # no ground truths
    preds[9], targets[9] = dict(preds[2]), dict(empty)  # neither
    _assert_margin(preds, targets, box_format)
    ref, port = _run_lists(preds, targets, box_format=box_format, class_metrics=class_metrics)
    assert not port.supports_compiled_update and not port.device_state
    _assert_list_states(port, ref)
    got = port.compute()
    _assert_results_bitwise(got, ref.compute())
    device = MeanAveragePrecision(device="cpu", box_format=box_format, class_metrics=class_metrics)
    for p, t in _updates(preds, targets):
        device.update(_torch_items(p), _torch_items(t))
    for key, value in device.compute().items():
        assert torch.equal(got[key], value), key


def test_host_list_route_keeps_every_detection_past_the_device_capacity():
    preds, targets = _dataset(80, n_images=6, max_det=16)
    _assert_margin(preds, targets)
    ref, port = _run_lists(preds, targets, class_metrics=True)
    got = port.compute()
    _assert_results_bitwise(got, ref.compute())
    runs = {}
    for cap in (4, 16):
        device = MeanAveragePrecision(device="cpu", detections_capacity=cap, class_metrics=True)
        for p, t in _updates(preds, targets):
            device.update(_torch_items(p), _torch_items(t))
        runs[cap] = device.compute()
    assert max(len(p["labels"]) for p in preds) > 4
    assert all(torch.equal(got[k], v) for k, v in runs[16].items())
    assert any(not torch.equal(got[k], v) for k, v in runs[4].items())


def test_list_route_partition_is_the_jax_engines():
    port = MeanAveragePrecision(device="cpu", device_state=False)
    view = port.engine_stats()["partition"]
    assert view["update"] == {"path": "eager", "reason": "state unsupported by compiled update (unbounded list state)"}
    assert view["compute"] == {"path": "eager", "reason": "compute_state unsupported by compiled compute"}
    with pytest.raises(ValueError, match="requires `iou_type='bbox'`"):
        MeanAveragePrecision(device="cpu", iou_type="segm", device_state=True)


# --------------------------------------------------------------------------- #
# MeanAveragePrecision: segm
# --------------------------------------------------------------------------- #
def _segm_dataset(seed, n_images=10, h=H, w=W, rle=None):
    """Ellipse masks of an (h, w) image: three ground truths an image and
    five detections (jittered copies of the three, kept label with
    probability 0.8, and two random ellipses), one shape for every image, so
    the JAX package's per-image operations compile once; the ground truths
    as RLE dicts when ``rle`` is "compressed" or "uncompressed"."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w] + 0.5

    def masks(c):  # (n, 4): centre x, centre y, radius x, radius y
        return ((xs - c[:, 0, None, None]) / c[:, 2, None, None]) ** 2 + ((ys - c[:, 1, None, None]) / c[:, 3, None, None]) ** 2 <= 1

    sp, st = [], []
    for _ in range(n_images):
        gt = np.stack([rng.uniform(0, w, 3), rng.uniform(0, h, 3), rng.uniform(1, w / 3, 3), rng.uniform(1, h / 3, 3)], 1)
        labels = rng.integers(0, 3, 3).astype(np.int32)
        noise = np.stack([rng.uniform(0, w, 2), rng.uniform(0, h, 2), rng.uniform(1, w / 3, 2), rng.uniform(1, h / 3, 2)], 1)
        det = np.concatenate([gt + rng.normal(0, 1.0, gt.shape), noise])
        det[:, 2:] = np.maximum(det[:, 2:], 0.5)
        det_labels = np.concatenate([np.where(rng.random(3) < 0.8, labels, rng.integers(0, 3, 3)), rng.integers(0, 3, 2)])
        sp.append({"masks": masks(det), "scores": rng.random(5).astype(np.float32), "labels": det_labels.astype(np.int32)})
        st.append({"masks": masks(gt), "labels": labels})
    if rle is not None:
        for t in st:
            t["masks"] = [jrle.rle_encode(m, compress=rle == "compressed") for m in t["masks"]]
    return sp, st


def _segm_items(items):
    return [{k: (v if isinstance(v, list) else torch.from_numpy(np.array(v, copy=True))) for k, v in it.items()}
            for it in items]


def _segm_case(rle=None):
    preds, targets = _segm_dataset(90, n_images=8, rle=rle)
    preds[3] = {"masks": np.zeros((0, H, W), bool), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int32)}
    targets[6] = {"masks": np.zeros((0, H, W), bool), "labels": np.zeros(0, np.int32)}
    return preds, targets


@functools.lru_cache(maxsize=None)
def _jax_segm():
    """The JAX package's segm route on the dense masks (its RLE ingestion
    decodes to the same masks: test_rle_encode_and_decode_equal_the_jax_codec)."""
    preds, targets = _segm_case()
    ref = JaxMAP(iou_type="segm", class_metrics=True)
    for p, t in _updates(preds, targets):
        ref.update([{k: jnp.asarray(v) for k, v in d.items()} for d in p], [{k: jnp.asarray(v) for k, v in d.items()} for d in t])
    return ref, ref.compute()


@pytest.mark.parametrize("masks", ["dense", "compressed", "uncompressed"])
def test_segm_route_matches_jax(masks):
    preds, targets = _segm_case(None if masks == "dense" else masks)
    ref, want = _jax_segm()
    port = MeanAveragePrecision(device="cpu", iou_type="segm", class_metrics=True)
    for p, t in _updates(preds, targets):
        port.update(_segm_items(p), _segm_items(t))
    assert all(m.dtype == torch.bool for m in port.detections + port.groundtruths)
    _assert_list_states(port, ref)
    got = port.compute()
    _assert_results_bitwise(got, want)
    assert 0.0 < float(got["map"]) < 1.0


# --------------------------------------------------------------------------- #
# the list sync in the gloo world of 4
# --------------------------------------------------------------------------- #
def _single_process(per_rank, **kwargs):
    metric = MeanAveragePrecision(device="cpu", **kwargs)
    for calls in per_rank:
        for (p, t), _ in calls:
            metric.update(_segm_items(p), _segm_items(t))
    return metric.compute()


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_list_sync_is_rank_major_and_bitwise(world, iou_type):
    """Uneven ranks: 3, 0, 5 and 2 images (one rank holds none), segm masks
    of a different size on each rank; the synced compute on every rank equals
    one process fed every rank's images in rank order."""
    sizes, per_rank = (3, 0, 5, 2), []
    for rank, n in enumerate(sizes):
        if iou_type == "bbox":
            preds, targets = _dataset(100 + rank, n_images=max(n, 1))
            _assert_margin(preds, targets)
        else:
            preds, targets = _segm_dataset(100 + rank, n_images=max(n, 1), h=H + 4 * rank, w=W - 2 * rank,
                                           rle="compressed" if rank % 2 else None)
        per_rank.append([(((preds[i : i + 2], targets[i : i + 2]), {})) for i in range(0, n, 2)])
    if iou_type == "segm":  # the single process needs one image size: pad the dense masks to the largest
        hmax, wmax = H + 4 * (WORLD - 1), W
        for calls in per_rank:
            for (p, t), _ in calls:
                for item in p + t:
                    m = item["masks"] if not isinstance(item["masks"], list) else jrle.masks_from_rle_list(item["masks"])
                    m = m.reshape(-1, *m.shape[-2:]) if m.size else np.zeros((0, m.shape[-2] if m.ndim == 3 else 0, 0), bool)
                    item["padded"] = np.pad(m, ((0, 0), (0, hmax - m.shape[1]), (0, wmax - m.shape[2])))
        single = [[(([{**x, "masks": x["padded"]} for x in p], [{**x, "masks": x["padded"]} for x in t]), {})
                   for (p, t), _ in calls] for calls in per_rank]
        for calls in per_rank:
            for (p, t), _ in calls:
                for item in p + t:
                    del item["padded"]
    else:
        single = per_rank
    kwargs = dict(iou_type=iou_type, class_metrics=True)
    results = world.run(td.twin_synced_compute, [("MeanAveragePrecision", False, calls, kwargs) for calls in per_rank])
    want = _single_process(single, **kwargs)
    for rank, got in enumerate(results):
        for key, value in want.items():
            assert_bitwise(got[key], value.numpy(), f"rank {rank} {key}")


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_list_sync_in_a_world_of_one_runs_every_round(iou_type):
    """One gloo rank: the image-count exchange, then one gather round per
    image and list state (and the (H, W) exchange for masks); the synced
    compute equals the unsynced one."""
    import torch.distributed as dist

    from metrics_tpu_torch.parallel import sync

    if iou_type == "bbox":
        preds, targets = _dataset(120, n_images=4)
        _assert_margin(preds, targets)
    else:
        preds, targets = _segm_case()
    port = MeanAveragePrecision(device="cpu", iou_type=iou_type, device_state=False, class_metrics=True)
    for p, t in _updates(preds, targets):
        port.update(_segm_items(p), _segm_items(t))
    local = port.compute()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        port._computed = None
        with sync.count_collectives() as box, sync.sync_axes(dist.group.WORLD):
            synced = port.compute()
    finally:
        dist.destroy_process_group()
    rounds = 1 + 5 * len(preds) + (iou_type == "segm")
    assert box["by_kind"] == {"size_exchange": rounds, "all_gather": rounds}
    for key, value in local.items():
        assert_bitwise(synced[key], value.numpy(), key)
