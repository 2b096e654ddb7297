"""The port's MeanAveragePrecision against the JAX package's, on the CPU.

Both packages take the same COCO list-of-dicts inputs, made with numpy from
a seed (numpy arrays for ``metrics_tpu``, CPU tensors for the port), over
three updates. The JAX side runs its default path, ``device_state=True``.
Every result is bitwise equal: the port's IoU equals the JAX package's eager
``box_iou`` bit for bit and lies within 4 ulp of its jitted one, and every
seeded case asserts first that every IoU lies more than 8 ulp from every
threshold, so no match can differ. Against the independent numpy oracle of
``tests/detection/oracle.py`` the tolerance is ``atol=1e-6``, as in
``tests/detection/test_map.py``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.core.buffers import CatBuffer as JaxCatBuffer
from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu_torch import Metric
from metrics_tpu_torch.convert import state_from_numpy, state_to_numpy
from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.ops.detection.boxes import box_convert
from metrics_tpu_torch.ops.kernels.iou_matching import pairwise_iou_plain
from tests.detection.oracle import coco_map
from tests.helpers.torch_port import COCO_IOU_THRESHOLDS, assert_bitwise, assert_iou_margin, coco_dataset

N_UPDATES = 3


def _to_format(boxes: np.ndarray, fmt: str) -> np.ndarray:
    x1, y1, x2, y2 = np.split(boxes, 4, axis=-1)
    if fmt == "xywh":
        return np.concatenate([x1, y1, x2 - x1, y2 - y1], axis=-1)
    if fmt == "cxcywh":
        return np.concatenate([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], axis=-1)
    return boxes


def _dataset(seed: int, n_images: int = 12, fmt: str = "xyxy", **kwargs):
    preds, targets = coco_dataset(np.random.default_rng(seed), n_images, **kwargs)
    for item in preds + targets:
        item["boxes"] = _to_format(item["boxes"], fmt).astype(np.float32)
    return preds, targets


def _torch_items(items):
    return [{k: torch.from_numpy(np.array(v, copy=True)) for k, v in it.items()} for it in items]


def _updates(preds, targets, n=N_UPDATES):
    step = -(-len(preds) // n)
    return [(preds[i : i + step], targets[i : i + step]) for i in range(0, len(preds), step)]


def _assert_margin(preds, targets, fmt="xyxy", thresholds=COCO_IOU_THRESHOLDS):
    """The seed's precondition: no IoU the metrics see lies within 8 ulp of a threshold."""
    for p, t in zip(preds, targets):
        if len(p["boxes"]) and len(t["boxes"]):
            det = box_convert(torch.from_numpy(p["boxes"]), fmt, "xyxy")
            gt = box_convert(torch.from_numpy(t["boxes"]), fmt, "xyxy")
            ious = pairwise_iou_plain(det[None], gt[None]).numpy()
            assert_iou_margin(ious, np.ones_like(ious, bool), thresholds)


def _run_both(preds, targets, **kwargs):
    jax_metric = JaxMAP(**kwargs)
    port_metric = MeanAveragePrecision(device="cpu", **kwargs)
    for p, t in _updates(preds, targets):
        jax_metric.update(p, t)
        port_metric.update(_torch_items(p), _torch_items(t))
    return port_metric, port_metric.compute(), jax_metric.compute()


def _assert_results_bitwise(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        assert_bitwise(got[key], np.asarray(want[key]), msg=key)


@pytest.mark.parametrize("class_metrics", [False, True])
@pytest.mark.parametrize("box_format", ["xyxy", "xywh", "cxcywh"])
def test_results_bitwise_equal_the_jax_package(box_format, class_metrics):
    preds, targets = _dataset(10 + ["xyxy", "xywh", "cxcywh"].index(box_format), fmt=box_format)
    _assert_margin(preds, targets, box_format)
    _, got, want = _run_both(preds, targets, box_format=box_format, class_metrics=class_metrics)
    _assert_results_bitwise(got, want)
    assert 0.0 < float(got["map"]) < 1.0
    if class_metrics:
        assert got["map_per_class"].shape == (3,)


def test_custom_thresholds_bitwise():
    preds, targets = _dataset(20)
    iou_thresholds = [0.3, 0.5, 0.7]
    _assert_margin(preds, targets, thresholds=np.float32(iou_thresholds))
    _, got, want = _run_both(
        preds, targets, iou_thresholds=iou_thresholds, max_detection_thresholds=[1, 5, 20],
        rec_thresholds=np.linspace(0, 1, 11).tolist(), class_metrics=True,
    )
    _assert_results_bitwise(got, want)
    assert float(got["map_75"]) == -1.0 and "mar_20" in got


def test_empty_images_and_labels_only_in_ground_truth():
    preds, targets = _dataset(30)
    empty_boxes = np.zeros((0, 4), np.float32)
    preds[1] = {"boxes": empty_boxes, "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int32)}
    targets[1] = {"boxes": empty_boxes, "labels": np.zeros(0, np.int32)}
    preds[4] = dict(preds[1])
    targets[7] = {"boxes": np.float32([[5, 5, 60, 70]]), "labels": np.int32([5])}  # class 5: no detection
    _assert_margin(preds, targets)
    _, got, want = _run_both(preds, targets, class_metrics=True)
    _assert_results_bitwise(got, want)
    assert got["map_per_class"].shape == (4,) and float(got["map_per_class"][-1]) == 0.0


def test_more_detections_than_capacity_keeps_the_same_rows_and_warns():
    preds, targets = _dataset(40, max_det=16)
    preds[2] = {k: v for k, v in preds[2].items()}
    assert len(preds[2]["labels"]) > 8
    _assert_margin(preds, targets)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port_metric, got, want = _run_both(preds, targets, detections_capacity=8, groundtruths_capacity=4)
    messages = [str(w.message) for w in caught]
    for text in ("above `detections_capacity=8`; keeping the top 8 by score",
                 "above `groundtruths_capacity=4`; truncating"):
        hits = [m for m in messages if text in m]
        assert len(hits) >= 2 and len(hits) % 2 == 0, (text, messages)  # once from each package
    _assert_results_bitwise(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_results_agree_with_the_numpy_oracle(seed):
    preds, targets = _dataset(50 + seed)
    _assert_margin(preds, targets)
    metric = MeanAveragePrecision(device="cpu")
    for p, t in _updates(preds, targets):
        metric.update(_torch_items(p), _torch_items(t))
    got = metric.compute()
    for key, value in coco_map(preds, targets).items():
        np.testing.assert_allclose(float(got[key]), value, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("fmt", ["xyxy", "cxcywh"])
def test_padded_dense_dict_bitwise_equals_jax_pad_inputs(fmt):
    preds, targets = _dataset(60, n_images=6, fmt=fmt, max_det=16, max_gt=8)
    preds[0] = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_dense = JaxMAP(box_format=fmt, detections_capacity=8, groundtruths_capacity=4).pad_inputs(preds, targets)
        port = MeanAveragePrecision(device="cpu", box_format=fmt, detections_capacity=8, groundtruths_capacity=4)
        port_dense = port.pad_inputs(_torch_items(preds), _torch_items(targets))
    for got, want in zip(port_dense, jax_dense):
        assert set(got) == set(want)
        for key in want:
            assert_bitwise(got[key], np.asarray(want[key]), msg=key)


def test_dense_dict_update_equals_list_update():
    preds, targets = _dataset(61, n_images=5)
    by_list = MeanAveragePrecision(device="cpu")
    by_list.update(_torch_items(preds), _torch_items(targets))
    by_dict = MeanAveragePrecision(device="cpu")
    by_dict.update(*by_dict.pad_inputs(_torch_items(preds), _torch_items(targets)))
    for name, value in state_to_numpy(by_list).items():
        assert_bitwise(state_to_numpy(by_dict)[name], value, msg=name)


def test_state_carries_from_jax_into_the_port():
    preds, targets = _dataset(70)
    (p1, t1), (p2, t2), _ = _updates(preds, targets)
    _assert_margin(preds[: len(p1) + len(p2)], targets[: len(t1) + len(t2)])
    jax_metric = JaxMAP()
    jax_metric.update(p1, t1)
    port_metric = MeanAveragePrecision(device="cpu")
    arrays = {name: np.asarray(getattr(jax_metric, name).to_array()) for name in port_metric._defaults}
    state_from_numpy(port_metric, arrays)
    for name, value in state_to_numpy(port_metric).items():
        assert_bitwise(value, arrays[name], msg=name)
    jax_metric.update(p2, t2)
    port_metric.update(_torch_items(p2), _torch_items(t2))
    _assert_results_bitwise(port_metric.compute(), jax_metric.compute())
    with pytest.raises(ValueError, match="det_boxes"):
        state_from_numpy(port_metric, {**arrays, "det_boxes": arrays["det_boxes"][:, :, :2]})


def test_cat_buffer_growth_and_merge_match_the_jax_buffer():
    rng = np.random.default_rng(80)
    batches = [rng.normal(size=(n, 3)).astype(np.float32) for n in (2, 5, 1, 9)]
    port, jax_buf = CatBuffer.empty(4), JaxCatBuffer.empty(4)
    for x in batches:
        port.append(torch.from_numpy(x))
        jax_buf.append(jnp.asarray(x))
        assert (port.capacity, len(port)) == (jax_buf.capacity, len(jax_buf))
        assert_bitwise(port.data, np.asarray(jax_buf.data))
    other_port = CatBuffer.from_array(torch.from_numpy(batches[1]), capacity=8)
    other_jax = JaxCatBuffer.from_array(jnp.asarray(batches[1]), capacity=8)
    merged_port, merged_jax = port.merge(other_port), jax_buf.merge(other_jax)
    assert (merged_port.capacity, len(merged_port)) == (merged_jax.capacity, len(merged_jax))
    assert_bitwise(merged_port.to_array(), np.asarray(merged_jax.to_array()))
    assert_bitwise((port + [torch.from_numpy(batches[0])]).to_array(), np.asarray((jax_buf + [jnp.asarray(batches[0])]).to_array()))
    assert len(port) == 17  # merging and adding leave the operands as they were
    assert merged_port.data.data_ptr() != port.data.data_ptr()


class _CatMetric(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("values", [], dist_reduce_fx="cat", persistent=True)

    def update(self, x):
        self.values.append(x)

    def compute(self):
        return self.values.to_array().sum()


def test_buffer_capacity_promotes_cat_states_and_reset_copies():
    metric = _CatMetric(device="cpu", buffer_capacity=4)
    assert isinstance(metric.values, CatBuffer) and metric.values.capacity == 4
    metric.update(torch.arange(6.0))
    assert metric.values.capacity == 8 and float(metric.compute()) == 15.0
    assert not metric._defaults["values"].materialized  # the default is untouched
    saved = metric.state_dict()
    assert_bitwise(saved["values"], np.arange(6.0, dtype=np.float32))
    metric.reset()
    assert len(metric.values) == 0 and metric.values is not metric._defaults["values"]
    metric.load_state_dict(saved)
    assert len(metric.values) == 6
    # forward merges a batch state into the global one (the cat branch of merge_states)
    batch_value = metric(torch.tensor([1.0, 2.0]))
    assert float(batch_value) == 3.0 and float(metric.compute()) == 18.0
    # the pure protocol leaves the state it is given as it was
    state = metric.get_state()
    new_state = metric.update_state(state, torch.tensor([4.0]))
    assert len(state["values"]) == 8 and len(new_state["values"]) == 9
    with pytest.raises(ValueError, match="positive int"):
        _CatMetric(device="cpu", buffer_capacity=0)


def test_map_reset_never_shares_the_default_storage():
    preds, targets = _dataset(81, n_images=3)
    metric = MeanAveragePrecision(device="cpu", buffer_capacity=4)
    metric.update(_torch_items(preds), _torch_items(targets))
    assert len(metric.det_boxes) == 3 and len(metric._defaults["det_boxes"]) == 0
    metric.reset()
    assert metric.det_boxes.data.data_ptr() != metric._defaults["det_boxes"].data.data_ptr()
    metric.update(_torch_items(preds), _torch_items(targets))
    assert not metric._defaults["det_boxes"].data.any()


def test_inputs_on_another_device_raise_inside_lists_of_dicts():
    metric = MeanAveragePrecision(device="cpu")
    preds = [{"boxes": torch.zeros((1, 4), device="meta"), "scores": torch.zeros(1), "labels": torch.zeros(1, dtype=torch.int32)}]
    targets = [{"boxes": torch.zeros((1, 4)), "labels": torch.zeros(1, dtype=torch.int32)}]
    with pytest.raises(ValueError, match="an input lies on meta"):
        metric.update(preds, targets)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="segm"):
        MeanAveragePrecision(device="cpu", iou_type="segm")
    with pytest.raises(NotImplementedError, match="device_state=False"):
        MeanAveragePrecision(device="cpu", device_state=False)
    with pytest.raises(ValueError, match="iou_type"):
        MeanAveragePrecision(device="cpu", iou_type="keypoints")
    with pytest.raises(ValueError, match="box_format"):
        MeanAveragePrecision(device="cpu", box_format="yxyx")
    with pytest.raises(ValueError, match="same length"):
        MeanAveragePrecision(device="cpu").update([], [{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0)}])
