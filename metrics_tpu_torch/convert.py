"""Carry metric state across the two packages as numpy arrays.

The metrics have no weights; their state plays that role. A JAX metric's
``init_state()`` / ``update_state()`` output (a dict of arrays, or for a
``MetricCollection`` a dict of such dicts keyed by group leader) converts to
numpy with ``np.asarray`` and loads here, so one stream of batches can start
in ``metrics_tpu`` and continue in ``metrics_tpu_torch``; ``state_to_numpy``
goes the other way. Dtype and shape are checked against the port metric's
registered defaults, so an int64 or float64 array never slips into int32 or
float32 state.

A ``CatBuffer`` state travels as its valid rows: on the JAX side that is
``np.asarray(buf.to_array())``. It loads into a port buffer of capacity
``max(default capacity, rows)``, with its dtype and item shape checked.

A ``cat`` list state (BERTScore's token batches) travels as a list of numpy
arrays, one per update: on the JAX side ``[np.asarray(x) for x in state]``.
Each must be int32 or float32, what the JAX package keeps with x64 off.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric, StateDict, resolve_device

Arrays = Mapping[str, Union[np.ndarray, Sequence[np.ndarray]]]
_LIST_DTYPES = (np.dtype(np.int32), np.dtype(np.float32))


def _metric_state_from_numpy(metric: Metric, arrays: Arrays, device: torch.device) -> StateDict:
    if set(arrays) != set(metric._defaults):
        raise ValueError(
            f"{type(metric).__name__} has states {sorted(metric._defaults)}, got arrays for {sorted(arrays)}"
        )
    state: StateDict = {}
    for name, default in metric._defaults.items():
        if isinstance(default, list):
            state[name] = _list_from_numpy(metric, name, arrays[name], device)
            continue
        arr = np.asarray(arrays[name])
        if isinstance(default, CatBuffer):
            state[name] = _buffer_from_numpy(metric, name, default, arr, device)
            continue
        want = torch.empty((), dtype=default.dtype).numpy().dtype
        if arr.dtype != want or tuple(arr.shape) != tuple(default.shape):
            raise ValueError(
                f"{type(metric).__name__}.{name}: expected {want} {tuple(default.shape)}, "
                f"got {arr.dtype} {tuple(arr.shape)}"
            )
        state[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return state


def _list_from_numpy(metric: Metric, name: str, arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    if not isinstance(arrays, (list, tuple)):
        raise ValueError(f"{type(metric).__name__}.{name} is a list state: pass a list of arrays, one per update")
    out = []
    for i, item in enumerate(arrays):
        arr = np.asarray(item)
        if arr.dtype not in _LIST_DTYPES:
            raise ValueError(f"{type(metric).__name__}.{name}[{i}]: expected int32 or float32, got {arr.dtype}")
        out.append(torch.from_numpy(np.array(arr, copy=True)).to(device))
    return out


def _buffer_from_numpy(metric: Metric, name: str, default: CatBuffer, arr: np.ndarray, device: torch.device) -> CatBuffer:
    if default.materialized:
        want = torch.empty((), dtype=default.data.dtype).numpy().dtype
        if arr.dtype != want or tuple(arr.shape[1:]) != default.item_shape:
            raise ValueError(
                f"{type(metric).__name__}.{name}: expected rows of {want} {default.item_shape}, "
                f"got {arr.dtype} {tuple(arr.shape[1:])}"
            )
    return CatBuffer.from_array(torch.from_numpy(np.array(arr, copy=True)).to(device), capacity=default.capacity)


def state_from_numpy(
    metric: Union[Metric, MetricCollection],
    arrays: Mapping[str, Union[np.ndarray, Arrays]],
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Load numpy state into ``metric`` and return it as tensors.

    ``device`` defaults to the metric's own; naming another raises, since a
    metric's state lives on one device.
    """
    if isinstance(metric, MetricCollection):
        out = {}
        for group in metric.compute_groups.values():
            leader = metric[group[0]]
            state = _metric_state_from_numpy(leader, arrays[group[0]], _target_device(leader, device))
            for name in group:
                metric[name].set_state(state)
                metric[name]._computed = None
            out[group[0]] = state
        return out
    state = _metric_state_from_numpy(metric, arrays, _target_device(metric, device))
    metric.set_state(state)
    metric._computed = None
    return state


def _target_device(metric: Metric, device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is not None and resolve_device(device) != metric.device:
        raise ValueError(f"{type(metric).__name__} keeps its state on {metric.device}, not {device}")
    return metric.device


def state_to_numpy(metric: Union[Metric, MetricCollection]) -> Dict:
    """The current state as numpy arrays (per group leader for a collection)."""
    if isinstance(metric, MetricCollection):
        return {g[0]: state_to_numpy(metric[g[0]]) for g in metric.compute_groups.values()}
    out: Dict = {}
    for name, value in metric.get_state().items():
        if isinstance(value, list):
            out[name] = [v.detach().cpu().numpy() for v in value]
        else:
            out[name] = (value.to_array() if isinstance(value, CatBuffer) else value).detach().cpu().numpy()
    return out


# --------------------------------------------------------------------------- #
# network weights: the JAX package's flax variables as the port's state dicts
# --------------------------------------------------------------------------- #
def _flat_paths(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat_paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def inception_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's InceptionV3 state dict from the JAX package's variables
    (``{"params": ..., "batch_stats": ...}`` with numpy leaves: pass
    ``jax.tree.map(np.asarray, variables)``); the inverse of
    ``metrics_tpu.nets.inception.load_inception_torch_state_dict``. A kernel
    ``(kh, kw, I, O)`` becomes a weight ``(O, I, kh, kw)``; ``scale``,
    ``bias``, ``mean`` and ``var`` become ``weight``, ``bias``,
    ``running_mean`` and ``running_var``; ``fc_kernel`` becomes ``fc.weight``
    transposed. The result is checked by the port's loader, so it loads with
    ``load_state_dict`` as it is."""
    from metrics_tpu_torch.nets.inception import load_inception_torch_state_dict

    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flat_paths(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            if path == ("fc_kernel",):
                out["fc.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
            elif path == ("fc_bias",):
                out["fc.bias"] = torch.from_numpy(arr.copy())
            else:
                if path[-1] == "kernel":
                    arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
                out[".".join(path[:-1] + (names[path[-1]],))] = torch.from_numpy(np.array(arr, copy=True))
    return load_inception_torch_state_dict(out)


def lpips_state_dict_from_jax(variables: Mapping, net_type: str = "alex") -> Dict[str, torch.Tensor]:
    """The port's LPIPS state dict from the JAX package's variables (numpy
    leaves); the inverse of ``metrics_tpu.nets.lpips.load_lpips_torch_state_dict``:
    the trunk's named convolutions go to torchvision's ``features.N`` slots,
    each head ``lin<k>`` (C,) to ``lin<k>.model.1.weight`` (1, C, 1, 1)."""
    from metrics_tpu_torch.nets import lpips as lp

    params = variables["params"]
    trunk = params["net"]
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, conv: Mapping) -> None:
        out[f"net.features.{key}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(conv["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)))
        out[f"net.features.{key}.bias"] = torch.from_numpy(np.array(conv["bias"], dtype=np.float32, copy=True))

    if net_type == "squeeze":
        put("0", trunk["conv1"]["conv"])
        for idx, fire in zip(lp.SQUEEZE_FIRE_IDX, (f"fire{i}" for i in range(2, 10))):
            for sub in ("squeeze", "expand1x1", "expand3x3"):
                put(f"{idx}.{sub}", trunk[fire][sub]["conv"])
    else:
        conv_names = {
            "alex": [f"conv{i}" for i in range(1, 6)],
            "vgg": ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
                    "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3"],
        }[net_type]
        indices = lp.ALEX_CONV_IDX if net_type == "alex" else lp.VGG16_CONV_IDX
        for idx, name in zip(indices, conv_names):
            put(str(idx), trunk[name]["conv"])
    for k in range(len(lp.NET_CHANNELS[net_type])):
        w = np.asarray(params[f"lin{k}"], dtype=np.float32)
        out[f"lin{k}.model.1.weight"] = torch.from_numpy(w.reshape(1, -1, 1, 1).copy())
    return lp._check_state_dict(lp.LPIPS(net_type), out)
