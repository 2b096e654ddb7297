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
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric, StateDict, resolve_device

Arrays = Mapping[str, np.ndarray]


def _metric_state_from_numpy(metric: Metric, arrays: Arrays, device: torch.device) -> StateDict:
    if set(arrays) != set(metric._defaults):
        raise ValueError(
            f"{type(metric).__name__} has states {sorted(metric._defaults)}, got arrays for {sorted(arrays)}"
        )
    state: StateDict = {}
    for name, default in metric._defaults.items():
        if isinstance(default, list):
            raise ValueError(f"{type(metric).__name__}.{name} is a list state; only tensor states convert")
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
    return {
        name: (value.to_array() if isinstance(value, CatBuffer) else value).detach().cpu().numpy()
        for name, value in metric.get_state().items()
    }
