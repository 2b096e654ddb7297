"""Classification input validation and the format-canonicalization machine.

Counterpart of ``metrics_tpu/utils/checks.py:81-405``. Each value check
(label ranges, binary targets) reads a scalar back from the device. The JAX
package skips them under ``jit`` tracing; the port skips them where
:func:`_capturing` holds: while a CUDA graph is being captured, and while the
compiled engines (``core/engine.py``) probe a step or run it in the steady
state. So they fire on the first, eager call of each input shape. Shape and
dtype checks always run, and so do the places that infer a class count from
the values: a compiled step cannot freeze that branch, and the engine's probe
sends such a step back to eager.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType


_CUDA_BUILD = torch.cuda._is_compiled()
_state = threading.local()


@contextmanager
def _checks_off() -> Iterator[None]:
    """Skip the value checks in this thread for the block (the engines' probe
    and steady-state steps)."""
    depth = getattr(_state, "depth", 0)
    _state.depth = depth + 1
    try:
        yield
    finally:
        _state.depth = depth


def _capturing() -> bool:
    """True while value checks must not read the device: under a CUDA graph
    capture on the current stream, or inside :func:`_checks_off`. The
    counterpart of the JAX package's ``_tracing_active``/``_is_concrete``."""
    if getattr(_state, "depth", 0):
        return True
    return _CUDA_BUILD and torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _is_floating(x: Tensor) -> bool:
    return x.is_floating_point()


def _check_for_empty_tensors(preds: Tensor, target: Tensor) -> bool:
    return preds.numel() == 0 and target.numel() == 0


def _check_arg_choice(value, name: str, allowed) -> None:
    """Raise if ``value`` is not one of ``allowed``."""
    if value not in allowed:
        raise ValueError(f"`{name}` must be one of {tuple(allowed)}; got {value!r}.")


def _check_positive_int(value, name: str) -> None:
    """Raise if ``value`` is not a positive python int."""
    if not (isinstance(value, int) and not isinstance(value, bool) and value > 0):
        raise ValueError(f"`{name}` must be a positive integer; got {value!r}.")


def _check_avg_args(average, mdmc_average, num_classes, ignore_index) -> None:
    """Shared average/mdmc_average/num_classes/ignore_index validation.

    A negative ``ignore_index`` is allowed: it selects the masked-rows path
    of ``_stat_scores_update``, so only the upper bound is enforced."""
    _check_arg_choice(average, "average", ("micro", "macro", "weighted", "samples", "none", None))
    _check_arg_choice(mdmc_average, "mdmc_average", (None, "samplewise", "global"))
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"average={average!r} requires `num_classes` to be set to a positive integer.")
    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(
            f"`ignore_index` {ignore_index} is out of range for {num_classes} classes "
            "(needs ignore_index < num_classes and num_classes > 1)."
        )


def _basic_input_validation(
    preds: Tensor, target: Tensor, threshold: float, multiclass: Optional[bool], ignore_index: Optional[int]
) -> None:
    """Case-independent validation."""
    if _check_for_empty_tensors(preds, target):
        return
    if _is_floating(target):
        raise ValueError("`target` must hold integer (or boolean) labels, not floats.")

    if preds.shape[0:1] != target.shape[0:1]:
        raise ValueError("`preds` and `target` must agree in their leading (batch) dimension.")

    if _capturing():
        return  # value checks would read the device back
    if (ignore_index is None or ignore_index >= 0) and target.min() < 0:
        raise ValueError("Negative labels found in `target`; labels must be non-negative here.")
    if not _is_floating(preds) and preds.min() < 0:
        raise ValueError("Integer `preds` must be non-negative.")
    if multiclass is False and target.max() > 1:
        raise ValueError("`multiclass=False` requires binary `target` values (0 or 1).")
    if multiclass is False and not _is_floating(preds) and preds.max() > 1:
        raise ValueError("`multiclass=False` with integer `preds` requires binary prediction values (0 or 1).")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    """Classify the input case from shapes/dtypes; returns (case, implied classes)."""
    preds_float = _is_floating(preds)

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "Equal-rank `preds` and `target` must have identical shapes;"
                f" got preds={tuple(preds.shape)}, target={tuple(target.shape)}."
            )
        if preds_float and target.numel() > 0 and not _capturing() and target.max() > 1:
            raise ValueError(
                "Float `preds` at the same rank as `target` imply a binary/multi-label task, so `target` may only hold 0/1."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = math.prod(preds.shape[1:]) if preds.numel() > 0 else 0

    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("An extra class dimension on `preds` only makes sense for float (probability/logit) predictions.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "When `preds` carries a class dimension, the shapes must line up as"
                " preds (N, C, ...) against target (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Unsupported rank combination: expected `preds`/`target` both shaped (N, ...), or"
            " `preds` shaped (N, C, ...) with `target` shaped (N, ...)."
        )
    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Binary data detected, yet `num_classes` exceeds 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Binary data with `num_classes=2` only makes sense together with `multiclass=True`"
            " (which lifts binary inputs to 2-class multi-class format)."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "Binary data with `multiclass=True` needs two classes, but `num_classes` is 1."
            " Leave `multiclass=None` (default) or pass `num_classes=2` to lift binary"
            " data to multi-class format."
        )


def _check_num_classes_mc(
    preds: Tensor, target: Tensor, num_classes: int, multiclass: Optional[bool], implied_classes: int
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "`num_classes=1` with integer predictions is ambiguous. To fold 2-class"
            " (multi-dim) multi-class data down to binary/multi-label, pass `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "With `multiclass=False` the class count implied by the input shapes"
                " must equal `num_classes`, but it does not."
            )
        if target.numel() > 0 and not _capturing() and num_classes <= target.max():
            raise ValueError("`target` contains a label >= `num_classes`.")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The class (C) dimension of `preds` disagrees with `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "Multi-label data with `multiclass=True` lifts to exactly 2 classes, so"
            " `num_classes` must be 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The class count implied by the input shapes disagrees with `num_classes`.")


def _check_top_k(top_k: int, case: DataType, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("`top_k` is meaningless for binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("`top_k` must be a positive integer.")
    if not preds_float:
        raise ValueError("`top_k` requires float (probability/logit) predictions.")
    if multiclass is False:
        raise ValueError("`top_k` cannot be combined with `multiclass=False`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "`top_k` cannot be combined with lifting multi-label data to 2-class"
            " multi-class via `multiclass=True`."
        )
    if top_k >= implied_classes:
        raise ValueError("`top_k` must be strictly smaller than the class (C) dimension of `preds`.")


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Full input validation; returns the detected case."""
    _basic_input_validation(preds, target, threshold, multiclass, ignore_index)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "`multiclass=False` requires at most 2 classes, but the class (C) dimension"
                " of `preds` implies more."
            )
        if target.numel() > 0 and not _capturing() and target.max() >= implied_classes:
            raise ValueError("`target` contains a label >= the class (C) dimension of `preds`.")

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, _is_floating(preds))
    return case


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove size-1 dims (except a size-1 batch dim)."""
    if preds.shape[0] == 1:
        return preds.squeeze().unsqueeze(0), target.squeeze().unsqueeze(0)
    return preds.squeeze(), target.squeeze()


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalize ``(preds, target)`` to int32 binary ``(N, C)`` / ``(N, C, X)``.

    Same case semantics as ``metrics_tpu.utils.checks._input_format_classification``:

    - binary: preds thresholded, returned ``(N, 1)``; with ``multiclass=True``
      one-hot to ``(N, 2)``.
    - multi-class: one-hot/top-k select to ``(N, C)``; ``multiclass=False``
      keeps the positive-class column as ``(N, 1)``.
    - multi-label: threshold (or top-k) to ``(N, C)`` with trailing dims
      flattened; ``multiclass=True`` lifts to ``(N, 2, C)``.
    - multi-dim multi-class: one-hot/top-k to ``(N, C, X)``.
    """
    preds, target = _input_squeeze(preds, target)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    case = _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes,
        multiclass=multiclass, top_k=top_k, ignore_index=ignore_index,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32) if _is_floating(preds) else preds.to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if _is_floating(preds):
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if not num_classes:
                num_classes = int(max(preds.max(), target.max())) + 1
            preds = to_onehot(preds, max(2, num_classes))
        target = to_onehot(target, max(2, int(num_classes)))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if not _check_for_empty_tensors(preds, target):
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case
