"""Perceptual Evaluation of Speech Quality (PESQ, ITU-T P.862; counterpart
of ``metrics_tpu/ops/audio/pesq.py``).

Two backends, as in the JAX package:

- ``implementation="pesq"`` (default): the ``pesq`` C extension, one sample
  at a time on the host, with the same availability gate: without the
  extension the call raises ``ModuleNotFoundError``.
- ``implementation="native"``: the perceptual model of ``pesq_native.py`` on
  the input's device, batched, with no extension.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_arg_choice, _check_same_shape
from metrics_tpu_torch.utils.imports import package_available

_PESQ_AVAILABLE = package_available("pesq")


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    implementation: str = "pesq",
) -> Tensor:
    """PESQ MOS of each ``[..., time]`` pair: through the ``pesq`` C extension
    on the host (a float32 CPU tensor, moved to the input's device when
    ``keep_same_device``), or the native model (``implementation="native"``,
    on the input's device).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import perceptual_evaluation_speech_quality
        >>> t = torch.arange(16000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.1 * torch.sin(2 * torch.pi * 1234 * t)
        >>> score = perceptual_evaluation_speech_quality(preds, target, 8000, "nb", implementation="native")
        >>> round(float(score), 2)
        4.25
    """
    _check_arg_choice(implementation, "implementation", ("pesq", "native"))
    if implementation == "native":
        from metrics_tpu_torch.ops.audio.pesq_native import pesq_native

        return pesq_native(preds, target, fs, mode)
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install metrics-tpu[audio]`"
            " or `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if fs == 8000 and mode == "wb":
        raise ValueError("Expected argument `mode` to be 'nb' for a 8000Hz signal")
    _check_same_shape(preds, target)

    import pesq as pesq_backend

    preds_np = preds.detach().to(torch.float32).cpu().numpy()
    target_np = target.detach().to(torch.float32).cpu().numpy()
    if preds_np.ndim == 1:
        vals = np.asarray(pesq_backend.pesq(fs, target_np, preds_np, mode))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        vals = np.asarray([pesq_backend.pesq(fs, t, p, mode) for t, p in zip(flat_t, flat_p)]).reshape(
            preds_np.shape[:-1]
        )
    out = torch.from_numpy(np.asarray(vals, dtype=np.float32))
    if keep_same_device:
        out = out.to(preds.device)
    return out
