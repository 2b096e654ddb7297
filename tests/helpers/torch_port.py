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


def both(x: np.ndarray):
    """The same numpy array as a JAX array and as a CPU tensor."""
    return jnp.asarray(x), torch.from_numpy(np.array(x, copy=True))
