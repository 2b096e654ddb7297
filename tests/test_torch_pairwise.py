"""The pairwise functionals of the port against the JAX package
(``metrics_tpu_torch/ops/pairwise``): cosine, euclidean, linear and
manhattan, with and without ``y``, every reduction and ``zero_diagonal``
both ways, a zero row (the 0/0 cosine on the diagonal is cleared) and half
precision inputs. Matrices are held within 1e-5 of the JAX package's and of
a float64 numpy computation, the JAX package's bound against its float64
reference (``tests/regression/test_pairwise.py:36``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.ops as ops_jax
import metrics_tpu_torch.ops as ops_torch
from tests.helpers.torch_port import assert_close, strict_float32

BOUND = 1e-5
NAMES = ("pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
         "pairwise_manhattan_distance")


@pytest.fixture(autouse=True)
def _no_tf32():
    strict_float32()


def _data(seed, n=12, m=9, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    x[2] = 0.0  # a zero row: its cosine is 0/0
    return x, y


def _float64(name, x, y, zero_diagonal):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "pairwise_cosine_similarity":
        with np.errstate(invalid="ignore", divide="ignore"):
            out = (x @ y.T) / (np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(y, axis=1)[None, :])
    elif name == "pairwise_euclidean_distance":
        out = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    elif name == "pairwise_linear_similarity":
        out = x @ y.T
    else:
        out = np.abs(x[:, None, :] - y[None, :, :]).sum(-1)
    if zero_diagonal:
        out[np.eye(*out.shape, dtype=bool)] = 0.0
    return out


@pytest.mark.parametrize("zero_diagonal", (None, True, False))
@pytest.mark.parametrize("with_y", (True, False))
@pytest.mark.parametrize("name", NAMES)
def test_matrix_against_jax_and_float64(name, with_y, zero_diagonal):
    x, y = _data(1)
    y_or_none = y if with_y else None
    want = getattr(ops_jax, name)(jnp.asarray(x), None if y_or_none is None else jnp.asarray(y),
                                  zero_diagonal=zero_diagonal)
    got = getattr(ops_torch, name)(torch.from_numpy(x), None if y_or_none is None else torch.from_numpy(y),
                                   zero_diagonal=zero_diagonal)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    got, want = got.numpy(), np.asarray(want)
    diag = (not with_y) if zero_diagonal is None else zero_diagonal
    oracle = _float64(name, x, y if with_y else x, diag)
    keep = np.ones(got.shape, dtype=bool)
    if name == "pairwise_euclidean_distance" and not with_y and not diag:
        # a kept self-distance is sqrt(|x|^2 + |x|^2 - 2 x.x): the square root
        # of a float32 rounding residue (a few ulp of 2|x|^2) in both packages
        keep = ~np.eye(*got.shape, dtype=bool)
        noise = np.sqrt(8 * np.finfo(np.float32).eps * (x.astype(np.float64) ** 2).sum(1))
        assert (np.abs(np.diag(got)) <= noise).all() and (np.abs(np.diag(want)) <= noise).all()
    assert_close(got[keep], want[keep], rtol=BOUND, atol=BOUND)
    assert_close(got[keep].astype(np.float64), oracle[keep], rtol=BOUND, atol=BOUND)


@pytest.mark.parametrize("reduction", ("mean", "sum", None, "none"))
@pytest.mark.parametrize("name", NAMES)
def test_reductions(name, reduction):
    x, y = _data(2)
    want = getattr(ops_jax, name)(jnp.asarray(x), jnp.asarray(y), reduction=reduction)
    got = getattr(ops_torch, name)(torch.from_numpy(x), torch.from_numpy(y), reduction=reduction)
    assert_close(got.numpy(), np.asarray(want), rtol=BOUND, atol=BOUND)


@pytest.mark.parametrize("name", NAMES)
def test_half_precision_inputs_are_computed_in_float32(name):
    x, y = _data(3)
    xh, yh = x.astype(np.float16), y.astype(np.float16)
    want = getattr(ops_jax, name)(jnp.asarray(xh), jnp.asarray(yh))
    got = getattr(ops_torch, name)(torch.from_numpy(xh), torch.from_numpy(yh))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), rtol=BOUND, atol=BOUND)


@pytest.mark.parametrize("name", NAMES)
def test_input_errors(name):
    fn = getattr(ops_torch, name)
    with pytest.raises(ValueError, match="2D tensor"):
        fn(torch.zeros(3))
    with pytest.raises(ValueError, match="same as the last dimension"):
        fn(torch.zeros(3, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="reduction"):
        fn(torch.zeros(3, 4), reduction="max")


def test_safe_matmul_half_precision_accumulates_in_float32():
    from metrics_tpu.utils.compute import safe_matmul as jax_safe_matmul
    from metrics_tpu_torch.utils.compute import safe_matmul

    rng = np.random.default_rng(4)
    a = rng.normal(size=(16, 64)).astype(np.float16)
    b = rng.normal(size=(64, 8)).astype(np.float16)
    got = safe_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_safe_matmul(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float16 and np.asarray(want).dtype == np.float16
    assert_close(got.numpy().astype(np.float32), np.asarray(want).astype(np.float32), rtol=1e-3, atol=1e-3)
