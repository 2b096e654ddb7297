"""The port's BERTScore matching against the JAX package's, on the CPU.

``metrics_tpu_torch.ops.kernels.cosine_matching`` runs its plain PyTorch
version here (CPU tensors); the CUDA kernel ``maxsim`` is held against that
plain version on the card by ``chip_smoke.py``.

Tolerance: rtol=1e-5, atol=1e-6 on precision, recall and F1, the JAX
package's own bound between its XLA reference and its Pallas body
(``tests/ops/test_heavy_kernels.py``). The similarity is a float32 sum over
D, and XLA and PyTorch sum it in different orders on the CPU, so the results
agree within rounding and not to the bit. Masked tokens give similarities
that are exact zeros of either sign; values, not bits, are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.kernels import cosine_matching as jax_cm
from metrics_tpu_torch.ops.kernels.cosine_matching import (
    MAXSIM_KERNEL,
    _pr_f1_reference,
    maxsim,
    maxsim_plain,
    pairwise_cosine_pr,
)
from tests.helpers.torch_port import assert_close

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(3, 1, 7, 5, 16), (2, 3, 9, 17, 40), (1, 1, 6, 4, 8), (5, 2, 33, 65, 48)]


def _embeddings(seed, b=3, l=1, p=7, r=5, d=16):
    """Normalised token embeddings and idf weights, made with numpy as in
    tests/ops/test_heavy_kernels.py."""
    rng = np.random.default_rng(seed)
    pe = rng.normal(size=(b, l, p, d)).astype(np.float32)
    te = rng.normal(size=(b, l, r, d)).astype(np.float32)
    pe /= np.linalg.norm(pe, axis=-1, keepdims=True)
    te /= np.linalg.norm(te, axis=-1, keepdims=True)
    pw = rng.uniform(0.1, 1, size=(b, p)).astype(np.float32)
    tw = rng.uniform(0.1, 1, size=(b, r)).astype(np.float32)
    return pe, te, pw, tw


def _port(args):
    return pairwise_cosine_pr(*(torch.from_numpy(np.array(a, copy=True)) for a in args))


def _jax(args, route):
    jargs = [jnp.asarray(a) for a in args]
    if route == "pallas_interpret":  # the Pallas body itself, with no fallback to XLA
        return jax_cm._pr_f1_pallas(*jargs, interpret=True)
    return jax_cm.pairwise_cosine_pr(*jargs, use_pallas="never")


def _assert_prf_close(got, want):
    for g, w, name in zip(got, want, ("precision", "recall", "f1")):
        assert_close(g, np.asarray(w), rtol=RTOL, atol=ATOL, msg=name)


@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_pr_f1_matches_jax(shape, route):
    args = _embeddings(sum(shape), *shape)
    got = _port(args)
    want = _jax(args, route)
    _assert_prf_close(got, want)
    b, l = shape[:2]
    expected = () if b == 1 and l == 1 else ((b,) if l == 1 else (l, b))
    assert tuple(got[0].shape) == expected and got[0].dtype == torch.float32


def test_single_pair_squeezes_to_a_scalar():
    got = _port(_embeddings(1, b=1, l=1, p=4, r=6, d=8))
    assert all(x.ndim == 0 for x in got)


def test_row_and_column_maxima_match_jax_pallas_body():
    """The maxima themselves, against the Pallas body's outputs."""
    pe, te, _, _ = _embeddings(11, b=2, l=3, p=9, r=17, d=40)
    rowmax, colmax = maxsim(torch.from_numpy(pe), torch.from_numpy(te))
    sim = np.einsum("blpd,blrd->blpr", pe.astype(np.float64), te.astype(np.float64))
    assert_close(rowmax, sim.max(axis=3).astype(np.float32), rtol=RTOL, atol=ATOL, msg="rowmax")
    assert_close(colmax, sim.max(axis=2).astype(np.float32), rtol=RTOL, atol=ATOL, msg="colmax")


@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
def test_nan_propagates_like_jax(route):
    pe, te, pw, tw = _embeddings(3, b=3, l=1, p=7, r=5, d=16)
    pe[1, 0, 2, 5] = np.nan  # every column of pair 1 and row 2 of it see a NaN
    te[2, 0, 4, 0] = np.nan
    rowmax, colmax = maxsim(torch.from_numpy(pe), torch.from_numpy(te))
    assert torch.isnan(rowmax[1, 0, 2]) and not torch.isnan(rowmax[1, 0, 3])
    assert torch.isnan(colmax[1]).all() and torch.isnan(rowmax[2]).all()
    assert not torch.isnan(rowmax[0]).any() and not torch.isnan(colmax[0]).any()
    got = _port((pe, te, pw, tw))
    want = _jax((pe, te, pw, tw), route)
    _assert_prf_close(got, want)
    # NaN precision and recall, F1 set to 0, as the JAX package does
    assert torch.isnan(got[0][1]) and torch.isnan(got[1][2]) and float(got[2][1]) == 0.0


@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
def test_zero_rows_floor_the_maxima_at_zero(route):
    """Masked (zeroed) tokens give similarities of exactly 0, which floor every
    maximum at 0: reference behaviour, kept. An all-zero pair scores 0."""
    pe, te, pw, tw = _embeddings(4, b=3, l=1, p=7, r=5, d=16)
    pe[:, :, 0] = 0.0
    pe[:, :, -1] = 0.0
    te[:, :, 0] = 0.0
    pe[2] = 0.0
    te[2] = 0.0
    pw[:, 0] = pw[:, -1] = 0.0
    rowmax, colmax = maxsim(torch.from_numpy(pe), torch.from_numpy(te))
    assert (rowmax >= 0).all() and (colmax >= 0).all()
    assert (rowmax[2] == 0).all() and (colmax[2] == 0).all()  # values: either sign of zero
    got = _port((pe, te, pw, tw))
    _assert_prf_close(got, _jax((pe, te, pw, tw), route))
    assert float(got[0][2]) == 0.0 and float(got[2][2]) == 0.0


def test_reference_and_dispatch_agree_on_cpu():
    args = [torch.from_numpy(a) for a in _embeddings(5, b=4, l=2, p=12, r=10, d=24)]
    before = MAXSIM_KERNEL.launches
    for g, w in zip(pairwise_cosine_pr(*args), _pr_f1_reference(*args)):
        assert torch.equal(g, w)
    assert MAXSIM_KERNEL.launches == before  # CPU tensors never reach the kernel
    for g, w in zip(maxsim(args[0], args[1]), maxsim_plain(args[0], args[1])):
        assert torch.equal(g, w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    pe, te, _, _ = (torch.from_numpy(a) for a in _embeddings(6))
    with pytest.raises(TypeError, match="float32"):
        maxsim(pe.to(torch.int32), te)
    with pytest.raises(TypeError, match="float32"):
        maxsim(pe, te.double())
    with pytest.raises(ValueError, match="contiguous"):
        maxsim(pe.transpose(2, 3).contiguous().transpose(2, 3), te)
    with pytest.raises(ValueError, match=r"\(B, L, P, D\)"):
        maxsim(pe[0], te[0])
    with pytest.raises(ValueError, match=r"\(B, L, P, D\)"):
        maxsim(pe, te[..., :8].contiguous())
    with pytest.raises(ValueError, match="at least one token"):
        maxsim(pe[:, :, :0], te)
    with pytest.raises(ValueError, match="lies on meta"):
        maxsim(pe, te.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        maxsim(pe.to("meta"), te.to("meta"))
