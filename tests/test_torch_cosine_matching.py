"""The port's BERTScore matching against the JAX package's, on the CPU.

``metrics_tpu_torch.ops.kernels.cosine_matching`` runs its plain PyTorch
version here (CPU tensors); its CUDA kernel (3xTF32 on the tensor cores, fed
by TMA) is held against that plain version on the card by ``chip_smoke.py``.
What the CPU can check of its wrapper is here too: which operands TMA
describes as they are, and the padded copies made of the others. Two design
notes emulate the kernel's 3xTF32 arithmetic in numpy.

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
    _tma_operands,
    _tma_route,
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


# --------------------------------------------------------------------------- #
# TMA needs 16-byte row strides and bases; other operands are padded copies
# --------------------------------------------------------------------------- #
def _normal(gen, *shape):
    return torch.randn(shape, generator=gen)


def _odd_offset_view(gen):
    flat = _normal(gen, 2 * 20 * 32 + 1)
    return flat[1:].view(2, 1, 20, 32), _normal(gen, 2, 1, 9, 32)


ROUTE_CASES = {
    "contiguous D=1024": (lambda gen: (_normal(gen, 2, 1, 5, 1024), _normal(gen, 2, 1, 3, 1024)), True),
    "D=7": (lambda gen: (_normal(gen, 2, 1, 5, 7), _normal(gen, 2, 1, 3, 7)), False),
    "D=48": (lambda gen: (_normal(gen, 4, 3, 33, 48), _normal(gen, 4, 3, 65, 48)), True),
    "view at an odd offset": (_odd_offset_view, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_tma_route(case):
    make, expected = ROUTE_CASES[case]
    pe, te = make(torch.Generator().manual_seed(3))
    assert pe.is_contiguous() and te.is_contiguous()
    assert _tma_route(pe, te) is expected


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_tma_operands_are_describable_and_keep_the_maxima(case):
    pe, te = ROUTE_CASES[case][0](torch.Generator().manual_seed(4))
    d = pe.shape[-1]
    ppe, pte = _tma_operands(pe, te)
    assert _tma_route(ppe, pte)
    assert ppe.shape[-1] == max(4, -(-d // 4) * 4) and ppe.shape[:-1] == pe.shape[:-1]
    for x, padded in ((pe, ppe), (te, pte)):
        assert torch.equal(padded[..., :d], x) and not padded[..., d:].any()
        assert padded.data_ptr() != x.data_ptr()
    for g, w in zip(maxsim_plain(ppe, pte), maxsim_plain(pe, te)):
        torch.testing.assert_close(g, w, rtol=0.0, atol=1e-6)


# --------------------------------------------------------------------------- #
# design notes on the 3xTF32 arithmetic of csrc/maxsim_tc.cu, emulated in numpy
# (the kernel itself is held against float64 on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #
SLAB, STEP = 128, 8  # the kernel's accumulator slab and wgmma depth, in elements of D


def _tf32(x):
    """float32 -> TF32 on the bit pattern as cvt.rna does: round the low 13
    bits away, to nearest with ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    return (sign | ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000))).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)  # x - big is exact in float32


def _add_f32(acc, term, truncate):
    """acc + term rounded to float32: to nearest, or toward zero as a
    truncating accumulator would."""
    exact = acc.astype(np.float64) + term.astype(np.float64)
    out = exact.astype(np.float32)
    if truncate:
        out = np.where(np.abs(out.astype(np.float64)) > np.abs(exact), np.nextafter(out, np.float32(0)), out)
    return out


def _emulate_tf32x3(a, b, truncate=False, slab=SLAB):
    """(P, D) x (R, D) similarities as the kernel sums them: per wgmma depth
    of 8, the three products small.big, big.small, big.big, each an 8-term dot
    product (exact, then rounded to float32) added into a float32 accumulator
    that restarts every `slab` of D; each slab is added into the float32 total
    with round to nearest."""
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    a_big, a_small, b_big, b_small = (x.astype(np.float64) for x in (a_big, a_small, b_big, b_small))
    total = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for lo_slab in range(0, a.shape[1], slab):
        acc = np.zeros_like(total)
        for lo in range(lo_slab, min(lo_slab + slab, a.shape[1]), STEP):
            cols = slice(lo, lo + STEP)
            for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                acc = _add_f32(acc, (x[:, cols] @ y[:, cols].T).astype(np.float32), truncate)
        total = (total + acc).astype(np.float32)
    return total


def _identical_positive_units(d=1024, n=16):
    """Seeded identical all-positive unit vectors at D = 1024: every product
    positive and each row's maximum 1, the sum a truncating accumulator pulls
    furthest down."""
    x = np.abs(np.random.default_rng(20261017).normal(size=(n, d))).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return x, x.copy()


def test_tf32x3_split_and_slabbed_sums_stay_within_1e6_of_float64():
    a, b = _identical_positive_units()
    big, small = _split(a)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any() and not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(a.astype(np.float64) - (big.astype(np.float64) + small)) <= 2.0**-22 * np.abs(a)).all()
    got = _emulate_tf32x3(a, b)
    assert np.abs(got - a.astype(np.float64) @ b.astype(np.float64).T).max() <= 1e-6
    assert np.abs(got.max(axis=1) - 1.0).max() <= 1e-6


def test_truncating_accumulator_keeps_a_margin_under_the_bound():
    """Were the tensor cores' float32 sums truncated, 128-deep slabs would keep
    the error at a fifth of the 1e-5 bound or less; one accumulator over all of
    D = 1024 loses more than four times as much."""
    a, b = _identical_positive_units()
    want = a.astype(np.float64) @ b.astype(np.float64).T
    slabbed = np.abs(_emulate_tf32x3(a, b, truncate=True) - want).max()
    whole = np.abs(_emulate_tf32x3(a, b, truncate=True, slab=a.shape[1]) - want).max()
    assert slabbed <= 2e-6
    assert whole > 4 * slabbed
