"""Every functional of the port's ``ops/image`` against the JAX package's on
the CPU: SSIM (2D and 3D, gaussian and uniform, every reduction, the full
image and contrast sensitivity), MS-SSIM (every ``normalize``, the size
guard), PSNR (``dim``, ``base``, ``data_range=None``), image gradients, SAM,
ERGAS, UQI and D-lambda (p = 1 and 2), with the helpers under them. The
quality classes are in ``tests/test_torch_image_quality.py``; the FID/KID
ops, the generative classes and the bucketing in
``tests/test_torch_image_metrics.py``; the nets and their converters in
``tests/test_torch_image_nets.py`` and ``tests/test_torch_image_lpips.py``.

Inputs come from seeded numpy generators. Tolerances, each with its reason:

- ``ATOL = 1e-5`` for SSIM, MS-SSIM, UQI, D-lambda and SAM values in [-1, 1]
  or radians: the convolutions and sums run in another order than XLA's
  (10x tighter than the JAX package's own 1e-4 against numpy,
  ``tests/image/test_image.py:169-259``); per-pixel SAM angles through their
  cosines (within 1e-6), since arccos near 1 magnifies an ulp of the cosine;
- ``RTOL = 1e-5`` relative for PSNR (a log of a float32 sum), ERGAS (a root
  of sums) and ``reduction="sum"``, as the JAX package's own against numpy;
- bit for bit where nothing is summed: image gradients (also against
  numpy), the reflection pad, the uniform kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.ops.image import helper as jhelper
from metrics_tpu_torch.ops.image import helper as thelper
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

ATOL = 1e-5
RTOL = 1e-5


def _pair(seed, shape, noise=0.25):
    rng = np.random.default_rng(seed)
    t = rng.random(shape).astype(np.float32)
    p = np.clip(t + noise * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return p, t


def _both(fn_jax, fn_torch, *arrays, **kwargs):
    """``fn_torch`` on CPU tensors and ``fn_jax`` jitted (one compile a case
    instead of one per operation) on the same arrays; eager for the uniform
    SSIM kernel, which the JAX package cannot trace (``float()`` of a traced
    product, ``metrics_tpu/ops/image/helper.py:47``)."""
    static = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
    run = fn_jax if kwargs.get("gaussian_kernel") is False else jax.jit(fn_jax, static_argnames=tuple(static))
    want = run(*[jnp.asarray(a) for a in arrays], **static)
    got = fn_torch(*[torch.from_numpy(a) for a in arrays], **kwargs)
    return got, want


def _close(got, want, rtol=0.0, atol=ATOL, msg=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), msg
        for g, w in zip(got, want):
            _close(g, w, rtol, atol, msg)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, f"{msg}: {g.dtype} != {w.dtype}"
    assert_close(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=atol, msg=msg)


# --------------------------------------------------------------------------- #
# helpers: kernels, reflection pad, validation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k,sigma", [(11, 1.5), (7, 0.5), (3, 2.0)])
def test_gaussian_kernels_match_jax(k, sigma):
    _close(thelper._gaussian_kernel_2d(3, [k, k], [sigma, sigma], torch.float32),
           jhelper._gaussian_kernel_2d(3, [k, k], [sigma, sigma], jnp.float32), atol=1e-7)
    _close(thelper._gaussian_kernel_3d(2, [k, 5, 3], [sigma, 1.0, 0.7], torch.float32),
           jhelper._gaussian_kernel_3d(2, [k, 5, 3], [sigma, 1.0, 0.7], jnp.float32), atol=1e-7)
    assert_bitwise(thelper._uniform_kernel_2d(2, [k, 5], torch.float32),
                   np.asarray(jhelper._uniform_kernel_2d(2, [k, 5], jnp.float32)))


@pytest.mark.parametrize("shape,pads", [((1, 2, 4, 6), [2, 3]), ((2, 1, 3, 5), [3, 7]), ((1, 1, 1, 4), [2, 2]),
                                        ((1, 1, 5, 4, 3), [2, 3, 4])], ids=str)
def test_reflection_pad_matches_jnp_pad_also_past_the_image(shape, pads):
    # pads at or past the axis length reflect again, as jnp.pad does; F.pad would raise
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    assert_bitwise(thelper._reflection_pad(torch.from_numpy(x), pads), np.asarray(jhelper._reflection_pad(jnp.asarray(x), pads)))


def test_small_image_ssim_matches_jax_through_the_repeated_reflection():
    p, t = _pair(2, (2, 1, 4, 4))
    got, want = _both(mj.functional.structural_similarity_index_measure,
                      mt.functional.structural_similarity_index_measure, p, t, data_range=1.0)
    _close(got, want)


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "channels"])
def test_pair_validation_raises_as_jax(case):
    p, t = _pair(3, (2, 1, 8, 8))
    args = {"dtype": (p, t.astype(np.float16)), "shape": (p, t[:1]), "rank": (p[0], t[0]),
            "channels": (p, t)}[case]
    fn_j = mj.functional.spectral_angle_mapper if case == "channels" else mj.functional.universal_image_quality_index
    fn_t = mt.functional.spectral_angle_mapper if case == "channels" else mt.functional.universal_image_quality_index
    with pytest.raises(Exception) as want:
        fn_j(*[jnp.asarray(a) for a in args])
    with pytest.raises(type(want.value)):
        fn_t(*[torch.from_numpy(a) for a in args])


# --------------------------------------------------------------------------- #
# SSIM, MS-SSIM
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "uniform"])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("data_range", [None, 1.0])
def test_ssim_2d_matches_jax(gaussian, reduction, data_range):
    p, t = _pair(4, (3, 2, 24, 20))
    got, want = _both(mj.functional.structural_similarity_index_measure,
                      mt.functional.structural_similarity_index_measure, p, t,
                      gaussian_kernel=gaussian, kernel_size=7, sigma=1.2, reduction=reduction, data_range=data_range)
    _close(got, want, atol=ATOL * (3 if reduction == "sum" else 1))


@pytest.mark.parametrize("output", ["full_image", "contrast_sensitivity"])
def test_ssim_extra_outputs_match_jax(output):
    p, t = _pair(5, (2, 3, 20, 24))
    kw = {f"return_{output}": True}
    got, want = _both(mj.functional.structural_similarity_index_measure,
                      mt.functional.structural_similarity_index_measure, p, t, data_range=1.0, **kw)
    _close(got, want)
    # reduction "none" keeps the full map's shape
    got, want = _both(mj.functional.structural_similarity_index_measure,
                      mt.functional.structural_similarity_index_measure, p, t, data_range=1.0, reduction="none", **kw)
    _close(got, want)


@pytest.mark.parametrize("gaussian", [True, False], ids=["gaussian", "uniform"])
def test_ssim_3d_matches_jax(gaussian):
    p, t = _pair(6, (2, 1, 10, 12, 14))
    got, want = _both(mj.functional.structural_similarity_index_measure,
                      mt.functional.structural_similarity_index_measure, p, t,
                      gaussian_kernel=gaussian, kernel_size=5, sigma=0.8, reduction="none")
    _close(got, want)


@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
def test_ms_ssim_matches_jax(normalize):
    p, t = _pair(7, (2, 1, 40, 36), noise=0.1)
    got, want = _both(mj.functional.multiscale_structural_similarity_index_measure,
                      mt.functional.multiscale_structural_similarity_index_measure, p, t,
                      sigma=0.5, kernel_size=5, betas=(0.2, 0.3, 0.5), normalize=normalize, reduction="none")
    _close(got, want)


@pytest.mark.parametrize("size,kwargs", [(11, dict(betas=(0.5, 0.5))), (150, {}), (24, dict(sigma=0.5, kernel_size=5))])
def test_ms_ssim_size_guard_on_the_effective_kernel(size, kwargs):
    p, _ = _pair(9, (1, 1, size, size))
    with pytest.raises(ValueError, match="must be larger than") as want:
        mj.functional.multiscale_structural_similarity_index_measure(jnp.asarray(p), jnp.asarray(p), **kwargs)
    with pytest.raises(ValueError, match="must be larger than") as got:
        mt.functional.multiscale_structural_similarity_index_measure(torch.from_numpy(p), torch.from_numpy(p), **kwargs)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# PSNR, gradients, SAM, ERGAS, UQI, D-lambda
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("base", [10.0, 2.0])
@pytest.mark.parametrize("data_range", [None, 1.0])
def test_psnr_matches_jax(base, data_range):
    p, t = _pair(10, (4, 3, 16, 16))
    got, want = _both(mj.functional.peak_signal_noise_ratio, mt.functional.peak_signal_noise_ratio, p, t,
                      data_range=data_range, base=base)
    _close(got, want, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("dim", [0, 1, (1, 2, 3), (2, 3), ()], ids=str)
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_psnr_dim_matches_jax(dim, reduction):
    p, t = _pair(11, (4, 3, 8, 8))
    got, want = _both(mj.functional.peak_signal_noise_ratio, mt.functional.peak_signal_noise_ratio, p, t,
                      data_range=1.0, dim=dim, reduction=reduction)
    _close(got, want, rtol=RTOL, atol=0.0)


def test_psnr_dim_needs_data_range():
    p, t = _pair(12, (2, 1, 4, 4))
    with pytest.raises(ValueError, match="The `data_range` must be given"):
        mt.functional.peak_signal_noise_ratio(torch.from_numpy(p), torch.from_numpy(t), dim=0)


def test_image_gradients_bitwise_against_numpy_and_jax():
    img = np.random.default_rng(13).random((2, 3, 7, 9)).astype(np.float32)
    dy, dx = mt.functional.image_gradients(torch.from_numpy(img))
    want_dy = np.zeros_like(img)
    want_dx = np.zeros_like(img)
    want_dy[..., :-1, :] = img[..., 1:, :] - img[..., :-1, :]
    want_dx[..., :, :-1] = img[..., :, 1:] - img[..., :, :-1]
    assert_bitwise(dy, want_dy)
    assert_bitwise(dx, want_dx)
    jdy, jdx = mj.functional.image_gradients(jnp.asarray(img))
    assert_bitwise(dy, np.asarray(jdy))
    assert_bitwise(dx, np.asarray(jdx))
    with pytest.raises(RuntimeError, match="4D tensor"):
        mt.functional.image_gradients(torch.from_numpy(img[0]))
    with pytest.raises(TypeError):
        mt.functional.image_gradients(img)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_matches_jax(reduction):
    p, t = _pair(14, (3, 4, 10, 12))
    got, want = _both(mj.functional.spectral_angle_mapper, mt.functional.spectral_angle_mapper, p, t,
                      reduction=reduction)
    if reduction == "none":
        # arccos near 1 magnifies an ulp of the cosine (d/dx = 1/sin): per-pixel
        # angles compare through their cosines
        _close(torch.cos(got), jnp.cos(want), atol=1e-6)
    else:
        _close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ratio", [4, 2, 1.5])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_ergas_matches_jax(ratio, reduction):
    p, t = _pair(15, (3, 4, 12, 12))
    got, want = _both(mj.functional.error_relative_global_dimensionless_synthesis,
                      mt.functional.error_relative_global_dimensionless_synthesis, p, t, ratio=ratio,
                      reduction=reduction)
    _close(got, want, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("kernel_size,sigma", [((11, 11), (1.5, 1.5)), ((5, 7), (0.8, 1.2))], ids=str)
@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_uqi_matches_jax(kernel_size, sigma, reduction):
    p, t = _pair(16, (2, 3, 20, 18))
    got, want = _both(mj.functional.universal_image_quality_index, mt.functional.universal_image_quality_index,
                      p, t, kernel_size=kernel_size, sigma=sigma, reduction=reduction)
    _close(got, want)


@pytest.mark.parametrize("p_norm", [1, 2])
@pytest.mark.parametrize("channels", [1, 4])
def test_d_lambda_matches_jax(p_norm, channels):
    p, t = _pair(17, (2, channels, 16, 16))
    got, want = _both(mj.functional.spectral_distortion_index, mt.functional.spectral_distortion_index, p, t,
                      p=p_norm)
    _close(got, want)


