"""The quality metric classes of the port against the JAX package's on the
CPU, over streams of several updates, in list and buffered states: PSNR
(``dim``, ``base``, ``data_range=None`` with its running min and max),
SSIM, MS-SSIM, UQI, D-lambda, ERGAS and SAM, and the constructor checks.

Inputs come from seeded numpy generators. Tolerances as the functionals'
(``tests/test_torch_image.py``): ``ATOL = 1e-5`` for values in [-1, 1] or
radians (per-pixel SAM angles through their cosines), ``RTOL = 1e-5``
relative for PSNR, ERGAS and ``reduction="sum"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from tests.helpers.torch_port import assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

ATOL = 1e-5
RTOL = 1e-5
# the JAX references run eagerly: their engines would compile each stream's steps
JAX_EAGER = dict(compiled_update=False, compiled_compute=False)


def _pair(seed, shape, noise=0.25):
    rng = np.random.default_rng(seed)
    t = rng.random(shape).astype(np.float32)
    p = np.clip(t + noise * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return p, t


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
# the metric classes beyond the harness's INVENTORY cases
# --------------------------------------------------------------------------- #
def _stream(seed, n_batches, shape):
    return [_pair(seed + i, shape) for i in range(n_batches)]


@pytest.mark.parametrize("kwargs", [dict(), dict(data_range=1.0, base=2.0),
                                    dict(data_range=1.0, dim=(1, 2, 3), reduction="none"),
                                    dict(data_range=1.0, dim=1, reduction="sum")], ids=str)
def test_psnr_metric_over_a_stream_matches_jax(kwargs):
    ref, port = mj.PeakSignalNoiseRatio(**kwargs, **JAX_EAGER), mt.PeakSignalNoiseRatio(device="cpu", **kwargs)
    for p, t in _stream(30, 3, (2, 3, 8, 8)):
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(port.compute(), ref.compute(), rtol=RTOL, atol=0.0)
    if "data_range" not in kwargs:  # the running min/max stay on the device
        assert port.min_target.dtype == torch.float32 and float(port.min_target) == float(ref.min_target)


@pytest.mark.parametrize("name,kwargs", [
    ("StructuralSimilarityIndexMeasure", dict(data_range=1.0, reduction="none")),
    ("StructuralSimilarityIndexMeasure", dict(return_contrast_sensitivity=True)),
    ("MultiScaleStructuralSimilarityIndexMeasure", dict(sigma=0.5, kernel_size=5, betas=(0.4, 0.6))),
    ("UniversalImageQualityIndex", dict(reduction="sum")),
    ("SpectralDistortionIndex", dict(p=2)),
    ("ErrorRelativeGlobalDimensionlessSynthesis", dict(ratio=2)),
    ("SpectralAngleMapper", dict(reduction="none")),
], ids=lambda x: x if isinstance(x, str) else str(sorted(x)))
@pytest.mark.parametrize("buffered", [False, True], ids=["lists", "buffers"])
def test_quality_metric_over_a_stream_matches_jax(name, kwargs, buffered):
    extra = dict(buffer_capacity=16) if buffered else {}
    ref = getattr(mj, name)(**kwargs, **extra, **JAX_EAGER)
    port = getattr(mt, name)(device="cpu", **kwargs, **extra)
    for p, t in _stream(40, 3, (2, 3, 24, 24)):
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    got, want = port.compute(), ref.compute()
    if name == "SpectralAngleMapper":  # per-pixel angles through their cosines (test_sam_matches_jax)
        got, want = torch.cos(got), jnp.cos(want)
    relative = name == "ErrorRelativeGlobalDimensionlessSynthesis" or kwargs.get("reduction") == "sum"
    _close(got, want, rtol=RTOL if relative else 0.0, atol=0.0 if relative else ATOL)


def test_ms_ssim_metric_rejects_what_jax_rejects():
    for kwargs in (dict(betas=[0.5, 0.5]), dict(betas=(1, 2)), dict(normalize="max"), dict(kernel_size=1.5),
                   dict(sigma=1)):
        with pytest.raises(ValueError):
            mj.MultiScaleStructuralSimilarityIndexMeasure(**kwargs)
        with pytest.raises(ValueError):
            mt.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **kwargs)
