"""InceptionV3, FID-compat variant, as a torch module in NCHW (counterpart of
``metrics_tpu/nets/inception.py``).

Module and parameter names are those of the community
``pt_inception-2015-12-05`` checkpoint (torchvision style:
``Mixed_5b.branch1x1.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``,
``fc.weight``), so that checkpoint loads with ``load_state_dict`` through
:func:`load_inception_torch_state_dict`. The FID-community quirks the
published statistics depend on are kept:

- the average pools exclude padding from the divisor (``count_include_pad=False``);
- Mixed_7c's pool branch is a MAX pool;
- the classifier has 1008 outputs;
- the input is resized to 299 x 299 by the TF1 bilinear resize, which maps
  output ``i`` to input ``i * in / out`` with no half-pixel offset (the JAX
  package's code; its module docstring says half-pixel centers), then
  normalised as ``(x - 128) / 128``.

Taps: ``64``, ``192``, ``768``, ``2048``, ``logits_unbiased`` and
``logits``; the forward returns after the last tap requested. Every
convolution runs with cuDNN's TF32 off (``ops.image.helper.cudnn_float32``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.image.helper import cudnn_float32

VALID_FEATURES = ("64", "192", "768", "2048", "logits_unbiased", "logits")
NUM_FEATURES = {"64": 64, "192": 192, "768": 768, "2048": 2048, "logits_unbiased": 1008, "logits": 1008}


def _avg_pool_3x3_exclude_pad(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """Conv (no bias), frozen BatchNorm (eps=1e-3), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_exclude_pad(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_exclude_pad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool: str) -> None:
        super().__init__()
        self.pool = pool  # 'avg' (Mixed_7b) or 'max' (Mixed_7c, the FID quirk)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_exclude_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """FID-compat InceptionV3 trunk: a normalised NCHW batch at 299 x 299 in,
    the requested taps out (a dict)."""

    def __init__(self, features_list: Sequence[str] = ("2048",)) -> None:
        super().__init__()
        unknown = set(features_list) - set(VALID_FEATURES)
        if unknown:
            raise ValueError(f"unknown InceptionV3 taps {sorted(unknown)}; valid: {VALID_FEATURES}")
        self.features_list = tuple(features_list)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        remaining = set(self.features_list)
        out: Dict[str, Tensor] = {}

        def tap(name: str, value: Tensor) -> bool:
            if name in remaining:
                out[name] = value
                remaining.discard(name)
            return not remaining

        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        if tap("64", x.mean(dim=(2, 3))):
            return out
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        if tap("192", x.mean(dim=(2, 3))):
            return out
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        if tap("768", x.mean(dim=(2, 3))):
            return out
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        if tap("2048", pooled):
            return out
        logits_unbiased = pooled @ self.fc.weight.T
        tap("logits_unbiased", logits_unbiased)
        tap("logits", logits_unbiased + self.fc.bias)
        return out


def resize_bilinear_tf1(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """TF1-style asymmetric bilinear resize of an NCHW float batch: output
    ``i`` reads input ``i * in / out`` (no half-pixel offset), rows lerped
    first, then columns, as the JAX package does. Coordinates are made on
    the input's device, so a graph can capture the resize."""
    n, c, h, w = x.shape
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) * (h / out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) * (w / out_w)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0.to(torch.float32)).view(1, 1, out_h, 1)
    wx = (xs - x0.to(torch.float32)).view(1, 1, 1, out_w)
    rows = x[:, :, y0, :] * (1.0 - wy) + x[:, :, y1, :] * wy
    return rows[:, :, :, x0] * (1.0 - wx) + rows[:, :, :, x1] * wx


def seeded_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator`` (on the CPU, so the
    same on every device): convolutions He-normal (std sqrt(2 / fan_in), so
    activations keep their scale through the ReLUs and the features do not
    vanish), the classifier LeCun-normal, biases 0, BatchNorm scale 1,
    shift 0, mean 0, variance 1. They are NOT the values of the JAX
    package's ``PRNGKey(0)`` init (flax's LeCun-normal); carry those across
    with ``metrics_tpu_torch.convert.inception_state_dict_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                gain = 2.0 if isinstance(mod, nn.Conv2d) else 1.0
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * (gain / fan_in) ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return module


class InceptionV3FeatureExtractor:
    """Frozen feature extractor: NCHW uint8 or float batches -> [N, d] float32.

    ``variables`` is the module's state dict (what
    :func:`load_inception_torch_state_dict` returns); without it the net gets
    seeded random weights (:func:`seeded_init_`), for pipeline tests only,
    and the metric layer warns. The net lives on CUDA unless ``device``
    names another, and raises without a card (``core.metric.resolve_device``).
    """

    # inference-mode forward: the feature row of image i never depends on the
    # other rows, so pow2 zero-padding the batch keeps every value
    # (ops/kernels/features.maybe_bucketed)
    row_independent = True

    def __init__(self, feature: Any = "2048", variables: Optional[Mapping[str, Tensor]] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        name = str(feature)
        if name not in VALID_FEATURES:
            raise ValueError(f"Integer input to argument `feature` must be one of {VALID_FEATURES}, but got {feature}.")
        device = resolve_device(device)
        self.feature = name
        module = InceptionV3(features_list=(name,))
        if variables is None:
            seeded_init_(module)
        else:
            module.load_state_dict(load_inception_torch_state_dict(variables))
        self.module = module.eval().requires_grad_(False).to(device)

    @property
    def num_features(self) -> int:
        return NUM_FEATURES[self.feature]

    def to(self, device: Union[str, torch.device]) -> "InceptionV3FeatureExtractor":
        self.module = self.module.to(device)
        return self

    @torch.no_grad()
    def __call__(self, imgs: Tensor) -> Tensor:
        if imgs.ndim != 4:
            raise ValueError(f"Expected 4D image batch, got shape {tuple(imgs.shape)}")
        x = imgs.to(torch.float32)
        x = resize_bilinear_tf1(x, 299, 299)
        x = (x - 128.0) / 128.0
        with cudnn_float32():
            out = self.module(x)
        return out[self.feature].reshape(imgs.shape[0], -1)


@functools.lru_cache(maxsize=1)
def _parameter_shapes() -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    with torch.device("meta"):
        module = InceptionV3(features_list=VALID_FEATURES)
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


def load_inception_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    """Check a torchvision-style InceptionV3 state dict (the community
    ``pt_inception-2015-12-05`` checkpoint) against :class:`InceptionV3` and
    return the state dict the module loads: every key and shape must match,
    BatchNorm's ``num_batches_tracked`` may be missing (an older checkpoint)
    and is filled with 0, and ``fc.weight``/``fc.bias`` may be missing
    together (a net converted for a pooled tap, which the JAX package
    initialises without its classifier) and then come from a classifier
    seeded as :func:`seeded_init_` seeds one."""
    want = _parameter_shapes()
    given = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    unknown = sorted(set(given) - set(want))
    if unknown:
        raise KeyError(f"keys that InceptionV3 does not have: {unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    fc = None
    if not {"fc.weight", "fc.bias"} & set(given):
        fc = seeded_init_(nn.Linear(2048, 1008)).state_dict()
    out: Dict[str, Tensor] = {}
    missing = []
    for key, (shape, dtype) in want.items():
        if key in given:
            if tuple(given[key].shape) != shape:
                raise ValueError(f"{key}: expected shape {shape}, got {tuple(given[key].shape)}")
            out[key] = given[key].to(dtype)
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=dtype)
        elif fc is not None and key.startswith("fc."):
            out[key] = fc[key[len("fc."):]]
        else:
            missing.append(key)
    if missing:
        raise KeyError(f"keys missing from the state dict: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out
