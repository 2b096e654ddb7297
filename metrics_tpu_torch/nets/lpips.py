"""LPIPS (Learned Perceptual Image Patch Similarity) as a torch module in NCHW
(counterpart of ``metrics_tpu/nets/lpips.py``).

Zhang et al. (2018): scale the input, run a frozen conv trunk (alex, vgg16
or squeeze), unit-normalise each tapped activation over its channels,
square the difference, weight it with the non-negative 1x1 "lin" heads,
take the spatial mean and sum over the taps. Both images go through the
trunk as ONE 2N batch.

State-dict keys are those of the torch checkpoints, so they load as they
are: the trunk is ``net.features`` laid out as torchvision's ``features``
(``net.features.0.weight``; squeeze's fire modules
``net.features.3.squeeze.weight``), the heads are the lpips checkpoint's
``lin<k>.model.1.weight`` of shape (1, C, 1, 1). The pools follow the JAX
package (floor mode; torchvision's SqueezeNet pools in ceil mode, which
differs only where (H - 3) is odd). Every convolution runs with cuDNN's
TF32 off.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.image.helper import cudnn_float32

# input normalisation constants of lpips.ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# tap channel sizes per trunk
NET_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

# torchvision `features` indices of the convolutions, and the module index
# after which each tap is read
ALEX_CONV_IDX = (0, 3, 6, 8, 10)
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
SQUEEZE_FIRE_IDX = (3, 4, 6, 7, 9, 10, 11, 12)
_TAPS = {"alex": (1, 4, 7, 9, 11), "vgg": (3, 8, 15, 22, 29), "squeeze": (1, 4, 7, 9, 10, 11, 12)}


class Fire(nn.Module):
    """SqueezeNet fire module, torchvision's names."""

    def __init__(self, in_ch: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], 1)


def _alex_features() -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
    )


def _vgg16_features() -> nn.Sequential:
    layers: List[nn.Module] = []
    in_ch = 3
    for width in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512):
        if width == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, width, 3, padding=1), nn.ReLU()]
            in_ch = width
    return nn.Sequential(*layers)


def _squeeze_features() -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        Fire(64, 16, 64), Fire(128, 16, 64), nn.MaxPool2d(3, 2),
        Fire(128, 32, 128), Fire(256, 32, 128), nn.MaxPool2d(3, 2),
        Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256), Fire(512, 64, 256),
    )


_FEATURES = {"alex": _alex_features, "vgg": _vgg16_features, "squeeze": _squeeze_features}


class Trunk(nn.Module):
    def __init__(self, net_type: str) -> None:
        super().__init__()
        self.features = _FEATURES[net_type]()
        self._taps = frozenset(_TAPS[net_type])

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x)
        return taps


class _Lin(nn.Module):
    """An lpips head: ``model.1`` is the (1, C, 1, 1) weight (``model.0`` is
    the checkpoint's dropout, a no-op at inference)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Two NCHW batches in [-1, 1] -> (N,) distances."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        if net_type not in _FEATURES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_FEATURES)}, but got {net_type}.")
        self.net_type = net_type
        self.net = Trunk(net_type)
        for k, c in enumerate(NET_CHANNELS[net_type]):
            setattr(self, f"lin{k}", _Lin(c))
        # constants as buffers: made once on the module's device, so a graph
        # capture of the forward copies nothing from the host
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        n = img1.shape[0]
        both = torch.cat([img1, img2], 0)
        weight_dtype = self.net.features[0].weight.dtype
        taps = self.net(((both - self.shift) / self.scale).to(weight_dtype))
        total = torch.zeros((), dtype=torch.float32, device=img1.device)
        for k, f in enumerate(taps):
            f = f.to(torch.float32)
            norm = torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True))
            f = f / (norm + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            # the heads are non-negative in lpips: clamped where used
            w = getattr(self, f"lin{k}").model[1].weight.reshape(1, -1, 1, 1).to(torch.float32)
            total = total + (diff * torch.clamp(w, min=0.0)).sum(dim=1).mean(dim=(1, 2))
        return total


def seeded_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random trunk weights from a seeded ``torch.Generator`` (He-normal
    kernels, std sqrt(2 / fan_in), so activations keep their scale through
    the ReLUs; zero biases) and heads of 1. They are NOT the values of the
    JAX package's ``PRNGKey(0)`` init (flax's LeCun-normal); carry those
    across with ``metrics_tpu_torch.convert.lpips_state_dict_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, nn.Conv2d):
                if name.startswith("lin"):
                    mod.weight.fill_(1.0)
                    continue
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
    return module


class LPIPSNet:
    """Frozen LPIPS scorer: NCHW [-1, 1] image pairs -> (N,) float32 distances.

    ``variables`` is the module's state dict (what
    :func:`load_lpips_torch_state_dict` returns); without it the net gets
    seeded random weights (:func:`seeded_init_`) and the metric layer warns.
    ``compute_dtype=torch.bfloat16`` runs the trunk in bfloat16 on the
    tensor cores (weights cast once, here); the normalisation and the heads
    stay float32. Distances then move by about 1e-2 relative, so it is
    opt-in. The net lives on CUDA unless ``device`` names another, and
    raises without a card (``core.metric.resolve_device``).
    """

    # per-pair distances are row-independent: pow2 zero-padding keeps every value
    row_independent = True

    def __init__(self, net_type: str = "alex", variables: Optional[Mapping[str, Tensor]] = None,
                 compute_dtype: Optional[torch.dtype] = None, device: Union[str, torch.device, None] = None) -> None:
        if net_type not in _FEATURES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_FEATURES)}, but got {net_type}.")
        device = resolve_device(device)
        self.net_type = net_type
        module = LPIPS(net_type)
        if variables is None:
            seeded_init_(module)
        else:
            module.load_state_dict(_check_state_dict(module, variables))
        self.compute_dtype = compute_dtype
        if compute_dtype is not None:
            module.net.to(compute_dtype)
        self.module = module.eval().requires_grad_(False).to(device)

    def to(self, device: Union[str, torch.device]) -> "LPIPSNet":
        self.module = self.module.to(device)
        return self

    @torch.no_grad()
    def __call__(self, img1: Tensor, img2: Tensor) -> Tensor:
        with cudnn_float32():
            return self.module(img1.to(torch.float32), img2.to(torch.float32))


def _check_state_dict(module: nn.Module, state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    want = module.state_dict()
    given = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if set(given) != set(want):
        raise KeyError(f"LPIPS({module.net_type}) keys differ: missing {sorted(set(want) - set(given))[:8]},"
                       f" unknown {sorted(set(given) - set(want))[:8]}")
    for key, ref in want.items():
        if tuple(given[key].shape) != tuple(ref.shape):
            raise ValueError(f"{key}: expected shape {tuple(ref.shape)}, got {tuple(given[key].shape)}")
    return given


def load_lpips_torch_state_dict(
    backbone_state_dict: Mapping[str, Any],
    lin_state_dict: Mapping[str, Any],
    net_type: str = "alex",
) -> Dict[str, Tensor]:
    """The :class:`LPIPS` state dict from torchvision trunk weights
    (``features.N.weight``/``.bias``; squeeze ``features.N.squeeze.weight``
    ...) and the lpips checkpoint's ``lin<k>.model.1.weight`` heads, every
    key and shape checked."""
    merged = {f"net.{k}": v for k, v in backbone_state_dict.items()}
    merged.update(lin_state_dict)
    return _check_state_dict(LPIPS(net_type), merged)
