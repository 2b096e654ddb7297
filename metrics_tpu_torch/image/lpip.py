"""LearnedPerceptualImagePatchSimilarity (counterpart of
``metrics_tpu/image/lpip.py``): the LPIPS net on [-1, 1] NCHW RGB pairs,
``(sum_scores, total)`` states with ``sum`` reduction."""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image._extractor import move_extractor
from metrics_tpu_torch.nets.lpips import LPIPSNet
from metrics_tpu_torch.ops.kernels.features import maybe_bucketed
from metrics_tpu_torch.utils.checks import _capturing
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _valid_img(img: Tensor) -> bool:
    """The shape check, and the [-1, 1] range check: two reads to the host on
    an eager update only, skipped while an engine probes or captures (as the
    JAX package skips it under a trace)."""
    if not (img.ndim == 4 and img.shape[1] == 3):
        return False
    if _capturing():
        return True
    return bool(img.min() >= -1.0) and bool(img.max() <= 1.0)


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS.

    ``net`` may be a callable mapping two image batches to per-pair
    distances (an :class:`~metrics_tpu_torch.nets.LPIPSNet` built with
    ``compute_dtype=torch.bfloat16``, say); else ``net_type`` ('alex', 'vgg',
    'squeeze') builds the port's net, with ``variables`` (its state dict) or
    seeded random weights.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity
        >>> lpips = LearnedPerceptualImagePatchSimilarity(
        ...     net=lambda a, b: torch.mean((a - b) ** 2, dim=(1, 2, 3)), device="cpu")
        >>> lpips.update(torch.zeros(2, 3, 16, 16), torch.full((2, 3, 16, 16), 0.5))
        >>> round(float(lpips.compute()), 4)
        0.25
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        net: Optional[Union[Callable, LPIPSNet]] = None,
        variables: Optional[dict] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net is not None:
            self.net = maybe_bucketed(net, True)
        else:
            if net_type not in valid_net_type:
                raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
            if variables is None:
                rank_zero_warn(
                    "Metric `LearnedPerceptualImagePatchSimilarity` is using a randomly initialized"
                    " backbone: pass converted torch weights via `variables` for comparable scores.",
                    UserWarning,
                )
            self.net = maybe_bucketed(
                LPIPSNet(net_type, variables=variables, device=self.device), True
            )

        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction

        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:  # type: ignore[override]
        if not (_valid_img(img1) and _valid_img(img2)):
            raise ValueError(
                "Expected both input arguments to be normalized tensors (all values in range [-1,1])"
                f" and to have shape [N, 3, H, W] but `img1` have shape {tuple(img1.shape)} and `img2`"
                f" have shape {tuple(img2.shape)}"
            )
        loss = self.net(img1, img2).squeeze()
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + img1.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores

    def _move_attributes(self, device: torch.device) -> None:
        move_extractor(self.net, device)
