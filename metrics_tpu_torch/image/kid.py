"""KernelInceptionDistance (counterpart of ``metrics_tpu/image/kid.py``).

Feature lists per distribution (``CatBuffer``s under ``buffer_capacity=``).
Compute draws every subset's indices at once on the host with
``np.random.default_rng(seed)``, exactly as the JAX package draws them, and
scores all subsets in one batched program.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image._extractor import move_extractor, resolve_feature_extractor
from metrics_tpu_torch.ops.image.kid import batched_poly_mmd
from metrics_tpu_torch.utils.checks import _check_positive_int
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

_VALID_KID_FEATURES = (64, 192, 768, 2048)


class KernelInceptionDistance(Metric):
    """KID (mean and std over subsets).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KernelInceptionDistance
        >>> feature_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16].to(torch.float32) / 255.0
        >>> kid = KernelInceptionDistance(feature=feature_fn, subsets=2, subset_size=4, seed=0, device="cpu")
        >>> gen = torch.Generator().manual_seed(1)
        >>> kid.update(torch.randint(0, 255, (4, 3, 8, 8), generator=gen, dtype=torch.uint8), real=True)
        >>> kid.update(torch.randint(0, 255, (4, 3, 8, 8), generator=gen, dtype=torch.uint8), real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> kid_mean.shape, float(kid_std)
        (torch.Size([]), 0.0)
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False
    # `real` routes the batch: a per-value signature of the metric's own
    # engine, never a leaf of a collection's fused step
    _static_update_kwargs = ("real",)

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        variables: Optional[dict] = None,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `KernelInceptionDistance` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self.inception = resolve_feature_extractor(
            feature, "KernelInceptionDistance", _VALID_KID_FEATURES, variables, device=self.device
        )
        for name, val in (("subsets", subsets), ("subset_size", subset_size), ("degree", degree)):
            _check_positive_int(val, name)
        self.subsets, self.subset_size, self.degree = subsets, subset_size, degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError(f"`gamma` must be None or a positive float; got {gamma!r}.")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError(f"`coef` must be a positive float; got {coef!r}.")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError(f"`reset_real_features` must be a bool; got {reset_real_features!r}.")
        self.reset_real_features = reset_real_features
        self.seed = seed

        self.add_state("real_features", [], dist_reduce_fx=None, bufferable=True)
        self.add_state("fake_features", [], dist_reduce_fx=None, bufferable=True)

    def update(self, imgs: Tensor, real: bool) -> None:  # type: ignore[override]
        features = self.inception(imgs).to(torch.float32)
        if real:
            self.real_features = append_cat(self.real_features, features)
        else:
            self.fake_features = append_cat(self.fake_features, features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_real, n_fake = real_features.shape[0], fake_features.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        rng = np.random.default_rng(self.seed)
        real_idx = np.stack([rng.permutation(n_real)[: self.subset_size] for _ in range(self.subsets)])
        fake_idx = np.stack([rng.permutation(n_fake)[: self.subset_size] for _ in range(self.subsets)])

        kid_scores = batched_poly_mmd(
            real_features[torch.as_tensor(real_idx, device=real_features.device)],
            fake_features[torch.as_tensor(fake_idx, device=fake_features.device)],
            self.degree,
            self.gamma,
            self.coef,
        )
        return kid_scores.mean(), kid_scores.std(correction=0)

    def reset(self) -> None:
        if not self.reset_real_features:
            value = self._defaults.pop("real_features")
            super().reset()
            self._defaults["real_features"] = value
        else:
            super().reset()

    def _move_attributes(self, device: torch.device) -> None:
        move_extractor(self.inception, device)
