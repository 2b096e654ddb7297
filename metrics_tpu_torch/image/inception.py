"""InceptionScore (counterpart of ``metrics_tpu/image/inception.py``): logits
in a ``cat`` state; compute permutes them on the host's seeded generator,
splits them in ``torch.chunk`` groups and averages ``exp(KL(p || p_mean))``."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image._extractor import move_extractor, resolve_feature_extractor
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

_VALID_IS_FEATURES = ("logits_unbiased", 64, 192, 768, 2048)


class InceptionScore(Metric):
    """Inception Score (mean and std over splits).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import InceptionScore
        >>> logits_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16].to(torch.float32) / 16.0
        >>> metric = InceptionScore(feature=logits_fn, splits=2, seed=123, device="cpu")
        >>> metric.update(torch.arange(4 * 3 * 8 * 8, dtype=torch.float32).reshape(4, 3, 8, 8) % 7)
        >>> mean, std = metric.compute()
        >>> mean.shape, std.shape
        (torch.Size([]), torch.Size([]))
    """

    higher_is_better = True
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        variables: Optional[dict] = None,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `InceptionScore` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self.inception = resolve_feature_extractor(
            feature, "InceptionScore", _VALID_IS_FEATURES, variables, device=self.device
        )
        self.splits = splits
        self.seed = seed
        self.add_state("features", [], dist_reduce_fx=None, bufferable=True)

    def update(self, imgs: Tensor) -> None:  # type: ignore[override]
        self.features = append_cat(self.features, self.inception(imgs).to(torch.float32))

    def compute(self) -> Tuple[Tensor, Tensor]:
        features = dim_zero_cat(self.features)
        # a seedable random permutation, drawn on the host
        idx = np.random.default_rng(self.seed).permutation(features.shape[0])
        features = features[torch.as_tensor(idx, device=features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        # torch.chunk groups: ceil(N/splits) rows each, a smaller last one
        chunk = max(-(-prob.shape[0] // self.splits), 1)
        kl_scores = []
        for p, log_p in zip(torch.split(prob, chunk), torch.split(log_prob, chunk)):
            mean_p = p.mean(dim=0, keepdim=True)
            kl = p * (log_p - torch.log(mean_p))
            kl_scores.append(torch.exp(kl.sum(dim=1).mean()))
        kl = torch.stack(kl_scores)
        return kl.mean(), kl.std(correction=1)

    def _move_attributes(self, device: torch.device) -> None:
        move_extractor(self.inception, device)
