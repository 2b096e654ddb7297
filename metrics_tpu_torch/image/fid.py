"""FrechetInceptionDistance (counterpart of ``metrics_tpu/image/fid.py``).

State is the streaming Welford triple ``(n, mean, centered M2)`` per
distribution, float32 and of fixed shape (O(D^2) memory, whatever the
sample count). Batches fold in by Chan's combine, and so do ranks: the
sync gathers each state (``gather_all_arrays``, three a triple) and folds
the ranks' triples in rank order, which per-state reductions cannot express.

``real`` is a Python bool. The port's engine keys Python scalars by value
(``core/engine.py``, ``_leaf_signature``), so ``real=True`` and
``real=False`` are two signatures, each captured on its own.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image._extractor import move_extractor, resolve_feature_extractor
from metrics_tpu_torch.ops.image.fid import _compute_fid, _mean_cov_from_moments, welford_combine, welford_update
from metrics_tpu_torch.parallel import sync as _sync

_VALID_FID_FEATURES = (64, 192, 768, 2048)
_TRIPLES = {prefix: tuple(f"{prefix}_{leaf}" for leaf in ("n", "mean", "m2")) for prefix in ("real", "fake")}


def fold_triples(stacks: Dict[str, List[Tensor]]) -> Dict[str, Tensor]:
    """Each distribution's triples (one a rank, in rank order) folded by
    Chan's combine, left to right."""
    out: Dict[str, Tensor] = {}
    for names in _TRIPLES.values():
        acc = tuple(stacks[n][0] for n in names)
        for w in range(1, len(stacks[names[0]])):
            acc = welford_combine(acc, tuple(stacks[n][w] for n in names))
        out.update(dict(zip(names, acc)))
    return out


class FrechetInceptionDistance(Metric):
    """FID.

    ``feature`` is an InceptionV3 tap (64, 192, 768 or 2048; pass the
    checkpoint's state dict as ``variables`` for published-comparable
    numbers) or any callable ``imgs -> [N, d]`` with a ``feature_size``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image import FrechetInceptionDistance
        >>> fid = FrechetInceptionDistance(
        ...     feature=lambda imgs: imgs.reshape(imgs.shape[0], -1), feature_size=4, device="cpu"
        ... )
        >>> imgs = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 1, 2, 2)
        >>> fid.update(imgs, real=True)
        >>> fid.update(imgs + 1.0, real=False)
        >>> int(round(float(fid.compute())))
        4
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
        reset_real_features: bool = True,
        variables: Optional[dict] = None,
        feature_size: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception = resolve_feature_extractor(
            feature, "FrechetInceptionDistance", _VALID_FID_FEATURES, variables, device=self.device
        )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features

        if feature_size is None:
            feature_size = getattr(self.inception, "num_features", None) or (feature if isinstance(feature, int) else None)
        if feature_size is None:
            raise ValueError("Pass `feature_size` when using a custom feature extractor callable.")
        d = int(feature_size)

        # the reductions are the joint merge and sync below
        for prefix in ("real", "fake"):
            self.add_state(f"{prefix}_n", default=torch.tensor(0.0), dist_reduce_fx=None)
            self.add_state(f"{prefix}_mean", default=torch.zeros(d), dist_reduce_fx=None)
            self.add_state(f"{prefix}_m2", default=torch.zeros((d, d)), dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:  # type: ignore[override]
        """Extract features and fold them into the streaming moments."""
        features = self.inception(imgs).to(torch.float32)
        names = _TRIPLES["real" if real else "fake"]
        triple = welford_update(*(getattr(self, name) for name in names), features)
        for name, value in zip(names, triple):
            setattr(self, name, value)

    def compute(self) -> Tensor:
        mean1, cov1 = _mean_cov_from_moments(self.real_n, self.real_mean, self.real_m2)
        mean2, cov2 = _mean_cov_from_moments(self.fake_n, self.fake_mean, self.fake_m2)
        return _compute_fid(mean1, cov1, mean2, cov2)

    # the joint moment combination: cross-batch merge and cross-rank sync
    def merge_states(self, state: Dict, incoming: Dict, update_counts: Tuple[int, int] = (1, 1)) -> Dict:
        return fold_triples({k: [state[k], incoming[k]] for k in state})

    def sync_states(self, state: Dict, group: Optional[Any]) -> Dict:
        """Gather every state over ``group`` and fold the ranks' triples in
        rank order; ``group=None`` returns the state unchanged."""
        if group is None:
            return dict(state)
        return fold_triples({k: [g.reshape(v.shape) for g in _sync.gather_all_arrays(v, group)]
                             for k, v in state.items()})

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        if dist_sync_fn is not None:
            return super()._sync_dist(dist_sync_fn, process_group)
        self.set_state(self.sync_states(self.get_state(), self._sync_group(process_group)))

    def reset(self) -> None:
        if not self.reset_real_features:
            # keep the cached real-distribution moments
            kept = {name: getattr(self, name) for name in _TRIPLES["real"]}
            super().reset()
            for name, value in kept.items():
                setattr(self, name, value)
        else:
            super().reset()

    def _move_attributes(self, device: torch.device) -> None:
        move_extractor(self.inception, device)
