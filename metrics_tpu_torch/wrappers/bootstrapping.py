"""Bootstrapped confidence intervals for any metric (counterpart of
``metrics_tpu/wrappers/bootstrapping.py``).

The wrapper keeps one base metric and a single *stacked* state with a leading
``(num_bootstraps,)`` axis, registered through ``add_state`` with the base
metric's reductions and persistence, so sync, ``state_dict`` and ``reset``
treat it like any state. Each update draws every replica's resample indices on
the host from ``np.random.default_rng(seed)``, with the JAX package's calls in
its order (one ``rng.poisson(1, size)`` or ``rng.integers(0, size, size)`` per
replica, in replica order), so both packages resample the same rows. Replicas
with equal resample lengths advance together: one ``torch.func.vmap`` of the
base's ``update_state`` per length group where vmap takes the base's update,
else a loop over that group's replicas of the same stacked state. A poisson
draw that comes out empty skips its replica.

Bases whose states cannot be stacked (unbounded list states, buffers, no
compiled update) fall back to one deep copy per replica, as the JAX package
decides. The update is never captured into a graph: it would freeze one
resample pattern.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import _check_arg_choice, _checks_off
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.exceptions import Uncapturable


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Resample-with-replacement row indices along dim 0 (host RNG)."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size=size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


def _in_dims(tree: Any) -> Any:
    """vmap's ``in_dims`` for an argument tree: tensors mapped on dim 0,
    anything else passed as it is."""
    if isinstance(tree, Tensor):
        return 0
    if isinstance(tree, dict):
        return {k: _in_dims(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_in_dims(v) for v in tree)
    return None


class BootStrapper(Metric):
    """Bootstrap resampling over a base metric, on one stacked state.

    ``compute`` gives the ``mean``, the ``std`` (Bessel-corrected) and the
    ``quantile`` (linear interpolation) of the replicas' values, and their
    ``raw`` stack. The wrapper lives on its base metric's device unless
    ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, BootStrapper
        >>> boot = BootStrapper(Accuracy(num_classes=5, device="cpu"), num_bootstraps=20, seed=0)
        >>> boot.update(torch.tensor([0, 1, 2, 3, 4]), torch.tensor([0, 1, 2, 3, 3]))
        >>> out = boot.compute()
        >>> sorted(out) == ["mean", "std"] and bool(0.0 <= out["mean"] <= 1.0)
        True
    """

    full_state_update: bool = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float], Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)

        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self._rng = np.random.default_rng(seed)

        _check_arg_choice(sampling_strategy, "sampling_strategy", ("poisson", "multinomial"))
        self.sampling_strategy = sampling_strategy

        self.base = deepcopy(base_metric)
        # the stacked path needs every state stackable with a fixed per-replica shape
        self._vmapped = self.base.supports_compiled_update and not any(
            isinstance(v, CatBuffer) for v in self.base._defaults.values()
        )
        self._vmap_update: Optional[bool] = None  # None: untried; False: vmap refused, loop the replicas
        if self._vmapped:
            for name, default in self.base._defaults.items():
                self.add_state(
                    name,
                    self._stack(default),
                    dist_reduce_fx=self.base._reductions[name],
                    persistent=self.base._persistent[name],
                )
                # replicas start from the base metric's current state, as copies would
                setattr(self, name, self._stack(getattr(self.base, name)).to(self.device))
            self.metrics: List[Metric] = []
        else:
            self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]

    def _stack(self, value: Tensor) -> Tensor:
        return value.unsqueeze(0).expand(self.num_bootstraps, *value.shape).clone()

    @property
    def supports_compiled_update(self) -> bool:
        """False: the resample indices are drawn on the host at every update,
        and a captured step would freeze one resample pattern."""
        return False

    # ------------------------------------------------------------------ #
    # the stacked-state path
    # ------------------------------------------------------------------ #
    def _stacked_state(self) -> Dict[str, Tensor]:
        return {k: getattr(self, k) for k in self._defaults}

    def _sample_rows(self, size: int) -> List[np.ndarray]:
        # one sampler for both paths, so they draw in the same order
        return [_bootstrap_sampler(size, self.sampling_strategy, self._rng) for _ in range(self.num_bootstraps)]

    def _replica_update(self, state: Dict[str, Tensor], args: tuple, kwargs: Dict[str, Any]) -> Dict[str, Tensor]:
        return self.base.update_state(state, *args, **kwargs)

    def _advance(self, sub_state: Dict[str, Tensor], idx: Tensor, args: tuple, kwargs: Dict[str, Any]) -> Dict[str, Tensor]:
        """The replicas of ``sub_state`` advanced by their resampled rows
        ``idx`` (R, length): vmapped where vmap takes the base's update,
        else one replica at a time."""
        if self._vmap_update is not False:
            sub_args = apply_to_collection(args, Tensor, lambda x: x[idx])
            sub_kwargs = apply_to_collection(kwargs, Tensor, lambda x: x[idx])
            try:
                # the value checks are off, as under the JAX package's jit(vmap(...)) trace
                with _checks_off():
                    out = torch.func.vmap(self._replica_update, in_dims=(0, _in_dims(sub_args), _in_dims(sub_kwargs)))(
                        sub_state, sub_args, sub_kwargs
                    )
            except (RuntimeError, Uncapturable):  # vmap refuses the base's update (a host read, an in-place write)
                if self._vmap_update:
                    raise
                self._vmap_update = False
            else:
                self._vmap_update = True
                return out
        rows = []
        for j in range(idx.shape[0]):
            rows.append(self._replica_update(
                {k: v[j] for k, v in sub_state.items()},
                apply_to_collection(args, Tensor, lambda x: x.index_select(0, idx[j])),
                apply_to_collection(kwargs, Tensor, lambda x: x.index_select(0, idx[j])),
            ))
        return {k: torch.stack([r[k] for r in rows]) for k in sub_state}

    def _update_stacked(self, size: int, args: Any, kwargs: Any) -> None:
        rows = self._sample_rows(size)
        by_len: Dict[int, List[int]] = {}
        for replica, row in enumerate(rows):
            if len(row):  # an empty poisson draw skips its replica
                by_len.setdefault(len(row), []).append(replica)
        if not by_len:
            return
        groups = sorted(by_len.items())
        # every group's rows and replica ids in one copy to the device
        flat = np.concatenate(
            [rows[r] for _, replicas in groups for r in replicas] + [np.asarray(replicas) for _, replicas in groups]
        ).astype(np.int64)
        flat = torch.from_numpy(flat).to(self.device)
        state = self._stacked_state()
        rows_at, ids_at = 0, sum(length * len(replicas) for length, replicas in groups)
        for length, replicas in groups:
            n = len(replicas)
            idx = flat[rows_at : rows_at + n * length].view(n, length)
            ridx = flat[ids_at : ids_at + n]
            rows_at, ids_at = rows_at + n * length, ids_at + n
            new_sub = self._advance({k: s.index_select(0, ridx) for k, s in state.items()}, idx, args, kwargs)
            state = {k: s.index_copy(0, ridx, new_sub[k].to(s.dtype)) for k, s in state.items()}
        for k, v in state.items():
            setattr(self, k, v)

    # ------------------------------------------------------------------ #
    # facade
    # ------------------------------------------------------------------ #
    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        """Resample the inputs along dim 0 once per replica and advance it."""
        args_sizes = apply_to_collection(args, Tensor, lambda x: x.shape[0])
        kwargs_sizes = apply_to_collection(kwargs, Tensor, lambda x: x.shape[0])
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = list(kwargs_sizes.values())[0]
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")

        if self._vmapped:
            self._update_stacked(size, args, kwargs)
            return
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, sampling_strategy=self.sampling_strategy, rng=self._rng)
            if sample_idx.size == 0:
                continue
            rows = torch.from_numpy(sample_idx.astype(np.int64)).to(self.device)
            new_args = apply_to_collection(args, Tensor, lambda x: x.index_select(0, rows))
            new_kwargs = apply_to_collection(kwargs, Tensor, lambda x: x.index_select(0, rows))
            self.metrics[idx].update(*new_args, **new_kwargs)

    def _replica_values(self) -> Tensor:
        if not self._vmapped:
            return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        state = self._stacked_state()
        try:
            return torch.as_tensor(torch.func.vmap(self.base.compute_state)(state))
        except (RuntimeError, Uncapturable):  # a compute with host control flow goes replica by replica
            rows = [{k: v[i] for k, v in state.items()} for i in range(self.num_bootstraps)]
            return torch.stack([torch.as_tensor(self.base.compute_state(r)) for r in rows], dim=0)

    def compute(self) -> Dict[str, Tensor]:
        """Mean, std, quantiles and the raw values over the replicas."""
        computed_vals = self._replica_values()
        stats_vals = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = stats_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = stats_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=stats_vals.dtype, device=stats_vals.device)
            output_dict["quantile"] = torch.quantile(stats_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        super().reset()
        for m in self.metrics:
            m.reset()
