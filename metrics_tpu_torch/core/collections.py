"""MetricCollection: a dict of metrics with static compute groups.

Counterpart of ``metrics_tpu/core/collections.py``. Groups come from
``Metric._update_signature()`` at construction: metrics whose updates
provably produce identical state (the stat-scores family with equal init
args) declare equal keys, the collection updates only each group's leader
and its members share the leader's state tensors by reference. ``compute()``
syncs once per group, through its leader, and computes every member on the
shared synced state.

``update()`` and ``compute()`` dispatch through the partition-aware
dispatcher of ``core/engine.py``: the fused groups run as one captured step
(from the second call of each signature), ``batch_buckets`` leaders through
their own bucketed engines, the rest eagerly. While fused updates advance only
the leaders, the members are detached, and they take the leader's state again
at the next observation (``compute()``, ``items()``, ``values()``, ``[]``), so
they see every replay's counts. A synced compute stays eager.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist
import torch.utils._pytree as pytree

from metrics_tpu_torch.core.metric import Metric, StateDict


class MetricCollection:
    """Ordered dict of metrics sharing one call signature.

    Args:
        metrics: a Metric, a sequence of Metrics, or a dict name->Metric.
        additional_metrics: more metrics when ``metrics`` is a single one.
        prefix / postfix: added to every output key.
        compute_groups: enable static compute-group sharing (default True).
        compiled_update: dispatch ``update()`` through one captured step over
            the fused groups. ``None`` follows the global switch; ``False``
            keeps the eager per-group loop (members' own engines still apply).
        fused_update: the dedicated switch for the same fused engine, layered
            on ``compiled_update``: it runs only when both allow it. ``None``
            follows :func:`~metrics_tpu_torch.set_fused_update`.
        compiled_compute: dispatch ``compute()`` through one captured step
            over the fused groups' states. ``None`` follows the global switch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, Recall
        >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
        >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
        >>> metrics = MetricCollection([
        ...     Accuracy(device="cpu"),
        ...     Recall(num_classes=3, average="macro", device="cpu"),
        ... ])
        >>> metrics.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metrics.compute().items()}
        {'Accuracy': 0.125, 'Recall': 0.1111}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: bool = True,
        compiled_update: Optional[bool] = None,
        compiled_compute: Optional[bool] = None,
        fused_update: Optional[bool] = None,
    ) -> None:
        self._metrics: Dict[str, Metric] = {}
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups: List[List[str]] = []
        self._compiled_update = compiled_update
        self._compiled_compute = compiled_compute
        self._fused_update = fused_update
        # the partition-aware dispatcher, built at the first dispatch;
        # _update_engine/_compute_engine mirror its fused-subset engines
        self._dispatcher: Any = None
        self._update_engine: Any = None
        self._compute_engine: Any = None
        # True while fused updates advance only the leaders (members detached)
        self._members_stale = False
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def add_metrics(self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric) -> None:
        """Add metrics to the collection."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"MetricCollection received positional arguments that are not Metric instances: {remain}"
                )
        elif additional_metrics:
            raise ValueError(
                f"MetricCollection was given a dict of metrics plus extra positional arguments "
                f"{additional_metrics}; pass either a single dict or a sequence of metrics, not both."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"MetricCollection entry {name!r} must be a Metric or "
                        f"MetricCollection, got {type(metric).__name__}: {metric!r}"
                    )
                if isinstance(metric, Metric):
                    self._metrics[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._metrics[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"MetricCollection members must be Metric or MetricCollection "
                        f"instances, got {type(metric).__name__}: {metric!r}"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._metrics:
                        raise ValueError(
                            f"Two metrics in the sequence share the class name {name!r}; "
                            "use a dict of metrics to give them distinct keys."
                        )
                    self._metrics[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._metrics[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")
        self._rebuild_groups()

    def _realias_members(self) -> None:
        """Give every group member its leader's state again (the members a
        fused streak detached)."""
        if not self._members_stale:
            return
        self._members_stale = False
        for group in self._groups:
            if len(group) > 1:
                self._share_leader_state(group)

    def _share_leader_state(self, group: Sequence[str]) -> None:
        leader = self._metrics[group[0]]
        state = leader.get_state()
        # shared tensors are never written in place by any member's engine
        shared = frozenset(id(leaf) for leaf in pytree.tree_leaves(state))
        leader._shared_state_ids = shared
        for name in group[1:]:
            m = self._metrics[name]
            m.set_state(state)
            m._update_count = leader._update_count
            m._computed = None
            m._shared_state_ids = shared

    def _rebuild_groups(self) -> None:
        """Static grouping by update signature. Members are made whole first,
        and the dispatcher and its engines are dropped: group membership is
        baked into the partition and the captured steps."""
        self._realias_members()
        self._dispatcher = None
        self._update_engine = None
        self._compute_engine = None
        self._groups = []
        if not self._enable_compute_groups:
            self._groups = [[k] for k in self._metrics]
            return
        sig_to_group: Dict[Hashable, List[str]] = {}
        for name, metric in self._metrics.items():
            sig = metric._update_signature()
            if sig is None:
                self._groups.append([name])
            else:
                sig_to_group.setdefault(sig, []).append(name)
        self._groups.extend(sig_to_group.values())

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """Group index -> member names."""
        return {i: list(g) for i, g in enumerate(self._groups)}

    # ------------------------------------------------------------------ #
    # dict interface with prefix/postfix handling
    # ------------------------------------------------------------------ #
    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def keys(self, keep_base: bool = False) -> List[str]:
        if keep_base:
            return list(self._metrics.keys())
        return [self._set_name(k) for k in self._metrics.keys()]

    def items(self, keep_base: bool = False) -> List[Tuple[str, Metric]]:
        self._realias_members()
        if keep_base:
            return list(self._metrics.items())
        return [(self._set_name(k), v) for k, v in self._metrics.items()]

    def values(self) -> List[Metric]:
        self._realias_members()
        return list(self._metrics.values())

    def __getitem__(self, key: str) -> Metric:
        self._realias_members()
        if key in self._metrics:
            return self._metrics[key]
        for k in self._metrics:  # lookup by prefixed name
            if self._set_name(k) == key:
                return self._metrics[k]
        raise KeyError(key)

    def __setitem__(self, key: str, metric: Metric) -> None:
        self._metrics[key] = metric
        self._rebuild_groups()

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    # ------------------------------------------------------------------ #
    # metric interface
    # ------------------------------------------------------------------ #
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Per-member forward (batch value + accumulation)."""
        self._realias_members()
        res = {self._set_name(k): m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._metrics.items()}
        return _flatten_results(res)

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def _fused_update_enabled(self) -> bool:
        """Whether ``update()`` may take the dispatcher's fused engine (the
        ``fused_update`` switch, then the ``compiled_update`` umbrella; the
        collection's flags beat the global ones)."""
        from metrics_tpu_torch.core import engine as _engine

        fused = self._fused_update
        if fused is None:
            fused = _engine.fused_update_enabled()
        enabled = self._compiled_update
        if enabled is None:
            enabled = _engine.compiled_update_enabled()
        return bool(fused) and bool(enabled)

    def _fused_compute_enabled(self) -> bool:
        from metrics_tpu_torch.core import engine as _engine

        enabled = self._compiled_compute
        if enabled is None:
            enabled = _engine.compiled_compute_enabled()
        return bool(enabled)

    def _get_dispatcher(self) -> Any:
        """The partition-aware dispatcher, built at the first dispatch."""
        from metrics_tpu_torch.core import engine as _engine

        if self._dispatcher is None:
            self._dispatcher = _engine.CollectionDispatcher(self)
        return self._dispatcher

    def engine_stats(self) -> Dict[str, Any]:
        """Dispatch counters and fallback reasons across the collection:
        ``update``/``compute`` are the fused engines' ``EngineStats`` (None
        until built), ``members`` each member's :meth:`Metric.engine_stats`,
        ``fallback_reasons`` every recorded reason (members' keyed
        ``"<member>.<kind>:<Class>"``), ``partition`` the dispatcher's view."""
        from metrics_tpu_torch.core import engine as _engine

        stats = _engine.engine_stats_view(self._update_engine, self._compute_engine)
        reasons: Dict[str, str] = stats["fallback_reasons"]
        members: Dict[str, Any] = {}
        for name in self._metrics:
            member_stats = self[name].engine_stats()
            members[name] = member_stats
            for key, why in member_stats["fallback_reasons"].items():
                reasons[f"{name}.{key}"] = why
        stats["members"] = members
        if self._dispatcher is not None:
            for key, why in self._dispatcher._retired_reasons.items():
                reasons.setdefault(key, why)
        stats["partition"] = _engine.collection_partition_view(self)
        return stats

    def update(self, *args: Any, **kwargs: Any) -> None:
        """One update per compute group; members share the leader's state.
        With the fused path on, the dispatcher runs the fused groups as one
        captured step and the rest through the loop below."""
        if self._fused_update_enabled():
            self._get_dispatcher().update(args, kwargs)
            return
        self._eager_update_groups(self._groups, args, kwargs)
        self._members_stale = False

    def _eager_update_groups(self, groups: Sequence[Sequence[str]], args: Tuple, kwargs: Dict) -> None:
        """The per-group loop over ``groups``: each leader updates through its
        own facade (its own engine still applies), members take its state."""
        for group in groups:
            leader = self._metrics[group[0]]
            leader.update(*args, **leader._filter_kwargs(**kwargs))
            if len(group) > 1:
                self._share_leader_state(group)

    def compute(self) -> Dict[str, Any]:
        """Value per member: one sync per compute group, through its leader;
        the members compute on the shared synced state; then one unsync. With
        the compiled path on, the fused groups' finalize is one captured step
        (a synced compute stays eager)."""
        self._realias_members()
        if self._fused_compute_enabled():
            return _flatten_results(self._get_dispatcher().compute())
        return _flatten_results(self._eager_compute_groups(self._groups))

    def _eager_compute_groups(self, groups: Sequence[Sequence[str]]) -> Dict[str, Any]:
        """The per-group compute loop over ``groups``; raw results."""
        res: Dict[str, Any] = {}
        for group in groups:
            leader = self._metrics[group[0]]
            leader.sync(should_sync=leader._to_sync)
            synced_state = leader.get_state()
            synced = leader._is_synced
            for name in group:
                m = self._metrics[name]
                if m is not leader:
                    m.set_state(synced_state)
                    m._update_count = leader._update_count
                prev_to_sync, prev_should_unsync = m._to_sync, m._should_unsync
                # the group is synced already: the member's compute neither
                # syncs nor unsyncs the shared state
                m._to_sync, m._should_unsync = False, False
                try:
                    res[self._set_name(name)] = m.compute()
                finally:
                    m._to_sync, m._should_unsync = prev_to_sync, prev_should_unsync
            if synced:
                leader.unsync()
                local = leader.get_state()
                for name in group[1:]:
                    self._metrics[name].set_state(local)
        return res

    def reset(self) -> None:
        # the dispatcher, its partition and the captured steps stay valid
        self._members_stale = False
        for m in self._metrics.values():
            m.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._metrics.values():
            m.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        self._realias_members()
        out: Dict[str, Any] = {}
        for k, m in self._metrics.items():
            out.update(m.state_dict(prefix=f"{k}."))
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        self._realias_members()
        for k, m in self._metrics.items():
            m.load_state_dict(state_dict, prefix=f"{k}.", strict=strict)
        for engine in (self._update_engine, self._compute_engine):
            if engine is not None:
                engine.reset_signature_memos()

    def __getstate__(self) -> Dict[str, Any]:
        """Drop the dispatcher and fused engines (copies rebuild them); never
        copy a detached member."""
        self._realias_members()
        return {k: v for k, v in self.__dict__.items() if k not in ("_dispatcher", "_update_engine", "_compute_engine")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._dispatcher = None
        self._update_engine = None
        self._compute_engine = None

    # ------------------------------------------------------------------ #
    # pure protocol over per-group states
    # ------------------------------------------------------------------ #
    def init_state(self) -> Dict[str, StateDict]:
        """One state per compute group, keyed by leader name."""
        return {g[0]: self._metrics[g[0]].init_state() for g in self._groups}

    def update_state(self, states: Dict[str, StateDict], *args: Any, **kwargs: Any) -> Dict[str, StateDict]:
        """Pure update of every group's state."""
        out = {}
        for group in self._groups:
            leader = self._metrics[group[0]]
            out[group[0]] = leader.update_state(states[group[0]], *args, **leader._filter_kwargs(**kwargs))
        return out

    def compute_state(self, states: Dict[str, StateDict]) -> Dict[str, Any]:
        """Pure compute over per-group states."""
        res = {}
        for group in self._groups:
            for name in group:
                res[self._set_name(name)] = self._metrics[name].compute_state(states[group[0]])
        return _flatten_results(res)

    def sync_states(self, states: Dict[str, StateDict], group: Optional[dist.ProcessGroup]) -> Dict[str, StateDict]:
        """Pure sync over ``group``: one bucketed sync per compute group."""
        return {g[0]: self._metrics[g[0]].sync_states(states[g[0]], group) for g in self._groups}

    def sync_compute_state(
        self, states: Dict[str, StateDict], group: Optional[dist.ProcessGroup] = None
    ) -> Dict[str, Any]:
        """Pure sync, then compute; ``group=None`` skips the sync."""
        if group is not None:
            states = self.sync_states(states, group)
        return self.compute_state(states)

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "(\n"
        for k, v in self._metrics.items():
            repr_str += f"  ({k}): {repr(v)}\n"
        if self.prefix:
            repr_str += f"  prefix={self.prefix}\n"
        if self.postfix:
            repr_str += f"  postfix={self.postfix}\n"
        return repr_str + ")"


def _flatten_results(res: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten nested dict results one level."""
    out: Dict[str, Any] = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(v)
        else:
            out[k] = v
    return out
