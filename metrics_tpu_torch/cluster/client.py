"""The shard-aware client: route directly, follow redirects when stale.

Counterpart of ``metrics_tpu/cluster/client.py``.

:class:`ClusterClient` holds a *copy* of the shard map and routes every
``post`` / ``post_steps`` / ``read`` straight to the owning replica — the
common case costs zero extra hops. The copy is allowed to go stale: a replica
that stopped owning a tenant answers ``307`` (HTTP) or an admission with
reason ``"not_owner"`` (in-process), both stamped with
``X-Metrics-Shard-Epoch``; the client refreshes its map from the coordinator
and retries, bounded by ``max_redirects``. A fenced tenant (live migration in
flight) surfaces as an ordinary 429-with-``Retry-After`` verdict — callers
that honor backpressure (``post_with_retry``) ride through a migration
without code changes: retry, get redirected after cutover, land on the new
owner.

Replica targets may be in-process stacks (:class:`IngestPipeline` /
:class:`Replica`) or base URLs of :class:`IngestServer` instances — mixed
freely, which is how the tests drive a 3-replica cluster in one process.
"""
from __future__ import annotations

import time
import urllib.request
import json as _json
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np

from metrics_tpu_torch.serve.client import IngestClient
from metrics_tpu_torch.serve.server import IngestPipeline, IngestServer, UnknownTenant
from metrics_tpu_torch.cluster.replica import Replica, ReplicaLost
from metrics_tpu_torch.cluster.shardmap import ShardMap

__all__ = ["ClusterClient"]

MapSource = Union[Callable[[], ShardMap], str, Any]


class ClusterClient:
    """Route to the owning replica; refresh-and-retry on a stale map."""

    def __init__(
        self,
        targets: Dict[str, Any],
        map_source: MapSource,
        timeout: float = 10.0,
        max_redirects: int = 4,
    ) -> None:
        self.timeout = float(timeout)
        self.max_redirects = int(max_redirects)
        self._targets: Dict[str, Any] = {}
        for rid, target in targets.items():
            if isinstance(target, Replica):
                target = target.pipeline
            if isinstance(target, IngestServer):
                target = IngestClient(target.url, timeout=timeout)
            elif isinstance(target, str):
                target = IngestClient(target, timeout=timeout)
            self._targets[rid] = target
        self._map_source = map_source
        self.shard_map = self._fetch_map()
        self.redirects_followed = 0

    # ------------------------------------------------------------------ #
    def _fetch_map(self) -> ShardMap:
        source = self._map_source
        if isinstance(source, str):
            with urllib.request.urlopen(
                f"{source.rstrip('/')}/shardmap", timeout=self.timeout
            ) as resp:
                return ShardMap.from_dict(_json.loads(resp.read().decode()))
        if callable(source):
            return source()
        return source.shard_map  # a ClusterCoordinator

    def refresh_map(self) -> ShardMap:
        self.shard_map = self._fetch_map()
        return self.shard_map

    def _owner_target(self, tenant_id: Any) -> Any:
        owner = self.shard_map.owner(tenant_id)
        target = self._targets.get(owner)
        if target is None:
            # the map knows a replica this client has no handle for (it was
            # added after construction) — refresh targets cannot help, fail loud
            raise KeyError(
                f"shard map routes {tenant_id!r} to {owner!r}, but this client "
                f"only knows {sorted(self._targets)}"
            )
        return target

    def add_target(self, replica_id: str, target: Any) -> None:
        if isinstance(target, Replica):
            target = target.pipeline
        if isinstance(target, IngestServer):
            target = IngestClient(target.url, timeout=self.timeout)
        elif isinstance(target, str):
            target = IngestClient(target, timeout=self.timeout)
        self._targets[replica_id] = target

    # ------------------------------------------------------------------ #
    @staticmethod
    def _local_verdict(admission: Any) -> Dict[str, Any]:
        if admission.admitted:
            return {
                "admitted": True, "seq": admission.seq,
                "queue_depth": admission.queue_depth, "status": 200,
            }
        status = 503 if admission.reason in ("draining", "fault") else 429
        if admission.reason == "not_owner":
            status = 307
        return {
            "admitted": False, "reason": admission.reason,
            "queue_depth": admission.queue_depth, "status": status,
            "retry_after_s": admission.retry_after_s,
        }

    def _stale(self, doc: Dict[str, Any]) -> bool:
        return doc.get("status") == 307 or doc.get("reason") == "not_owner" or (
            doc.get("error") == "not_owner"
        )

    def post(self, tenant_id: Any, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """POST one batch to the owner; rejections are data, never raised."""
        doc: Dict[str, Any] = {}
        for _ in range(self.max_redirects + 1):
            target = self._owner_target(tenant_id)
            if isinstance(target, IngestClient):
                doc = target.post(tenant_id, *args, **kwargs)
            else:
                doc = self._local_verdict(target.post(tenant_id, *args, **kwargs))
            if not self._stale(doc):
                return doc
            self.redirects_followed += 1
            self.refresh_map()
        return doc

    def post_steps(self, tenant_id: Any, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """POST a multi-step batch (leading step axis) to the owner."""
        doc: Dict[str, Any] = {}
        for _ in range(self.max_redirects + 1):
            target = self._owner_target(tenant_id)
            if isinstance(target, IngestClient):
                doc = target.post_steps(tenant_id, *args, **kwargs)
            else:
                doc = self._post_steps_local(target, tenant_id, args, kwargs)
            if not self._stale(doc):
                return doc
            self.redirects_followed += 1
            self.refresh_map()
        return doc

    def _post_steps_local(
        self, pipeline: IngestPipeline, tenant_id: Any, args: Any, kwargs: Any,
    ) -> Dict[str, Any]:
        # mirror the HTTP server's batched-body semantics: admit per-step
        # slices in order, stop at the first rejection
        arrays = [np.asarray(a) for a in args]
        kw_arrays = {k: np.asarray(v) for k, v in kwargs.items()}
        lead = {a.shape[0] for a in (*arrays, *kw_arrays.values()) if a.ndim}
        if len(lead) != 1:
            raise ValueError("every array must share one leading step axis")
        steps = lead.pop()
        seqs = []
        admission = None
        for i in range(steps):
            admission = pipeline.post(
                tenant_id,
                *(a[i] for a in arrays),
                **{k: v[i] for k, v in kw_arrays.items()},
            )
            if not admission.admitted:
                break
            seqs.append(admission.seq)
        doc = self._local_verdict(admission)
        doc.update(steps=steps, admitted_steps=len(seqs), seqs=seqs)
        return doc

    def post_with_retry(
        self,
        tenant_id: Any,
        *args: Any,
        max_attempts: int = 8,
        max_backoff_s: float = 0.2,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """POST, honoring ``Retry-After`` on 429/503 — this is the loop that
        rides through a live migration: fenced → retry → redirected → done."""
        doc: Dict[str, Any] = {}
        for _ in range(max_attempts):
            doc = self.post(tenant_id, *args, **kwargs)
            if doc.get("admitted") or doc.get("status") not in (429, 503):
                return doc
            time.sleep(min(doc.get("retry_after_s", 0.05), max_backoff_s))
        return doc

    # ------------------------------------------------------------------ #
    def read(
        self,
        tenant_id: Any,
        max_staleness_steps: Optional[int] = None,
        timeout_s: Optional[float] = None,
        quantiles: Optional[Sequence[float]] = None,
    ) -> Dict[str, Any]:
        """Read from the owner (staleness contract included)."""
        doc: Dict[str, Any] = {}
        for _ in range(self.max_redirects + 1):
            target = self._owner_target(tenant_id)
            if isinstance(target, IngestClient):
                doc = target.read(
                    tenant_id, max_staleness_steps=max_staleness_steps,
                    timeout_s=timeout_s, quantiles=quantiles,
                )
            else:
                try:
                    gate = target.shard_gate
                    info = gate.check(tenant_id) if gate is not None else None
                    if info is not None:
                        doc = {"status": 307, "error": "not_owner",
                               "owner": info["owner"], "epoch": info["epoch"]}
                    else:
                        doc = dict(target.read(
                            tenant_id, max_staleness_steps=max_staleness_steps,
                            timeout_s=timeout_s, quantiles=quantiles,
                        ))
                        doc["status"] = 200
                except UnknownTenant:
                    doc = {"status": 404, "error": f"unknown tenant {tenant_id!r}"}
                except ReplicaLost as err:
                    doc = {"status": 503, "error": str(err), "reason": "replica_lost"}
            if not self._stale(doc):
                return doc
            self.redirects_followed += 1
            self.refresh_map()
        return doc
