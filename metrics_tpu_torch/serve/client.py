"""Stdlib client for the ingestion server, plus the offline-replay oracle.

Counterpart of ``metrics_tpu/serve/client.py``.

:class:`IngestClient` is the reference producer: it speaks both request
bodies (``application/json`` for debuggability, ``application/x-npz`` for
byte-exact array transport — the one the e2e bitwise tests use), surfaces
every admission verdict as a plain dict (a 429/503 is a *result*, not an
exception), and optionally honors ``Retry-After`` with a bounded retry loop.

:func:`offline_replay` is the correctness oracle of the serving stack: feed
it the admitted observation log and a fresh template factory and it replays
every batch through the pure per-tenant protocol — the served state must be
bitwise-equal to its output (stacked-vs-pure parity is already pinned by the
tenancy tests; this extends the same contract across the wire). The clones
live where the factory builds them (the card by default): the posted numpy
rows go to their device, and the results come back to the host explicitly.
"""
from __future__ import annotations

import http.client
import json
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

import torch

from metrics_tpu_torch.serve.server import (
    JSON_CONTENT_TYPE,
    NPZ_CONTENT_TYPE,
    encode_npz,
    encode_npz_steps,
    host_value,
)


class _NoDelayConnection(http.client.HTTPConnection):
    """An HTTP connection with Nagle's algorithm off. ``http.client`` sends a
    body past 2,920 bytes (one observation of 64 x 10 float32 already) after
    the headers, in a second write; with Nagle on, that write waits for the
    server's delayed ACK of the headers, about 40 ms a POST on loopback."""

    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _NoDelayHandler(urllib.request.HTTPHandler):
    def http_open(self, req: urllib.request.Request) -> Any:
        return self.do_open(_NoDelayConnection, req)


# urllib's default handlers (redirects included), with the one above for http
_OPENER = urllib.request.build_opener(_NoDelayHandler)


def _request(req: urllib.request.Request, timeout: float) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
    """``(status, headers, parsed JSON body)`` — HTTP errors are results."""
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        try:
            doc = json.loads(body)
        except ValueError:
            doc = {"error": body}
        return err.code, dict(err.headers), doc


class IngestClient:
    """A thin stdlib HTTP client for one :class:`~metrics_tpu_torch.serve.server.IngestServer`."""

    def __init__(self, base_url: str, timeout: float = 10.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)

    # ------------------------------------------------------------------ #
    def post(
        self,
        tenant_id: Any,
        *args: Any,
        encoding: str = "npz",
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """POST one observation batch; returns the server's verdict dict.

        The returned dict always carries ``status`` (the HTTP code) and, on
        a rejection, ``retry_after_s`` from the ``Retry-After`` header.
        Rejections are returned, never raised — backpressure is data.
        """
        if encoding == "npz":
            body = encode_npz(*args, **kwargs)
            ctype = NPZ_CONTENT_TYPE
        elif encoding == "json":
            body = json.dumps({
                "args": [np.asarray(a).tolist() if isinstance(a, np.ndarray) else a
                         for a in args],
                "kwargs": {k: np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
                           for k, v in kwargs.items()},
            }).encode()
            ctype = JSON_CONTENT_TYPE
        else:
            raise ValueError(f"encoding must be 'npz' or 'json', got {encoding!r}")
        req = urllib.request.Request(
            f"{self.base_url}/ingest/{urllib.parse.quote(str(tenant_id), safe='')}",
            data=body,
            headers={"Content-Type": ctype},
            method="POST",
        )
        status, headers, doc = _request(req, self.timeout)
        doc["status"] = status
        if "Retry-After" in headers:
            doc["retry_after_s"] = float(headers["Retry-After"])
        return doc

    def post_steps(
        self,
        tenant_id: Any,
        *args: Any,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """POST a multi-step batch (leading step axis) in one request.

        Every array must share one leading axis of length ``S``; the server
        admits the ``S`` per-step observations in order and stops at the
        first rejection, reporting ``steps``/``admitted_steps``/``seqs`` so
        the caller knows exactly where to resume. Rejections are returned,
        never raised.
        """
        req = urllib.request.Request(
            f"{self.base_url}/ingest/{urllib.parse.quote(str(tenant_id), safe='')}",
            data=encode_npz_steps(*args, **kwargs),
            headers={"Content-Type": NPZ_CONTENT_TYPE},
            method="POST",
        )
        status, headers, doc = _request(req, self.timeout)
        doc["status"] = status
        if "Retry-After" in headers:
            doc["retry_after_s"] = float(headers["Retry-After"])
        return doc

    def post_with_retry(
        self,
        tenant_id: Any,
        *args: Any,
        max_attempts: int = 8,
        max_backoff_s: float = 0.2,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """POST, honoring ``Retry-After`` on 429/503 up to ``max_attempts``.

        The server's hint is capped at ``max_backoff_s`` so tests stay fast;
        production callers should pass something closer to the hint itself.
        """
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
        """GET one tenant's values + staleness contract (``status`` included).

        ``quantiles`` asks the server to evaluate extra quantiles from the
        tenant's ``QuantileSketch`` states (``doc["quantiles"]``)."""
        params = {}
        if max_staleness_steps is not None:
            params["max_staleness_steps"] = str(int(max_staleness_steps))
        if timeout_s is not None:
            params["timeout_s"] = str(float(timeout_s))
        if quantiles is not None:
            params["quantiles"] = ",".join(repr(float(q)) for q in quantiles)
        query = f"?{urllib.parse.urlencode(params)}" if params else ""
        req = urllib.request.Request(
            f"{self.base_url}/read/{urllib.parse.quote(str(tenant_id), safe='')}{query}"
        )
        status, headers, doc = _request(req, self.timeout)
        doc["status"] = status
        if "Retry-After" in headers:
            doc["retry_after_s"] = float(headers["Retry-After"])
        return doc

    def healthz(self) -> Dict[str, Any]:
        status, _, doc = _request(
            urllib.request.Request(f"{self.base_url}/healthz"), self.timeout)
        doc["status_code"] = status
        return doc

    def stats(self) -> Dict[str, Any]:
        _, _, doc = _request(
            urllib.request.Request(f"{self.base_url}/stats.json"), self.timeout)
        return doc


# --------------------------------------------------------------------------- #
# the offline oracle
# --------------------------------------------------------------------------- #
def offline_replay(
    template_factory: Callable[[], Any],
    observations: Iterable[Tuple[Any, Tuple, Dict[str, Any]]],
) -> Dict[Any, Dict[str, np.ndarray]]:
    """Replay an admitted observation log through the pure protocol.

    ``observations`` is the admission-ordered log of
    ``(tenant_id, args, kwargs)`` triples (what the client posted, in the
    order the queue admitted it). Each tenant gets a fresh stateful clone
    from ``template_factory`` and its batches applied one by one — no
    stacking, no bucketing, no server. Returns ``{tenant_id: {metric:
    np.ndarray}}``, the value the served reads must match bitwise.
    """
    clones: Dict[Any, Any] = {}
    for tenant_id, args, kwargs in observations:
        if tenant_id not in clones:
            clones[tenant_id] = template_factory()
        clone = clones[tenant_id]
        device = _device_of(clone)
        clone.update(
            *(_on(a, device) for a in args), **{k: _on(v, device) for k, v in kwargs.items()}
        )
    return {
        tid: {name: host_value(v) for name, v in clone.compute().items()}
        for tid, clone in clones.items()
    }


def _device_of(metric: Any) -> torch.device:
    """The device of a metric's (or a collection's first member's) state."""
    members = getattr(metric, "_metrics", None)
    if members:
        metric = next(iter(members.values()))
    return metric.device


def _on(leaf: Any, device: torch.device) -> Any:
    if isinstance(leaf, np.ndarray):
        return torch.as_tensor(leaf, device=device)
    return leaf
