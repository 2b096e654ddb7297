"""Off-host telemetry: a background HTTP scrape server, stdlib-only.

Counterpart of ``metrics_tpu/observability/server.py``. It exposes the live
instrument registry and tracer over HTTP from a daemon thread:

* ``GET /metrics``: :func:`~metrics_tpu_torch.observability.export.to_prometheus_text`
  (the Prometheus text exposition format);
* ``GET /stats.json``: the same samples as a JSON document;
* ``GET /trace``: the tracer buffer as Chrome trace-event JSON (empty but
  valid while tracing is off), shard-annotated so scraped traces feed
  straight into :func:`~metrics_tpu_torch.observability.shards.merge_trace_shards`;
* ``GET /healthz``: liveness (uptime, tracing state, ring fill, pid, host).

Every handler only *reads*: registry samples are assembled from the live
engines' counters (plain attribute reads behind the GIL, never a tensor)
and the tracer endpoint snapshots the ring, so a scrape landing during an
``update()`` neither blocks nor corrupts it, and reads nothing from the card.

Lifecycle: :func:`serve` starts the process-wide server (port from the
argument or ``METRICS_TPU_OBS_PORT``; port 0 = OS-assigned; host 127.0.0.1
by default), :func:`shutdown` stops it and joins the thread. The bind,
port-0 and daemon-thread mechanics live in :mod:`metrics_tpu_torch.utils.httpd`.
Hosts that cannot accept inbound connections use the **push-to-spool
fallback**: pass ``spool_dir=`` (or set ``METRICS_TPU_OBS_SPOOL``) and a
bind failure degrades to a :class:`TraceSpool` handle whose
:meth:`TraceSpool.flush` writes this host's trace shard into the shared
directory for a central merger to sweep.

The server observes itself: handler latency lands in a
``metrics_tpu_obs_scrape_seconds{endpoint=...}`` histogram. Each GET is the
``server/scrape`` chaos site; an injected fault answers 500 and the server
keeps serving.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional, Tuple, Union

from metrics_tpu_torch.observability import export as _export
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import shards as _shards
from metrics_tpu_torch.observability import tracer as _tracer
from metrics_tpu_torch.utils import httpd as _httpd

PORT_ENV = "METRICS_TPU_OBS_PORT"
SPOOL_ENV = "METRICS_TPU_OBS_SPOOL"

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

ENDPOINTS = ("/metrics", "/stats.json", "/trace", "/healthz")


class _Handler(BaseHTTPRequestHandler):
    # the server instance injects itself as `obs_server` on the class created
    # per-ObservabilityServer (see _make_handler); no global lookups
    obs_server: "ObservabilityServer"

    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass  # scrapes are telemetry, not log lines

    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        t0 = time.perf_counter()
        try:
            # imported lazily: observability.__init__ pulls this module in, so
            # a top-level resilience import would be circular
            from metrics_tpu_torch.resilience import chaos as _chaos

            if _chaos.active:
                _chaos.maybe_fail("server/scrape", path=path)
            handler = {
                "/metrics": self._get_metrics,
                "/stats.json": self._get_stats,
                "/trace": self._get_trace,
                "/healthz": self._get_healthz,
            }.get(path)
            if handler is None:
                self._send(404, "text/plain; charset=utf-8",
                           f"unknown path {path!r}; endpoints: {', '.join(ENDPOINTS)}\n".encode())
                return
            handler()
        except BrokenPipeError:
            return  # scraper went away mid-response; nothing to do
        except Exception as err:  # noqa: BLE001 — a scrape must never kill the thread
            try:
                self._send(500, "text/plain; charset=utf-8",
                           f"{type(err).__name__}: {err}\n".encode())
            except Exception:
                pass
        finally:
            self.obs_server.observe_scrape(path, time.perf_counter() - t0)

    def _get_metrics(self) -> None:
        body = _export.to_prometheus_text(self.obs_server.registry).encode()
        self._send(200, PROMETHEUS_CONTENT_TYPE, body)

    def _get_stats(self) -> None:
        body = json.dumps(_export.to_metrics_json(self.obs_server.registry)).encode()
        self._send(200, "application/json", body)

    def _get_trace(self) -> None:
        doc = _shards.build_trace_shard(host_id=self.obs_server.host_id)
        self._send(200, "application/json", json.dumps(doc, separators=(",", ":")).encode())

    def _get_healthz(self) -> None:
        tracer = _tracer.get_tracer()
        body = json.dumps({
            "status": "ok",
            "uptime_s": round(time.monotonic() - self.obs_server.started_monotonic, 3),
            "tracing": _tracer.enabled(),
            "events": len(tracer) if tracer is not None else 0,
            "dropped_events": tracer.dropped if tracer is not None else 0,
            "pid": os.getpid(),
            "host_id": self.obs_server.host_id,
        }).encode()
        self._send(200, "application/json", body)


def _make_handler(server: "ObservabilityServer") -> type:
    return type("ObservabilityHandler", (_Handler,), {"obs_server": server})


class ObservabilityServer:
    """The background scrape server; usually managed through :func:`serve`.

    ``port=0`` (the default) binds an OS-assigned ephemeral port — read the
    real one back from :attr:`port` / :attr:`url` after :meth:`start`.
    """

    kind = "http"

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional["_instruments.InstrumentRegistry"] = None,
        host_id: Optional[str] = None,
    ) -> None:
        self.requested_port = int(port)
        self.host = host
        self.registry = registry if registry is not None else _instruments.get_registry()
        self.host_id = host_id if host_id is not None else _shards.default_host_id()
        self.started_monotonic = time.monotonic()
        # the shared bind/port-0/daemon-thread lifecycle (utils/httpd.py)
        self._life = _httpd.DaemonHTTPServer(
            _make_handler(self), host=host, port=port,
            thread_name="metrics-tpu-obs-server",
        )

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        """The bound port (only meaningful after :meth:`start`)."""
        return self._life.port

    @property
    def url(self) -> str:
        return self._life.url

    @property
    def running(self) -> bool:
        return self._life.running

    @property
    def _thread(self) -> Optional[threading.Thread]:
        # kept for introspection/back-compat (tests join on it)
        return self._life._thread

    def start(self) -> "ObservabilityServer":
        """Bind and start serving on a daemon thread; returns ``self``.

        Raises ``OSError`` when the port is taken — :func:`serve` turns that
        into the spool fallback.
        """
        was_running = self._life.running
        self._life.start()
        if not was_running:
            self.started_monotonic = time.monotonic()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop serving, close the socket, and join the thread."""
        self._life.stop(timeout)

    # ------------------------------------------------------------------ #
    def observe_scrape(self, path: str, seconds: float) -> None:
        endpoint = path if path in ENDPOINTS else "other"
        self.registry.histogram(
            "obs_scrape_seconds",
            help="Wall time spent serving one scrape request.",
            endpoint=endpoint,
        ).observe(seconds)
        self.registry.counter(
            "obs_scrapes_total",
            help="Scrape requests served, by endpoint.",
            endpoint=endpoint,
        ).inc()


class TraceSpool:
    """Push-to-spool fallback handle (see :func:`serve`).

    Presents the same ``stop()`` surface as the server so callers can hold
    either without caring which they got; :meth:`flush` writes this host's
    current trace shard into the spool directory.
    """

    kind = "spool"
    running = False

    def __init__(self, directory: Union[str, "os.PathLike"],
                 host_id: Optional[str] = None,
                 reason: str = "") -> None:
        self.directory = os.fspath(directory)
        self.host_id = host_id if host_id is not None else _shards.default_host_id()
        self.reason = reason
        os.makedirs(self.directory, exist_ok=True)

    def flush(self) -> str:
        """Write/overwrite this host's shard in the spool dir; returns path."""
        return _shards.write_trace_shard(self.directory, host_id=self.host_id)

    def stop(self, timeout: float = 0.0) -> None:
        pass


ServerOrSpool = Union[ObservabilityServer, TraceSpool]

# process-wide singleton managed by serve()/shutdown()
_server: Optional[ServerOrSpool] = None
_server_lock = threading.Lock()


def serve(
    port: Optional[int] = None,
    host: str = "127.0.0.1",
    spool_dir: Optional[Union[str, "os.PathLike"]] = None,
    registry: Optional["_instruments.InstrumentRegistry"] = None,
    host_id: Optional[str] = None,
) -> ServerOrSpool:
    """Start (or return) the process-wide scrape server.

    ``port`` defaults to ``$METRICS_TPU_OBS_PORT``, else 0 (OS-assigned).
    When binding fails (port already taken — the usual cause on a shared
    host) and a spool directory is available (``spool_dir=`` or
    ``$METRICS_TPU_OBS_SPOOL``), degrades to the :class:`TraceSpool`
    push fallback instead of raising. Idempotent: a second call returns the
    live handle.
    """
    global _server
    with _server_lock:
        if _server is not None and (_server.kind == "spool" or _server.running):
            return _server
        port = _httpd.resolve_port(port, PORT_ENV)
        if spool_dir is None:
            spool_dir = os.environ.get(SPOOL_ENV) or None
        fallback = None
        if spool_dir is not None:
            fallback = lambda err: TraceSpool(  # noqa: E731
                spool_dir, host_id=host_id,
                reason=f"bind {host}:{port} failed: {err}",
            )
        _server = _httpd.start_with_fallback(
            lambda: ObservabilityServer(
                port=port, host=host, registry=registry, host_id=host_id,
            ).start(),
            fallback,
        )
        return _server


def get_server() -> Optional[ServerOrSpool]:
    """The live process-wide server/spool handle (``None`` when stopped)."""
    return _server


def shutdown(timeout: float = 5.0) -> None:
    """Stop the process-wide server (if any) and join its thread. Idempotent."""
    global _server
    with _server_lock:
        server, _server = _server, None
    if server is not None:
        server.stop(timeout)
