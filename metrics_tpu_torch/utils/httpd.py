"""Shared stdlib HTTP-server lifecycle: bind, port 0, daemon thread, fallback.

Counterpart of ``metrics_tpu/utils/httpd.py``. The observability scrape
server (:mod:`metrics_tpu_torch.observability.server`) runs this lifecycle,
as the JAX package's ingestion front-end will when it is ported:

* bind a ``ThreadingHTTPServer`` on ``host:port``, 127.0.0.1 by default,
  where ``port=0`` means "OS-assigned, read the real one back after start";
* serve on a **daemon** thread, so the process never hangs on exit because a
  telemetry socket is still open;
* stop by ``shutdown() + server_close() + join()``, so tests and restarts
  never leak a bound socket or an orphaned thread;
* **a taken port must never kill the job**: when the bind fails with
  ``OSError`` and the caller supplied a fallback, degrade to the fallback
  handle instead of raising.

Pure stdlib: no torch, no numpy.
"""
from __future__ import annotations

import os
import threading
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Optional, TypeVar

T = TypeVar("T")


class DaemonHTTPServer:
    """A ``ThreadingHTTPServer`` bound to a daemon thread, with idempotent
    ``start``/``stop``.

    ``port=0`` (the default) binds an OS-assigned ephemeral port — read the
    real one back from :attr:`port` / :attr:`url` after :meth:`start`.
    ``start`` raises ``OSError`` when the port is taken; callers that must
    survive that wrap the call in :func:`start_with_fallback`.
    """

    def __init__(
        self,
        handler_cls: type,
        host: str = "127.0.0.1",
        port: int = 0,
        thread_name: str = "metrics-tpu-httpd",
    ) -> None:
        self.handler_cls = handler_cls
        self.host = host
        self.requested_port = int(port)
        self.thread_name = thread_name
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        """The bound port (the requested one until :meth:`start` binds)."""
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "DaemonHTTPServer":
        """Bind and start serving on a daemon thread; returns ``self``.

        Idempotent: a second call on a live server is a no-op. Raises
        ``OSError`` when the port is taken.
        """
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.requested_port), self.handler_cls)
        httpd.daemon_threads = True
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"{self.thread_name}:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop serving, close the socket, and join the thread. Idempotent."""
        httpd, thread = self._httpd, self._thread
        self._httpd, self._thread = None, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout)


def resolve_port(port: Optional[int], env_var: str) -> int:
    """The effective port: the argument, else ``$env_var``, else 0 (OS-assigned)."""
    if port is not None:
        return int(port)
    return int(os.environ.get(env_var, "0") or "0")


def start_with_fallback(
    start: Callable[[], T],
    fallback: Optional[Callable[[OSError], Any]] = None,
) -> Any:
    """Run ``start()``; on a bind ``OSError`` degrade to ``fallback(err)``.

    The "taken port never kills a shared-pod job" rule, shared by both
    servers: with no fallback the ``OSError`` propagates (the caller opted
    out), with one the job keeps running on the degraded handle.
    """
    try:
        return start()
    except OSError as err:
        if fallback is None:
            raise
        return fallback(err)
