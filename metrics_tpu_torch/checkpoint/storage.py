"""Pluggable storage backends behind the checkpoint writer.

Counterpart of ``metrics_tpu/checkpoint/storage.py``. Every byte
:mod:`metrics_tpu_torch.checkpoint.io` moves goes through the process-wide
:class:`Storage` backend selected with :func:`set_storage`. Three ship:

* :class:`LocalStorage`, the default: write to a temporary file, ``fsync``
  it, ``os.replace`` it into place, ``fsync`` the directory; one atomic
  ``os.rename`` publishes the pending directory.
* :class:`ObjectStorage`, an abstract blob-store backend: subclasses provide
  four object primitives (``put_object``/``get_object``/``list_keys``/
  ``delete_object``) and inherit filesystem semantics mapped onto keys. A
  PUT is atomic, so ``write_atomic`` is a plain put; "directories" are key
  prefixes; ``rename`` is copy-then-delete and not atomic, which is safe
  because readers require the ``COMMIT`` marker and
  :meth:`ObjectStorage.rename` copies it last.
* :class:`InMemoryStorage`, a dict-backed :class:`ObjectStorage` for tests.
  Every backend op runs under the chaos harness's ``storage/<op>`` sites
  (:mod:`metrics_tpu_torch.resilience.chaos`), so flakes, latency and torn
  writes replay deterministically.

**Retries**: every op goes through :func:`storage_op`, which fires the chaos
site and wraps the call in
:func:`metrics_tpu_torch.resilience.retry.call_with_retry` under the
process-wide :class:`~metrics_tpu_torch.resilience.retry.RetryPolicy`
(:func:`set_retry_policy`). Transient errors back off and retry (counted in
``metrics_tpu_checkpoint_retries_total`` with ``ckpt/retry`` tracer events);
fatal ones do not.
"""
from __future__ import annotations

import abc
import contextlib
import hashlib
import os
import tempfile
import threading
from typing import Callable, Dict, List, Optional, TypeVar

from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.resilience.retry import RetryPolicy, call_with_retry

T = TypeVar("T")


class Storage(abc.ABC):
    """Byte-level backend contract the checkpoint protocol needs.

    Semantics every implementation must honor:

    * :meth:`write_atomic` — after it returns, ``path`` holds exactly
      ``data``; if it raises, ``path`` is either absent or holds its previous
      complete contents (never a torn write).
    * :meth:`rename` — publishes ``src`` (a directory/prefix) at ``dst``;
      the ``COMMIT`` marker must never be visible at ``dst`` before the rest
      of the snapshot is.
    * :meth:`read_bytes` / :meth:`size` raise ``FileNotFoundError`` for
      missing paths; :meth:`listdir` raises it for missing directories.
    """

    name = "storage"

    @abc.abstractmethod
    def write_atomic(self, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def read_bytes(self, path: str) -> bytes: ...

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def isdir(self, path: str) -> bool: ...

    @abc.abstractmethod
    def listdir(self, path: str) -> List[str]: ...

    @abc.abstractmethod
    def makedirs(self, path: str) -> None: ...

    @abc.abstractmethod
    def delete(self, path: str) -> None: ...

    @abc.abstractmethod
    def delete_tree(self, path: str) -> None: ...

    @abc.abstractmethod
    def rename(self, src: str, dst: str) -> None: ...

    @abc.abstractmethod
    def size(self, path: str) -> int: ...

    def sha256(self, path: str) -> str:
        return hashlib.sha256(self.read_bytes(path)).hexdigest()


# --------------------------------------------------------------------------- #
# local filesystem (the default; today's fsync/rename path, verbatim)
# --------------------------------------------------------------------------- #
def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        _fsync_path(path)
    except OSError:  # some filesystems refuse O_RDONLY on dirs; best effort
        pass


class LocalStorage(Storage):
    """Durable local-filesystem backend (write-temp/fsync/replace)."""

    name = "local"

    def write_atomic(self, path: str, data: bytes) -> None:
        dirname = os.path.dirname(path)
        fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp.", suffix=os.path.basename(path))
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        _fsync_dir(dirname)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        os.unlink(path)

    def delete_tree(self, path: str) -> None:
        # snapshot/pending directories are flat by construction
        for name in os.listdir(path):
            os.unlink(os.path.join(path, name))
        os.rmdir(path)

    def rename(self, src: str, dst: str) -> None:
        os.rename(src, dst)
        _fsync_dir(os.path.dirname(dst) or ".")

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def sha256(self, path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()


# --------------------------------------------------------------------------- #
# object stores (GCS shape): four primitives, directory semantics derived
# --------------------------------------------------------------------------- #
class ObjectStorage(Storage):
    """Abstract blob-store backend. Subclass with the four object primitives
    (for GCS: ``blob.upload_from_string`` / ``blob.download_as_bytes`` /
    ``client.list_blobs(prefix=...)`` / ``blob.delete``); everything the
    checkpoint protocol needs is derived here."""

    name = "object"

    @abc.abstractmethod
    def put_object(self, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get_object(self, key: str) -> bytes:
        """Raises ``FileNotFoundError`` for a missing key."""

    @abc.abstractmethod
    def list_keys(self, prefix: str) -> List[str]: ...

    @abc.abstractmethod
    def delete_object(self, key: str) -> None: ...

    @staticmethod
    def _key(path: str) -> str:
        return path.replace(os.sep, "/").rstrip("/")

    def write_atomic(self, path: str, data: bytes) -> None:
        self.put_object(self._key(path), data)  # object PUTs are atomic

    def read_bytes(self, path: str) -> bytes:
        return self.get_object(self._key(path))

    def exists(self, path: str) -> bool:
        key = self._key(path)
        try:
            self.get_object(key)
            return True
        except FileNotFoundError:
            return self.isdir(path)

    def isdir(self, path: str) -> bool:
        return bool(self.list_keys(self._key(path) + "/"))

    def listdir(self, path: str) -> List[str]:
        prefix = self._key(path) + "/"
        keys = self.list_keys(prefix)
        if not keys:
            raise FileNotFoundError(f"no such object-store directory: {path}")
        children = {k[len(prefix):].split("/", 1)[0] for k in keys}
        return sorted(children)

    def makedirs(self, path: str) -> None:
        pass  # prefixes need no creation

    def delete(self, path: str) -> None:
        self.delete_object(self._key(path))

    def delete_tree(self, path: str) -> None:
        for k in self.list_keys(self._key(path) + "/"):
            self.delete_object(k)

    def rename(self, src: str, dst: str) -> None:
        """Copy-then-delete publish. Not atomic — so the ``COMMIT`` marker is
        copied strictly last (readers require it, exactly like the local
        path's rename makes everything visible at once), and sources are
        deleted only after every copy landed."""
        from metrics_tpu_torch.checkpoint.io import COMMIT_NAME

        skey, dkey = self._key(src) + "/", self._key(dst) + "/"
        keys = sorted(self.list_keys(skey), key=lambda k: k.endswith("/" + COMMIT_NAME))
        for k in keys:
            self.put_object(dkey + k[len(skey):], self.get_object(k))
        for k in keys:
            self.delete_object(k)

    def size(self, path: str) -> int:
        return len(self.get_object(self._key(path)))


class InMemoryStorage(ObjectStorage):
    """Dict-backed object store for tests — fault-injectable via the chaos
    harness's ``storage/<op>`` sites (armed in :func:`storage_op`, so it
    needs no failure logic of its own)."""

    name = "memory"

    def __init__(self) -> None:
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put_object(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get_object(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise FileNotFoundError(f"no such object: {key}") from None

    def list_keys(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete_object(self, key: str) -> None:
        with self._lock:
            if self._objects.pop(key, None) is None:
                raise FileNotFoundError(f"no such object: {key}")

    def __len__(self) -> int:
        return len(self._objects)


# --------------------------------------------------------------------------- #
# process-wide backend + retry-policy selection
# --------------------------------------------------------------------------- #
_default_storage = LocalStorage()
_storage: Storage = _default_storage
_retry_policy: RetryPolicy = RetryPolicy()


def get_storage() -> Storage:
    return _storage


def set_storage(storage: Optional[Storage]) -> None:
    """Select the process-wide backend (``None`` restores LocalStorage)."""
    global _storage
    _storage = storage if storage is not None else _default_storage


@contextlib.contextmanager
def use_storage(storage: Storage):
    """Scoped :func:`set_storage`; restores the prior backend on exit."""
    global _storage
    prev = _storage
    _storage = storage
    try:
        yield storage
    finally:
        _storage = prev


def get_retry_policy() -> RetryPolicy:
    return _retry_policy


def set_retry_policy(policy: Optional[RetryPolicy]) -> None:
    """Select the process-wide retry policy (``None`` restores the default)."""
    global _retry_policy
    _retry_policy = policy if policy is not None else RetryPolicy()


@contextlib.contextmanager
def use_retry_policy(policy: RetryPolicy):
    """Scoped :func:`set_retry_policy`; restores the prior policy on exit."""
    global _retry_policy
    prev = _retry_policy
    _retry_policy = policy
    try:
        yield policy
    finally:
        _retry_policy = prev


def storage_op(op: str, fn: Callable[[], T]) -> T:
    """One retry-wrapped backend op with its chaos fault point armed.

    Every byte :mod:`metrics_tpu_torch.checkpoint.io` moves funnels through here:
    the ``storage/<op>`` fault point fires *inside* the retry loop (so a
    transient injected fault exercises backoff-and-recover, not failure), and
    the active :class:`RetryPolicy` bounds the attempts.
    """
    if not _chaos.active and _retry_policy.max_attempts == 1:
        return fn()

    def attempt() -> T:
        if _chaos.active:
            _chaos.maybe_fail(f"storage/{op}", op=op)
        return fn()

    return call_with_retry(attempt, _retry_policy, op=op)
