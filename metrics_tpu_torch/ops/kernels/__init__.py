"""The heavy-kernel layer: the hand-written CUDA kernels (build with
``nvcc``, load with ``ctypes``, count launches) and the heavy-kernel
registry with its dispatch telemetry.

Each kernel is one ``.cu`` file under ``metrics_tpu_torch/csrc/`` with a
plain C interface. It is compiled for ``sm_90a`` at first use into
``metrics_tpu_torch/_build/`` (git-ignored), under a name keyed by the
source's and the flags' hash, so an edited source rebuilds and an unchanged
one is reused. Nothing is built or loaded when this module is imported: a
host without ``nvcc`` or a card imports it freely and never calls ``lib()``.

Every kernel keeps a plain ``launches`` counter that its wrapper bumps once
per launch (B1's tenant-batched entry, ``binned_counts_batched``, is an entry
of its own that shares B1's library and counts one launch for all its
tenants); ``reset_launch_counts`` and ``launch_counts`` let a run show that
its main path really went through the kernels. The counts are device
launches, not Python calls: a CUDA graph capture runs the wrapper but
launches nothing, and a replay launches what the capture recorded, so the
compiled engines' ``CapturedStep`` records a capture's launches apart
(:func:`recording_launches`) and adds them at every replay.

Several threads may launch at once (a serving replica's dispatcher, HTTP
handlers, the caller). A wrapper counts through :func:`count_launch`, under
one lock; while a thread captures, its launches go to that thread's record
and not to the counters, so another thread's launches made meanwhile are
never taken for the capture's.

**The registry.** :data:`CUDA_KERNELS` holds the CUDA loader's ``Kernel``
entries, one a C entry family. :data:`KERNELS` is the JAX package's
registry of heavy kernels (``metrics_tpu/ops/kernels/__init__.py``): one
:class:`KernelSpec` each for ``iou_matching``, ``cosine_matching`` and
``feature_extract``, the same keys and fields, ``module`` naming the port's
module. The wrappers record their dispatches as the JAX wrappers do: the
``metrics_tpu_heavy_kernel_calls{kernel,impl}`` counter, the
``metrics_tpu_heavy_kernel_bucket_width{kernel}`` histogram on the same pow2
buckets, and a ``kernel/dispatch`` tracer event. Where the port departs:

- ``impl`` is ``"cuda"`` for a dispatch that launches hand kernels and
  ``"torch"`` for the plain versions on the CPU and for torch code such as
  the feature forward (the JAX package's ``jit``; its ``pallas`` and
  ``pallas_interpret`` have no counterpart).
- No fallback: a kernel's build or launch error raises. :func:`record_fallback`
  keeps its series (``metrics_tpu_heavy_kernel_fallbacks``) and its
  ``kernel/fallback`` event, and no wrapper calls it.
- :func:`resolve_use_pallas` keeps the JAX modes and their ``ValueError``,
  reads no environment variable and never answers ``interpret=True``.
- :func:`trace_counts` counts, per kernel and process, each input signature
  (shapes, dtypes, device and the static arguments) the first time a
  wrapper sees it, until :func:`reset_trace_counts`: what a jit cache
  counts, so the same shapes twice count once and ragged widths are bounded
  by their pow2 buckets.
- Dispatches and trace counts are recorded where the wrapper's Python runs:
  eagerly and at a compiled engine's probe, not in a capture's second run or
  the CPU's stand-in for a replay (``parallel.sync._quiet``), and not at a
  replay, which runs no Python, as a jitted JAX body records at trace time
  only. The launch counters above do add a replay's launches, so on a
  compiled path the two counts differ by design.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit's
    default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on the PATH")


@dataclass
class Kernel:
    """One CUDA source, its C entry points and its launch counter."""

    name: str
    source: str  # file name under csrc/
    replaces: str  # the JAX function it replaces, file:line
    signatures: Dict[str, Tuple[Sequence, object]]  # C symbol -> (argtypes, restype)
    shares: Optional[str] = None  # the kernel whose library holds these entries, if not its own
    _launches: int = field(default=0, repr=False)
    build_log: str = ""
    _lib: Optional[ctypes.CDLL] = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def launches(self) -> int:
        """Launches counted so far (a capture in progress on this thread adds
        to its own record instead, see :func:`recording_launches`)."""
        return self._launches

    @launches.setter
    def launches(self, value: int) -> None:
        record = _recording()
        with _COUNT_LOCK:
            if record is None:
                self._launches = int(value)
            else:
                record[self.name] = record.get(self.name, 0) + int(value) - self._launches

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source_path.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def build(self) -> Path:
        """Compile the source unless this exact build exists; return the library."""
        target = self.library_path()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{self.name}-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source_path)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {self.source} (exit {proc.returncode}):\n{self.build_log}")
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a library
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return target

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        with self._lock:
            if self._lib is None:
                lib = CUDA_KERNELS[self.shares].lib() if self.shares else ctypes.CDLL(str(self.build()))
                for symbol, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                self._lib = lib
            return self._lib


CUDA_KERNELS: Dict[str, Kernel] = {
    "binned_counts": Kernel(
        name="binned_counts",
        source="binned_counts.cu",
        replaces="metrics_tpu/ops/classification/binned_pallas.py:47",
        signatures={
            # preds, target, form, thr_sorted, order, out, ws, ws_len, n, c, t, stream
            "binned_counts_launch": ((_P, _P, _I, _P, _P, _P, _P, _L, _I, _I, _I, _P), ctypes.c_int),
            "binned_counts_class_block": ((_I, _I), ctypes.c_int),
            "binned_counts_max_shared_t": ((), ctypes.c_int),
            "binned_counts_workspace_len": ((_I, _I), _L),
        },
    ),
    "binned_counts_batched": Kernel(
        name="binned_counts_batched",
        source="binned_counts.cu",
        # the Pallas kernel under jax.vmap, which batches pallas_call
        replaces="metrics_tpu/ops/classification/binned_pallas.py:47",
        shares="binned_counts",
        signatures={
            # preds, target, form, thr_sorted, order, out, ws, ws_len, b, n, c, t, stream
            "binned_counts_batched_launch": ((_P, _P, _I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P), ctypes.c_int),
            "binned_counts_batched_workspace_len": ((_I, _I, _I), _L),
            "binned_counts_workspace_len": ((_I, _I), _L),
        },
    ),
    "pairwise_iou": Kernel(
        name="pairwise_iou",
        source="pairwise_iou.cu",
        replaces="metrics_tpu/ops/kernels/iou_matching.py:41",
        signatures={
            # det, gt, det_counts (or NULL), gt_counts (or NULL), out, b, d, g, stream
            "pairwise_iou_launch": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), ctypes.c_int),
        },
    ),
    "greedy_match": Kernel(
        name="greedy_match",
        source="greedy_match.cu",
        # not a Pallas kernel: the lax.scan of _merged_greedy_match
        replaces="metrics_tpu/ops/kernels/iou_matching.py:83",
        signatures={
            # ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thresholds, out, b, a, t, d, g, stream
            "greedy_match_launch": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
            "greedy_match_max_g": ((), ctypes.c_int),
        },
    ),
    "maxsim_tf32x3": Kernel(
        name="maxsim_tf32x3",
        source="maxsim_tc.cu",
        replaces="metrics_tpu/ops/kernels/cosine_matching.py:53",
        signatures={
            # preds, target, col_keys, rowmax, colmax, pairs, p, r, d, stream
            "maxsim_tc_launch": ((_P, _P, _P, _P, _P, _L, _I, _I, _I, _P), ctypes.c_int),
        },
    ),
}


def check_kernel_inputs(name: str, device: torch.device, **tensors: "tuple[torch.Tensor, torch.dtype]") -> None:
    """Raise unless every tensor lies on ``device`` with its dtype, contiguous."""
    for arg, (x, dtype) in tensors.items():
        if x.device != device:
            raise ValueError(f"{name}: {arg} lies on {x.device}, the first input on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype} {arg}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors; {arg} is not")


def current_stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as the handle a C entry takes."""
    return torch.cuda.current_stream(x.device).cuda_stream


def build_all() -> None:
    """Build (and load) every kernel, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(CUDA_KERNELS)) as pool:
        for future in [pool.submit(k.lib) for k in CUDA_KERNELS.values()]:
            future.result()


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


_COUNT_LOCK = threading.Lock()
_local = threading.local()


def _recording() -> Optional[Dict[str, int]]:
    records = getattr(_local, "records", None)
    return records[-1] if records else None


def count_launch(kernel: Kernel) -> None:
    """One launch of ``kernel``: what a wrapper calls where it launches."""
    record = _recording()
    with _COUNT_LOCK:
        if record is None:
            kernel._launches += 1
        else:
            record[kernel.name] = record.get(kernel.name, 0) + 1


@contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Collect this thread's launches into the yielded dict instead of the
    counters: a CUDA graph capture runs the wrappers and launches nothing.
    Other threads keep counting as before."""
    record: Dict[str, int] = {}
    records = getattr(_local, "records", None)
    if records is None:
        records = _local.records = []
    records.append(record)
    try:
        yield record
    finally:
        records.pop()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for kernel in CUDA_KERNELS.values():
            kernel._launches = 0


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: kernel._launches for name, kernel in CUDA_KERNELS.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta[name]`` launches to each named kernel's count."""
    with _COUNT_LOCK:
        for name, n in delta.items():
            CUDA_KERNELS[name]._launches += n


# --------------------------------------------------------------------------- #
# the heavy-kernel registry and its dispatch telemetry
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class KernelSpec:
    """One registered heavy kernel: its name, owning module, and what the
    hand-written variant covers (``pallas_scope``, the JAX package's field
    name; the rest of the kernel stays torch code either way)."""

    name: str
    module: str
    description: str
    pallas_scope: str


KERNELS: Dict[str, KernelSpec] = {
    "iou_matching": KernelSpec(
        name="iou_matching",
        module="metrics_tpu_torch.ops.kernels.iou_matching",
        description=(
            "Fused pairwise-IoU + greedy COCO matching over pow2-padded "
            "detection/groundtruth buffers (batched across images and classes)"
        ),
        pallas_scope="pairwise IoU matrix (csrc/pairwise_iou.cu) and the merged-class greedy matcher "
                     "(csrc/greedy_match.cu)",
    ),
    "cosine_matching": KernelSpec(
        name="cosine_matching",
        module="metrics_tpu_torch.ops.kernels.cosine_matching",
        description=(
            "Pairwise token cosine-similarity + greedy max matching for "
            "BERTScore precision/recall/F1"
        ),
        pallas_scope="row/col max of the token similarity matrix (csrc/maxsim_tc.cu)",
    ),
    "feature_extract": KernelSpec(
        name="feature_extract",
        module="metrics_tpu_torch.ops.kernels.features",
        description=(
            "pow2-bucketed batched feature extraction (Inception, LPIPS) so "
            "ragged update batches reuse at most log2(N) forward signatures"
        ),
        pallas_scope="none (the network forward is torch code)",
    ),
}

# pow2 histogram buckets for the bucket-width series: 1..8192 covers every
# batch/token width the engines produce (wider observations land in +Inf)
_WIDTH_BUCKETS = tuple(float(1 << i) for i in range(14))

# per kernel: the input signatures seen since the last reset, and their count
_TRACE_COUNTS: Dict[str, int] = {}
_SIGNATURES: Dict[str, set] = {}
_TRACE_LOCK = threading.Lock()


def _signature(args: Sequence[Any]) -> Tuple:
    """What a jit cache keys on: each tensor's shape, dtype and device, and
    every other argument as it is."""
    return tuple(
        (tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor) else a for a in args
    )


def bump_trace_count(kernel: str, signature: Optional[Tuple] = None) -> None:
    """Count one new input signature of ``kernel``: ``signature`` (a tuple
    of the call's tensors and static arguments) counts the first time it is
    seen since the last :func:`reset_trace_counts`; with none, every call
    counts, as in the JAX package."""
    with _TRACE_LOCK:
        if signature is not None:
            key = _signature(signature)
            seen = _SIGNATURES.setdefault(kernel, set())
            if key in seen:
                return
            seen.add(key)
        _TRACE_COUNTS[kernel] = _TRACE_COUNTS.get(kernel, 0) + 1


def trace_counts() -> Dict[str, int]:
    """Snapshot of per-kernel signature counts since process start or the
    last reset."""
    with _TRACE_LOCK:
        return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    """Clear the counts and the signatures seen: every signature counts again."""
    with _TRACE_LOCK:
        _TRACE_COUNTS.clear()
        _SIGNATURES.clear()


def resolve_use_pallas(use_pallas: str, *, traced: bool = False) -> Tuple[bool, bool]:
    """Resolve a kernel's ``use_pallas`` mode to ``(use, interpret)``, as the
    JAX package does: ``"never"`` and ``"force"`` are explicit, ``"auto"``
    claims the hand-written path only on a host with a card and never while
    ``traced``. ``interpret`` is always False: a CUDA kernel has no interpret
    mode. No environment variable is read."""
    if use_pallas not in ("auto", "force", "never"):
        raise ValueError(f"use_pallas must be 'auto', 'force' or 'never', got {use_pallas!r}")
    if use_pallas == "never":
        return False, False
    if use_pallas == "auto" and (traced or not torch.cuda.is_available()):
        return False, False
    return True, False


def record_dispatch(kernel: str, impl: str, bucket_width: Optional[int] = None) -> None:
    """Count one kernel dispatch (``impl`` is ``"cuda"`` or ``"torch"``) and
    observe the pow2 bucket width it ran at."""
    _instruments.REGISTRY.counter(
        "heavy_kernel_calls",
        help="heavy-kernel dispatches by kernel and implementation",
        kernel=kernel,
        impl=impl,
    ).inc()
    if bucket_width is not None:
        _instruments.REGISTRY.histogram(
            "heavy_kernel_bucket_width",
            help="pow2 bucket widths heavy kernels dispatched at",
            buckets=_WIDTH_BUCKETS,
            kernel=kernel,
        ).observe(float(bucket_width))
    if _otrace.active:
        _otrace.emit_instant(
            "kernel/dispatch", "kernel",
            kernel=kernel, impl=impl,
            **({"bucket_width": int(bucket_width)} if bucket_width is not None else {}),
        )


def record_fallback(kernel: str, reason: str) -> None:
    """Count one fallback of ``kernel`` (the JAX package's Pallas -> XLA
    fallback). Kept for its series and event: no port wrapper falls back."""
    _instruments.REGISTRY.counter(
        "heavy_kernel_fallbacks",
        help="heavy-kernel Pallas->XLA fallbacks",
        kernel=kernel,
    ).inc()
    if _otrace.active:
        _otrace.emit_instant(
            "kernel/fallback", "kernel",
            kernel=kernel, reason=str(reason).splitlines()[0][:200],
        )


def dispatched(kernel: str, on_cuda: bool, bucket_width: Optional[int], signature: Optional[Tuple] = None) -> None:
    """A wrapper's telemetry for one dispatch: its trace count (when given a
    ``signature``) and :func:`record_dispatch` with ``impl`` ``"cuda"`` or
    ``"torch"``; nothing while the sync layer is quiet (a capture's second
    run, the CPU's stand-in for a replay)."""
    from metrics_tpu_torch.parallel import sync as _sync  # parallel imports this package's users

    if _sync._hooks_quiet():
        return
    if signature is not None:
        bump_trace_count(kernel, signature)
    record_dispatch(kernel, "cuda" if on_cuda else "torch", bucket_width=bucket_width)


# the kernels' public wrappers, as the JAX package's ``ops.kernels`` exports them
from metrics_tpu_torch.ops.kernels.cosine_matching import pairwise_cosine_pr  # noqa: E402,F401
from metrics_tpu_torch.ops.kernels.iou_matching import evaluate_matches  # noqa: E402,F401
# the pow2 feature bucketing of the image metrics: torch code, no kernel
from metrics_tpu_torch.ops.kernels import features  # noqa: E402,F401
from metrics_tpu_torch.ops.kernels.features import BucketedFeatureExtractor, maybe_bucketed  # noqa: E402,F401
