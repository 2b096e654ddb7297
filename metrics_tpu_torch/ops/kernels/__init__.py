"""The hand-written CUDA kernels: build with ``nvcc``, load with ``ctypes``,
count launches.

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
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

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
                lib = KERNELS[self.shares].lib() if self.shares else ctypes.CDLL(str(self.build()))
                for symbol, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                self._lib = lib
            return self._lib


KERNELS: Dict[str, Kernel] = {
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
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for future in [pool.submit(k.lib) for k in KERNELS.values()]:
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
        for kernel in KERNELS.values():
            kernel._launches = 0


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: kernel._launches for name, kernel in KERNELS.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta[name]`` launches to each named kernel's count."""
    with _COUNT_LOCK:
        for name, n in delta.items():
            KERNELS[name]._launches += n


# the kernels' public wrappers, as the JAX package's ``ops.kernels`` exports them
from metrics_tpu_torch.ops.kernels.cosine_matching import pairwise_cosine_pr  # noqa: E402,F401
from metrics_tpu_torch.ops.kernels.iou_matching import evaluate_matches  # noqa: E402,F401
# the pow2 feature bucketing of the image metrics: torch code, no kernel
from metrics_tpu_torch.ops.kernels import features  # noqa: E402,F401
from metrics_tpu_torch.ops.kernels.features import BucketedFeatureExtractor, maybe_bucketed  # noqa: E402,F401
