"""COCO run-length-encoded (RLE) mask codec, on the host (counterpart of
``metrics_tpu/ops/detection/rle.py``, copied: it imports only numpy).

RLE is a byte-string CPU format, so it is decoded on the host and the dense
masks are evaluated on the device (``ops/detection/boxes.py:mask_iou``).
:func:`masks_from_rle_list` gives them as one ``torch.bool`` tensor.

Two wire formats, matching pycocotools ``maskUtils``:

- **uncompressed**: ``{"size": [H, W], "counts": [n0, n1, ...]}``: run
  lengths over the column-major (Fortran-order) flattened mask, alternating
  background/foreground and starting with background.
- **compressed**: ``counts`` is an ASCII byte string; each run length is a
  variable-length base-32 integer (5 value bits per byte, offset 48, bit 0x20
  continues, sign-extended via bit 0x10 of the last byte), and from the
  fourth run on (index >= 3) the stored value is a delta against the run two
  places back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["rle_decode", "rle_encode", "is_rle", "masks_from_rle_list"]


def is_rle(obj: Any) -> bool:
    """True for a pycocotools-style RLE dict."""
    return isinstance(obj, dict) and "counts" in obj and "size" in obj


def _counts_from_string(s: Union[bytes, str]) -> List[int]:
    """Decode COCO's compressed counts byte string to run lengths."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_string(counts: Sequence[int]) -> bytes:
    """Encode run lengths into COCO's compressed counts byte string."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            val = x & 0x1F
            x >>= 5
            # arithmetic shift leaves -1 for negatives / 0 for positives;
            # stop once remaining bits agree with the sign bit just emitted
            more = not (x == -1 and (val & 0x10)) if val & 0x10 else not (x == 0)
            if more:
                val |= 0x20
            out.append(val + 48)
    return bytes(out)


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """RLE dict (compressed or uncompressed) -> dense bool mask (H, W).

    Example:
        >>> from metrics_tpu_torch.ops.detection.rle import rle_decode
        >>> rle_decode({"size": [2, 3], "counts": [0, 1, 2, 3]}).astype(int).tolist()
        [[1, 0, 1], [0, 1, 1]]
    """
    if not is_rle(rle):
        raise ValueError(
            "Expected an RLE dict with 'size' and 'counts' keys; "
            f"got {type(rle).__name__} with keys {sorted(rle) if isinstance(rle, dict) else None}."
        )
    h, w = (int(v) for v in rle["size"])
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _counts_from_string(counts)
    counts = np.asarray(counts, dtype=np.int64)
    if counts.sum() != h * w:
        raise ValueError(
            f"RLE runs sum to {int(counts.sum())} but size implies {h * w} pixels."
        )
    values = np.zeros(len(counts), dtype=bool)
    values[1::2] = True  # runs alternate background/foreground, background first
    flat = np.repeat(values, counts)
    return flat.reshape(w, h).T  # column-major layout


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict[str, Any]:
    """Dense (H, W) mask -> RLE dict (compressed counts by default).

    Example:
        >>> import numpy as np
        >>> from metrics_tpu_torch.ops.detection.rle import rle_decode, rle_encode
        >>> mask = np.asarray([[1, 0, 1], [0, 1, 1]], dtype=bool)
        >>> rle_encode(mask, compress=False)["counts"]
        [0, 1, 2, 3]
        >>> bool((rle_decode(rle_encode(mask)) == mask).all())
        True
    """
    mask = np.asarray(mask, dtype=bool)
    if mask.ndim != 2:
        raise ValueError(f"Expected a 2-d mask; got shape {mask.shape}.")
    h, w = mask.shape
    flat = mask.T.reshape(-1)  # column-major
    # run boundaries; prepend a leading zero-length background run if the
    # mask starts with foreground (the format always starts at background)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {
        "size": [h, w],
        "counts": _counts_to_string(counts) if compress else counts,
    }


def masks_from_rle_list(
    segmentations: Sequence[Dict[str, Any]], device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """List of N RLE dicts (same size) -> dense (N, H, W) ``torch.bool``
    tensor on ``device`` (the CPU by default): decoded on the host, then one
    copy."""
    if not segmentations:
        return torch.zeros((0, 0, 0), dtype=torch.bool, device=device)
    masks = [rle_decode(r) for r in segmentations]
    first = masks[0].shape
    if any(m.shape != first for m in masks):
        raise ValueError(
            f"All RLE masks of one image must share a size; got {[m.shape for m in masks]}."
        )
    return torch.from_numpy(np.stack(masks)).to(device)
