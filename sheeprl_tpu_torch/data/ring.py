"""Packed host->device staging (counterpart of the layout helpers of
``sheeprl_tpu/data/ring.py``: ``BlobLayout``, ``make_layout``,
``pack_burst_blob``, ``unpack_burst_blob``).

Several small host arrays (one transition row's keys, for the device replay
ring) become one uint8 blob, so a flush is ONE host->device copy instead of
one per array. :func:`pack_burst_blob` writes a fresh host tensor, pinned
when asked, so a non-blocking copy from it can overlap the host loop (the
caching host allocator holds a pinned block until the copies that read it
have run, so a block is never reused under a copy in flight).
:func:`unpack_burst_blob` slices and reinterprets each segment of the copy
on the device: views, no further copy. The ring itself comes with the
DreamerV3 sequence ring.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["BlobLayout", "make_layout", "pack_burst_blob", "unpack_burst_blob", "torch_dtype"]


class BlobLayout(NamedTuple):
    """Byte layout of one packed upload."""

    nbytes: int
    segments: Tuple[Tuple[str, int, tuple, Any], ...]  # (name, offset, shape, np.dtype)


def make_layout(spec) -> BlobLayout:
    """Build a :class:`BlobLayout` from ``(name, shape, dtype)`` triples.

    Segment offsets are 4-byte aligned so 32-bit segments can be
    reinterpreted from the uint8 view; the total length is padded to a
    4-byte multiple."""
    segs = []
    off = 0
    for name, shape, dtype in spec:
        off = (off + 3) & ~3
        segs.append((name, off, tuple(int(s) for s in shape), np.dtype(dtype)))
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return BlobLayout((off + 3) & ~3, tuple(segs))


def pack_burst_blob(layout: BlobLayout, values: Dict[str, np.ndarray], pin_memory: bool = False) -> torch.Tensor:
    """Host side: copy every segment's bytes into one fresh uint8 tensor
    (pinned with ``pin_memory``, which needs a CUDA build)."""
    blob = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=pin_memory)
    view = blob.numpy()
    for name, off, shape, dtype in layout.segments:
        arr = np.ascontiguousarray(values[name], dtype=dtype)
        view[off : off + arr.nbytes] = arr.view(np.uint8).ravel()
    return blob


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def unpack_burst_blob(blob: torch.Tensor, layout: BlobLayout) -> Dict[str, torch.Tensor]:
    """Device side: each segment as a view of ``blob`` in its dtype and shape."""
    out = {}
    for name, off, shape, dtype in layout.segments:
        seg = blob[off : off + int(np.prod(shape)) * dtype.itemsize]
        out[name] = (seg if dtype == np.uint8 else seg.view(torch_dtype(dtype))).reshape(shape)
    return out
