"""Ragged multi-head ring scatter: the device sequence ring's per-env-head
append (counterpart of ``sheeprl_tpu/ops/kernels/scatter.py``).

Slot ``(s, j)`` of a staged ``(S, e, ...)`` block lands at
``storage[row[s, j], col_offset + j]``, where ``row`` is the per-env ragged
pack of :func:`sheeprl_tpu_torch.data.ring.ring_append_rows` and dropped or
padded slots carry ``row == capacity``. The ring is updated in place and
returned, as the Pallas version aliases it.

:func:`ragged_ring_scatter_reference` is the plain version, the JAX
package's lax reference: the literal masked scatter. On CPU tensors
:func:`ragged_ring_scatter` runs it. On CUDA tensors it launches the
hand-written kernel ``csrc/ring_scatter.cu`` (built at first use, see
:mod:`._build`) or raises; nothing substitutes the plain version on the
card. The wrapper reads nothing back from the card, so a CUDA graph can
capture it. ``pos`` (the heads before the append) is in the signature for
parity: only the Pallas version needs it, to park dropped slots.

:func:`ragged_ring_scatter_keys` appends every key of a ring (a dict or
sequence of storages, all sharing one ``row``) in ONE launch of the kernel:
the JAX package makes one call per key over the same ``row``
(``sheeprl_tpu/data/ring.py:320``), and on the card each such call costs a
launch's floor for a copy of a few bytes. Its plain version is
:func:`ragged_ring_scatter_reference` over the keys. The per-key
:func:`ragged_ring_scatter` stays, as the JAX function's counterpart, and
is the one-key case of the same launch. :data:`LAUNCHES` counts launches.

Preconditions, checked on the card path: ``staged.dtype == storage.dtype``,
``capacity == storage.shape[0]`` (the drop marker) for every key,
``col_offset + e`` within each ring's env columns, contiguous tensors on one
device. On both paths: 1 to :data:`MAX_KEYS` keys, each staged block
starting with ``row``'s ``(S, e)``.

The gradient is the plain scatter's, as the JAX package's ``custom_vjp``
re-derives it from its lax reference (float dtypes only; the ring's uint8
pixels are never differentiated): ``d_storage`` is the incoming gradient
with the written slots zeroed, ``d_staged`` the incoming gradient read back
at the written slots and 0 at dropped ones.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence, Union

import numpy as np
import torch

from sheeprl_tpu_torch.ops.kernels import _build, count_launch

__all__ = ["ragged_ring_scatter", "ragged_ring_scatter_keys", "ragged_ring_scatter_reference", "MAX_KEYS"]

#: ring keys one launch takes (the kernel's segment table)
MAX_KEYS = 8

Storages = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def _slots(storage: torch.Tensor, row: torch.Tensor, col_offset: int):
    """The written slots' mask, and each slot's ring column."""
    S, e = row.shape
    cols = col_offset + torch.arange(e, device=row.device).expand(S, e)
    return row < storage.shape[0], cols


def ragged_ring_scatter_reference(
    storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, pos: torch.Tensor, col_offset: int = 0
) -> torch.Tensor:
    """The literal masked scatter ``storage[row[m], cols[m]] = staged[m]``
    with ``m = row < capacity``, in place; returns ``storage``."""
    del pos
    m, cols = _slots(storage, row, int(col_offset))
    storage[row[m].long(), cols[m]] = staged[m]
    return storage


def _scatter_vjp(g: torch.Tensor, row: torch.Tensor, col_offset: int, staged_shape) -> tuple:
    m, cols = _slots(g, row, col_offset)
    r, c = row[m].long(), cols[m]
    d_storage = g.clone()
    d_storage[r, c] = 0
    d_staged = g.new_zeros(staged_shape)
    d_staged[m] = g[r, c]
    return d_storage, d_staged


def _library() -> ctypes.CDLL:
    lib = _build.load("ring_scatter")
    fn = lib.ragged_ring_scatter_launch
    if fn.argtypes is None:  # ctypes would pass each pointer as a 32-bit int
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(i64),
                       ctypes.POINTER(i64), ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, col_offset: int) -> None:
    for what, t in (("storage", storage), ("staged", staged), ("row", row)):
        if t.device.type != "cuda" or t.device != row.device:
            raise ValueError(
                f"ragged_ring_scatter kernel needs every tensor on one CUDA device, got {name} {what} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"ragged_ring_scatter kernel needs a contiguous {name} {what}")
    if staged.dtype != storage.dtype:
        raise TypeError(f"ragged_ring_scatter kernel: {name} staged is {staged.dtype}, the ring {storage.dtype}")
    if row.dtype != torch.int32 or row.ndim != 2:
        raise TypeError(f"ragged_ring_scatter kernel takes (S, e) int32 rows, got {row.dtype} {tuple(row.shape)}")
    if storage.ndim < 2 or tuple(staged.shape) != tuple(row.shape) + tuple(storage.shape[2:]):
        raise ValueError(
            f"ragged_ring_scatter kernel: {name} staged {tuple(staged.shape)} is not rows {tuple(row.shape)} of "
            f"the ring's {tuple(storage.shape[2:])} slots"
        )
    if col_offset < 0 or col_offset + row.shape[1] > storage.shape[1]:
        raise ValueError(
            f"ragged_ring_scatter kernel: columns {col_offset}..{col_offset + row.shape[1]} outside the ring "
            f"{name}'s {storage.shape[1]}"
        )
    if storage.shape[0] >= 2**31:
        raise ValueError(f"ragged_ring_scatter kernel: a capacity of {storage.shape[0]} rows does not fit int32 rows")


def _launch(storages, staged, row: torch.Tensor, col_offset: int) -> None:
    """ONE launch appending every key."""
    capacity = storages[0].shape[0]
    for i, (storage, block) in enumerate(zip(storages, staged)):
        _check(f"key {i}", storage, block, row, col_offset)
        if storage.shape[0] != capacity:
            raise ValueError(f"ragged_ring_scatter kernel: key {i} holds {storage.shape[0]} rows, key 0 {capacity}: "
                             "one row table marks drops with one capacity")
    n = len(storages)
    ptrs, i64s = ctypes.c_void_p * n, ctypes.c_int64 * n
    stream = torch.cuda.current_stream(row.device).cuda_stream
    err = _library().ragged_ring_scatter_launch(
        n, ptrs(*(s.data_ptr() for s in storages)), ptrs(*(t.data_ptr() for t in staged)),
        i64s(*(s.shape[1] for s in storages)),
        i64s(*(int(np.prod(s.shape[2:])) * s.element_size() for s in storages)),
        row.data_ptr(), capacity, row.shape[0], row.shape[1], col_offset, stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged_ring_scatter kernel launch failed with cudaError {err}")
    count_launch("ragged_ring_scatter")


class _RaggedRingScatter(torch.autograd.Function):
    """Inputs ``(row, col_offset, n, *storages, *staged)``; outputs the
    ``n`` storages, written in place."""

    @staticmethod
    def forward(ctx, row, col_offset: int, n: int, *tensors):
        storages, staged = tensors[:n], tensors[n:]
        _launch(storages, staged, row, col_offset)
        ctx.mark_dirty(*storages)
        ctx.save_for_backward(row)
        ctx.col_offset, ctx.staged_shapes = col_offset, [t.shape for t in staged]
        return storages

    @staticmethod
    def backward(ctx, *grads):
        (row,) = ctx.saved_tensors
        n = len(grads)
        d_storages, d_staged = [None] * n, [None] * n
        for i, g in enumerate(grads):
            wants_storage, wants_staged = ctx.needs_input_grad[3 + i], ctx.needs_input_grad[3 + n + i]
            if wants_storage or wants_staged:  # float keys only: uint8 pixels never need a gradient
                d_s, d_t = _scatter_vjp(g, row, ctx.col_offset, ctx.staged_shapes[i])
                d_storages[i] = d_s if wants_storage else None
                d_staged[i] = d_t if wants_staged else None
        return (None, None, None, *d_storages, *d_staged)


def _keyed(storages: Storages, staged, row: torch.Tensor):
    """The keys' names, storages and staged blocks, in order; checks what
    both paths need."""
    if isinstance(storages, Mapping):
        names = list(storages)
        blocks = [staged[k] for k in names]
        storages = [storages[k] for k in names]
    else:
        names, storages, blocks = list(range(len(storages))), list(storages), list(staged)
        if len(blocks) != len(storages):
            raise ValueError(f"ragged_ring_scatter: {len(blocks)} staged blocks for {len(storages)} ring keys")
    if not 1 <= len(storages) <= MAX_KEYS:
        raise ValueError(f"ragged_ring_scatter takes 1 to {MAX_KEYS} ring keys per call, got {len(storages)}")
    for name, block in zip(names, blocks):
        if tuple(block.shape[:2]) != tuple(row.shape):
            raise ValueError(f"ragged_ring_scatter: key {name!r} staged {tuple(block.shape)} does not start with "
                             f"the rows' {tuple(row.shape)}")
    return names, storages, blocks


def ragged_ring_scatter_keys(
    storages: Storages, staged, row: torch.Tensor, pos: torch.Tensor, col_offset: int = 0
) -> Storages:
    """Every ring key appended in place, in one launch on the card:
    ``storages`` is a dict (or sequence) of ``(C, E_k, ...)`` rings,
    ``staged`` their ``(S, e, ...)`` blocks (a dict may hold more keys than
    ``storages``; only theirs are read), all sharing the ``(S, e)`` ``row``
    (``row == C`` slots are dropped). Returns the storages, in a container
    of the same kind. CPU tensors run the plain version key by key; CUDA
    tensors launch the kernel; anything else raises."""
    names, rings, blocks = _keyed(storages, staged, row)
    tensors = rings + blocks + [row]
    if all(t.device.type == "cpu" for t in tensors):
        out = [ragged_ring_scatter_reference(s, t, row, pos, col_offset) for s, t in zip(rings, blocks)]
    else:
        out = list(_RaggedRingScatter.apply(row, int(col_offset), len(rings), *rings, *blocks))
    return dict(zip(names, out)) if isinstance(storages, Mapping) else out


def ragged_ring_scatter(
    storage: torch.Tensor, staged: torch.Tensor, row: torch.Tensor, pos: torch.Tensor, col_offset: int = 0
) -> torch.Tensor:
    """``(C, E, ...) x (S, e, ...) x (S, e) rows -> (C, E, ...)`` in place
    (``row == C`` slots are dropped): the one-key case of
    :func:`ragged_ring_scatter_keys`."""
    return ragged_ring_scatter_keys([storage], [staged], row, pos, col_offset)[0]
