"""File-backed numpy arrays (counterpart of ``sheeprl_tpu/data/memmap.py``).

A :class:`MemmapArray` keeps a replay buffer's storage in a file, so a
buffer larger than host memory (DreamerV3's 100,000 frames of 64x64x3) lives
on disk and in the page cache. The instance that created the file owns it:
when the last reference to the owner's mapping goes, the file is deleted,
and its directory too once empty. A pickled array is a non-owning view that
names the file and maps it again on first use.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from sys import getrefcount
from typing import Any, Optional, Tuple

import numpy as np

__all__ = ["MemmapArray", "MEMMAP_MODES"]

#: the modes a view may map its file with (creation always writes it anew)
MEMMAP_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


class MemmapArray:
    def __init__(
        self,
        dtype: "np.dtype | str",
        shape: Tuple[int, ...],
        filename: "str | os.PathLike | None" = None,
        mode: str = "r+",
        _create: bool = True,
    ) -> None:
        if mode not in MEMMAP_MODES:
            raise ValueError(f"Unsupported memmap mode '{mode}'")
        if filename is None:
            fd, filename = tempfile.mkstemp(suffix=".memmap")
            os.close(fd)
        self._filename = Path(filename).resolve()
        self._filename.parent.mkdir(parents=True, exist_ok=True)
        self._dtype = np.dtype(dtype)
        self._shape = tuple(int(s) for s in shape)
        self._mode = mode
        self._array_dir = str(self._filename.parent)
        if _create:  # a new zero-filled file, owned by this instance
            self._filename.touch(exist_ok=True)
            self._array: Optional[np.memmap] = np.memmap(
                filename=str(self._filename), dtype=self._dtype, shape=self._shape, mode="w+"
            )
            self._has_ownership = True
        else:  # a view of an existing file, mapped on first use
            self._array = None
            self._has_ownership = False

    # -- properties ----------------------------------------------------------
    @property
    def filename(self) -> str:
        return str(self._filename)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    @property
    def array(self) -> np.memmap:
        if self._array is None:  # a view: map the file now
            self._array = np.memmap(filename=str(self._filename), dtype=self._dtype, shape=self._shape, mode=self._mode)
        return self._array

    @array.setter
    def array(self, value: np.ndarray) -> None:
        if not isinstance(value, np.ndarray):
            raise ValueError(f"The value to be set must be a numpy array, got {type(value)}")
        if value.shape != self._shape:
            raise ValueError(f"Shape mismatch: expected {self._shape}, got {value.shape}")
        self.array[:] = value

    # -- construction --------------------------------------------------------
    @classmethod
    def from_array(
        cls,
        array: "np.ndarray | MemmapArray",
        filename: "str | os.PathLike | None" = None,
        mode: str = "r+",
    ) -> "MemmapArray":
        """A MemmapArray holding ``array``'s contents in ``filename``. When
        ``array`` is a MemmapArray of that same file, the result is a
        non-owning view of it and the file is left as it is (the JAX
        package's view rewrites the file with zeros)."""
        if isinstance(array, MemmapArray) and filename is not None and Path(filename).resolve() == array._filename:
            return cls(array.dtype, array.shape, filename=filename, mode=mode, _create=False)
        src = array.array if isinstance(array, MemmapArray) else np.asarray(array)
        out = cls(dtype=src.dtype, shape=src.shape, filename=filename, mode=mode)
        out.array[:] = src
        return out

    # -- pickling: a non-owning view -----------------------------------------
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_array"] = None
        state["_has_ownership"] = False
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def __del__(self) -> None:
        # only the owner deletes, and only when it holds the last reference
        # to its mapping
        if getattr(self, "_has_ownership", False) and self._array is not None and getrefcount(self._array) <= 2:
            self._array = None
            try:
                os.unlink(self._filename)
            except OSError:
                pass
            try:
                if not any(os.scandir(self._array_dir)):
                    os.rmdir(self._array_dir)
            except OSError:
                pass

    # -- array interface -----------------------------------------------------
    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = np.asarray(self.array)
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self) -> int:
        return self._shape[0]

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, mode={self._mode}, filename={self._filename})"
