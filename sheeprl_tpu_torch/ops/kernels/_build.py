"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, ``build/kernels/<name>-<digest>.so`` beside
the package (``.gitignore`` lists ``build/``), and loaded with :mod:`ctypes`.
No PyTorch header is included, so a kernel builds in seconds. The digest of
the source names the library, so an edited source is rebuilt and a built one
is reused. Nothing is built when this module is imported: the first launch of
a kernel builds it, or :func:`build_all` builds every kernel at once, one
``nvcc`` process per source, all started together.

A build or load failure raises :class:`KernelBuildError` with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["KernelBuildError", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas's register/shared-memory report of each kernel built in this process
BUILD_LOGS: Dict[str, str] = {}
#: nvcc processes started per kernel in this process (one per build: threads
#: that reach an unbuilt kernel at once wait on ``_LOCK`` for the first's)
BUILD_COUNTS: Dict[str, int] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed, is missing, or the built library did not load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError(f"nvcc not found on PATH or under {cuda_home}/bin: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    if not source.is_file():
        raise KernelBuildError(f"no kernel source {source}")
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    BUILD_COUNTS[name] = BUILD_COUNTS.get(name, 0) + 1
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: Path, proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{output}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all of it or nothing
    BUILD_LOGS[name] = output


def _open(name: str, target: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        raise KernelBuildError(f"built {target} but could not load it: {e}\n{BUILD_LOGS.get(name, '')}") from e
    _LOADED[name] = lib
    return lib


def build_all(names: Sequence[str] = ()) -> Dict[str, ctypes.CDLL]:
    """Build (where not built yet) and load the named kernels, or every
    ``csrc/*.cu``: one ``nvcc`` per source, all running at once."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        pending: List = []
        for name in names:
            if name in _LOADED:
                continue
            target = _target(name)
            if not target.is_file():
                pending.append((name, target, _start(name, target)))
        errors = []
        for name, target, proc in pending:
            try:
                _finish(name, target, proc)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n\n".join(errors))
        for name in names:
            if name not in _LOADED:
                _open(name, _target(name))
        return {name: _LOADED[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib
