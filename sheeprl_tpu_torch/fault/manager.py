"""Checkpoint lifecycle: manifest, retention, asynchronous save, resume
(counterpart of ``sheeprl_tpu/fault/manager.py`` for the port's one-file
``torch.save`` checkpoints).

- Every successful save is **published** into ``manifest.json`` beside it
  (step, wall time, format version, the sha256 digest and byte size of the
  whole file) by an atomic temp-file + rename; a checkpoint absent from the
  manifest is incomplete by definition and is skipped by discovery and
  reclaimed by GC once it is old.
- **keep-last-K retention** deletes older steps and sweeps the ``.tmp``
  leftovers of killed saves older than a grace period.
- An optional **asynchronous save** starts the device→host copies on the
  training thread (:func:`~sheeprl_tpu_torch.utils.checkpoint.stage_to_host`)
  and leaves the write, fsync, digest and publish to one writer thread; at
  most one save is in flight, and a write error re-raises on the next
  ``save``/``wait``/``close``.
- **Resume**: ``checkpoint.resume_from=latest`` walks the experiment's run
  directories for the newest complete manifest entry (falling back to a
  scan of bare ``*.ckpt`` files for runs without a manifest), and
  :func:`load_resume_state` falls back to an older complete entry when the
  requested one does not load.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from sheeprl_tpu_torch.utils.checkpoint import (
    CONFIG_NAME,
    MANIFEST_NAME,
    TMP_SUFFIX,
    CheckpointError,
    finalize_host,
    load_checkpoint,
    stage_to_host,
    write_host_checkpoint,
    write_run_config,
)

__all__ = [
    "CheckpointManager",
    "read_manifest",
    "write_manifest",
    "manifest_entry",
    "complete_entries",
    "latest_complete",
    "find_latest_run_checkpoint",
    "load_resume_state",
    "parse_step",
]

MANIFEST_VERSION = 1
#: the port's checkpoint layout: one ``torch.save`` zip file per step
FORMAT_VERSION = 1
_CKPT_RE = re.compile(r"^ckpt_(\d+)_(\d+)\.ckpt$")
# GC never reclaims temp or orphan files younger than this: an in-flight
# save of a sibling process must not be swept mid-write
_ORPHAN_GRACE_SECONDS = 600.0


def parse_step(name: str) -> Optional[int]:
    m = _CKPT_RE.match(name)
    return int(m.group(1)) if m else None


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


# -- manifest ----------------------------------------------------------------
def read_manifest(ckpt_dir: "str | os.PathLike") -> List[Dict[str, Any]]:
    """Entries of ``<ckpt_dir>/manifest.json``, oldest first. A missing or
    corrupted manifest gives ``[]``: discovery then scans the files."""
    path = Path(ckpt_dir) / MANIFEST_NAME
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        entries = doc.get("entries", [])
        return [e for e in entries if isinstance(e, dict) and "file" in e]
    except FileNotFoundError:
        return []
    except (ValueError, OSError, AttributeError) as e:
        # ValueError covers JSONDecodeError and UnicodeDecodeError (binary garbage)
        warnings.warn(f"Ignoring corrupted checkpoint manifest {path}: {e}")
        return []


def write_manifest(ckpt_dir: "str | os.PathLike", entries: List[Dict[str, Any]]) -> None:
    """Publish ``entries`` atomically (temp file, fsync, rename)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / (MANIFEST_NAME + TMP_SUFFIX)
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps({"version": MANIFEST_VERSION, "entries": entries}, indent=0))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, ckpt_dir / MANIFEST_NAME)


def manifest_entry(path: Path, step: int, digest: Optional[str] = None) -> Dict[str, Any]:
    """The record that publishes the committed checkpoint ``path``."""
    return {
        "file": path.name,
        "step": int(step),
        "time": time.time(),
        "format_version": FORMAT_VERSION,
        "digest": digest if digest is not None else _digest(path),
        "bytes": path.stat().st_size,
    }


def _verify(path: Path) -> bool:
    """Cheap completeness probe: the file is a zip archive (its directory
    sits at the end, so a truncated or scrambled file fails) holding a
    pickle record. Damage inside a record surfaces at load time and is
    handled by the fallback chain."""
    try:
        with zipfile.ZipFile(path) as zf:
            return any(name.endswith("data.pkl") for name in zf.namelist())
    except (OSError, zipfile.BadZipFile, ValueError):
        return False


def _size_matches(path: Path, entry: Dict[str, Any]) -> bool:
    """The recorded byte size against the file's (entries without one pass)."""
    recorded = entry.get("bytes")
    if recorded is None:
        return True
    try:
        return path.stat().st_size == int(recorded)
    except (OSError, ValueError):
        return False


def _complete_entries(ckpt_dir: Path) -> List[Tuple[float, int, Path]]:
    """(time, step, path) of every complete checkpoint, oldest first.

    Manifest entries come first: one whose file fails the probe or has
    another size than recorded is rejected outright; one whose digest does
    not match loses the manifest's trust but stays eligible for the scan.
    Bare ``*.ckpt`` files absent from the manifest (runs without one) are
    merged in with their mtime, unless rejected."""
    out: Dict[Path, Tuple[float, int, Path]] = {}
    rejected: set = set()
    for e in read_manifest(ckpt_dir):
        p = ckpt_dir / str(e["file"])
        if not _verify(p) or not _size_matches(p, e):
            rejected.add(p)
            continue
        expected = e.get("digest")
        if expected:
            try:
                if _digest(p) != expected:
                    continue
            except OSError:
                continue
        out[p] = (float(e.get("time", 0.0)), int(e.get("step", parse_step(p.name) or 0)), p)
    if ckpt_dir.is_dir():
        for p in ckpt_dir.glob("*.ckpt"):
            if p not in out and p not in rejected and _verify(p):
                step = parse_step(p.name)
                out[p] = (p.stat().st_mtime, step if step is not None else 0, p)
    return sorted(out.values(), key=lambda t: (t[1], t[0]))


def complete_entries(ckpt_dir: "str | os.PathLike") -> List[Tuple[float, int, Path]]:
    """Every complete checkpoint in ``ckpt_dir`` as ``(time, step, path)``,
    oldest first."""
    return _complete_entries(Path(ckpt_dir))


def latest_complete(ckpt_dir: "str | os.PathLike") -> Optional[Path]:
    """The newest complete checkpoint in ``ckpt_dir`` (torn saves skipped)."""
    entries = _complete_entries(Path(ckpt_dir))
    return entries[-1][2] if entries else None


def find_latest_run_checkpoint(root: "str | os.PathLike") -> Optional[Path]:
    """The newest complete checkpoint under an experiment root
    (``<log_root>/<algo>/<env>``): scans the port's ``*/checkpoint`` run
    directories, the JAX package's ``*/version_*/checkpoint`` ones, and
    ``root`` itself when it is a checkpoint directory; the newest by wall
    time, then step, wins."""
    root = Path(root)
    if not root.exists():
        return None
    dirs = [d for pattern in ("*/checkpoint", "*/version_*/checkpoint") for d in root.glob(pattern) if d.is_dir()]
    if root.name == "checkpoint" or list(root.glob("*.ckpt")) or (root / MANIFEST_NAME).exists():
        dirs.append(root)
    candidates = [entries[-1] for entries in map(_complete_entries, dirs) if entries]
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[0], t[1]))[2]


def load_resume_state(path: "str | os.PathLike") -> Dict[str, Any]:
    """:func:`~sheeprl_tpu_torch.utils.checkpoint.load_checkpoint`, falling
    back, when the requested checkpoint does not load, to the same
    directory's older complete entries, newest first, and never past the
    requested step: a deliberate resume from an older step must not jump
    forward."""
    path = Path(path)
    try:
        return load_checkpoint(path)
    except CheckpointError as primary:
        requested_step = parse_step(path.name)
        for _, step, cand in reversed(_complete_entries(path.parent)):
            if cand == path or (requested_step is not None and step > requested_step):
                continue
            try:
                state = load_checkpoint(cand)
            except CheckpointError:
                continue
            warnings.warn(f"Checkpoint {path} is unusable ({primary}); resuming from older complete entry {cand}.")
            return state
        raise


def _rm_any(path: Path) -> None:
    if path.is_dir():
        shutil.rmtree(path, ignore_errors=True)
    else:
        path.unlink(missing_ok=True)


class CheckpointManager:
    """Crash-safe, manifest-published, optionally asynchronous saver; one
    per run. The path of each save is the loop's
    (``<run>/checkpoint/ckpt_<step>_0.ckpt``), so the manager owns no layout.

    ``timings`` records each published save: ``blocked_s``, the host seconds
    ``save`` kept the training thread; ``write_s``, the write and fsync;
    ``digest_s``, the sha256 of the whole file (on the writer thread);
    ``bytes``, the file's size."""

    def __init__(self, keep_last: Optional[int] = None, async_save: bool = False) -> None:
        self.keep_last = int(keep_last) if keep_last else None
        self.async_save = bool(async_save)
        self.timings: List[Dict[str, float]] = []
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @classmethod
    def from_config(cls, cfg: Any) -> "CheckpointManager":
        """From ``checkpoint.keep_last`` and ``checkpoint.async_save``."""
        ckpt = cfg.get("checkpoint") or {}
        return cls(keep_last=ckpt.get("keep_last"), async_save=bool(ckpt.get("async_save", False)))

    # -- public API ----------------------------------------------------------
    def save(self, path: "str | os.PathLike", state: Dict[str, Any], step: Optional[int] = None,
             config: Optional[Dict[str, Any]] = None) -> Path:
        """Save ``state`` to ``path`` (and ``config`` as the run's
        ``config.json`` beside it, first). Synchronous mode returns once the
        checkpoint is published; asynchronous mode once the copies are
        staged (card tensors) or cloned (CPU tensors), so the caller may
        change the live state at once."""
        t0 = time.perf_counter()
        self._raise_pending()
        path = Path(path)
        if step is None:
            step = parse_step(path.name) or 0
        if config is not None:
            write_run_config(path.parent, config)
        staged = stage_to_host(state, copy_host=self.async_save)
        if not self.async_save:
            self._commit(path, finalize_host(staged), int(step), t0)
            return path
        self.wait()  # back-pressure: at most one save in flight
        self._raise_pending()
        blocked = time.perf_counter() - t0
        # non-daemon, so an orderly interpreter exit drains the pending save;
        # a SIGKILL mid-write is what the crash-safe publish tolerates
        self._inflight = threading.Thread(
            target=self._commit_async, args=(path, staged, int(step), blocked),
            name=f"ckpt-save-{step}", daemon=False,
        )
        self._inflight.start()
        return path

    def wait(self) -> None:
        """Block until the in-flight asynchronous save, if any, is done."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def close(self) -> None:
        self.wait()
        self._raise_pending()

    # -- internals -----------------------------------------------------------
    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"Asynchronous checkpoint save failed: {err}") from err

    def _commit_async(self, path: Path, staged: Any, step: int, blocked: float) -> None:
        try:
            self._commit(path, finalize_host(staged), step, None, blocked)
        except BaseException as e:  # stored for the next save/wait/close, warned now for the run's last save
            warnings.warn(f"Asynchronous checkpoint save of {path} FAILED: {type(e).__name__}: {e}")
            self._error = e

    def _commit(self, path: Path, host_state: Dict[str, Any], step: int,
                t0: Optional[float], blocked: Optional[float] = None) -> None:
        t_write = time.perf_counter()
        write_host_checkpoint(path, host_state)
        t_digest = time.perf_counter()
        entry = manifest_entry(path, step)
        entry["has_rb"] = "rb" in host_state
        t_done = time.perf_counter()
        entries = [e for e in read_manifest(path.parent) if e.get("file") != path.name] + [entry]
        entries.sort(key=lambda e: (int(e.get("step", 0)), float(e.get("time", 0.0))))
        if self.keep_last:
            keep, drop = entries[-self.keep_last:], entries[: -self.keep_last]
        else:
            keep, drop = entries, []
        write_manifest(path.parent, keep)
        self._gc(path.parent, keep, drop)
        self.timings.append({
            "step": step,
            "blocked_s": blocked if blocked is not None else time.perf_counter() - t0,
            "write_s": t_digest - t_write,
            "digest_s": t_done - t_digest,
            "bytes": entry["bytes"],
        })

    def _gc(self, ckpt_dir: Path, keep: List[Dict[str, Any]], drop: List[Dict[str, Any]]) -> None:
        """Delete the pruned entries' files; with ``keep_last``, the bare
        ``ckpt_<step>_0.ckpt`` files past the last K that no kept step names
        (the port writes rank 0 only); and the temp files of killed saves
        older than the grace period."""
        for e in drop:
            _rm_any(ckpt_dir / str(e["file"]))
        if self.keep_last is None:
            return
        kept_steps = {int(e.get("step", parse_step(str(e["file"])) or 0)) for e in keep}
        bare = [p for p in ckpt_dir.glob("ckpt_*_0.ckpt") if parse_step(p.name) is not None and _verify(p)]
        bare.sort(key=lambda p: (parse_step(p.name), p.stat().st_mtime))
        for p in bare[: -self.keep_last]:
            if parse_step(p.name) not in kept_steps:
                _rm_any(p)
        now = time.time()
        for p in ckpt_dir.iterdir():
            if not p.name.endswith(TMP_SUFFIX) or p.name in (MANIFEST_NAME + TMP_SUFFIX, CONFIG_NAME + TMP_SUFFIX):
                continue
            try:
                age = now - p.stat().st_mtime
            except OSError:  # raced another writer
                continue
            if age >= _ORPHAN_GRACE_SECONDS:
                _rm_any(p)
