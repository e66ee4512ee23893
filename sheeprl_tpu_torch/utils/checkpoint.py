"""The port's checkpoint format (counterpart of
``sheeprl_tpu/utils/checkpoint.py``): ``torch.save`` of a dict of state dicts
and plain values (for DreamerV3 training: ``world_model``, ``actor``,
``critic``, ``target_critic``, ``optimizers``, ``moments``, ``ratio``, the
loop's counters and the generator state ``rng``; serving reads
``world_model`` and ``actor``) in one file, ``ckpt_<step>_0.ckpt``, with the
run's ``config.json`` beside it.

Crash safety: the config is published first, then the checkpoint is written
to a ``<path>.tmp`` sibling, fsynced, and published with ``os.replace`` (the
commit point), after which the directory is fsynced. A kill at any instant
leaves either the previous file intact or the new one whole. Fault points
(:func:`sheeprl_tpu_torch.fault.inject.fault_point`) mark the kill windows:
``checkpoint.staged`` once the temp file is durable,
``checkpoint.pre_commit`` just before the rename, ``checkpoint.post_commit``
just after it. :class:`sheeprl_tpu_torch.fault.CheckpointManager` adds a
manifest, retention and an asynchronous writer on top of these primitives.

Read failures surface as :class:`CheckpointError` carrying the path, so a
resume can fall back to an older complete checkpoint.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "find_run_config",
    "stage_to_host",
    "finalize_host",
    "write_host_checkpoint",
    "write_run_config",
    "CONFIG_NAME",
    "MANIFEST_NAME",
]

CONFIG_NAME = "config.json"
#: the checkpoint manager's manifest; its directory is a run's ``checkpoint/``
MANIFEST_NAME = "manifest.json"
TMP_SUFFIX = ".tmp"


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, truncated or unreadable."""

    def __init__(self, message: str, path: "str | os.PathLike | None" = None) -> None:
        super().__init__(message)
        self.path = Path(path) if path is not None else None


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(path: Path, write, points: bool = False) -> None:
    """Write through ``write(tmp)`` to ``<path>.tmp``, fsync it, rename it
    over ``path`` and fsync the directory; with ``points`` the checkpoint's
    fault points fire around the commit."""
    tmp = Path(str(path) + TMP_SUFFIX)
    try:
        write(tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        if points:
            from sheeprl_tpu_torch.fault.inject import fault_point

            fault_point("checkpoint.staged")
            fault_point("checkpoint.pre_commit")
        os.replace(tmp, path)  # the commit point
    finally:
        tmp.unlink(missing_ok=True)
    _fsync_dir(path.parent)
    if points:
        from sheeprl_tpu_torch.fault.inject import fault_point

        fault_point("checkpoint.post_commit")


def _to_cpu(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


class _Staged:
    """A state whose card tensors are being copied into pinned host buffers
    on a side stream; :func:`finalize_host` waits for the copies."""

    def __init__(self, tree: Any, events: List[Any]) -> None:
        self.tree = tree
        self.events = events


def stage_to_host(tree: Any, copy_host: bool = False) -> _Staged:
    """Start the device→host copies of every card tensor of ``tree`` without
    blocking the host: each is copied with ``non_blocking=True`` into a
    pinned buffer on a side stream that first waits for the work queued so
    far, and the caller's stream then waits for the copies, so a later
    in-place update (an optimizer step, a ring append) cannot overtake them.
    With ``copy_host`` CPU tensors are cloned too, so the live ones may
    change once this returns (the asynchronous save's contract)."""
    side: Dict[torch.device, Any] = {}

    def pull(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                if x.device not in side:
                    stream = torch.cuda.Stream(device=x.device)
                    stream.wait_stream(torch.cuda.current_stream(x.device))
                    side[x.device] = stream
                with torch.cuda.stream(side[x.device]):
                    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    host.copy_(x, non_blocking=True)
                return host
            return x.clone() if copy_host else x
        if isinstance(x, dict):
            return {k: pull(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(pull(v) for v in x)
        return x

    tree = pull(tree)
    events = []
    for device, stream in side.items():
        event = torch.cuda.Event()
        event.record(stream)
        torch.cuda.current_stream(device).wait_event(event)
        events.append(event)
    return _Staged(tree, events)


def finalize_host(staged: _Staged) -> Any:
    """Wait for the staged copies; the state, every tensor on the CPU."""
    for event in staged.events:
        event.synchronize()
    return staged.tree


def write_host_checkpoint(path: "str | os.PathLike", host_state: Dict[str, Any]) -> Path:
    """Write a state whose tensors are all on the CPU to ``path``, crash-safe
    (see the module docstring)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _publish(path, lambda tmp: torch.save(host_state, tmp), points=True)
    return path


def write_run_config(ckpt_dir: "str | os.PathLike", config: Dict[str, Any]) -> None:
    """The run's ``config.json`` beside its checkpoints, published the same
    crash-safe way before any checkpoint that needs it."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    text = json.dumps(config, indent=2, sort_keys=True)
    _publish(ckpt_dir / CONFIG_NAME, lambda tmp: tmp.write_text(text))


def save_checkpoint(path: "str | os.PathLike", state: Dict[str, Any], config: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``state`` (tensors at any depth are saved from the CPU) and, if
    given, the run ``config`` as ``config.json`` in the same directory, the
    config first."""
    path = Path(path)
    if config is not None:
        write_run_config(path.parent, config)
    return write_host_checkpoint(path, _to_cpu(state))


def load_checkpoint(path: "str | os.PathLike") -> Dict[str, Any]:
    """The saved state, on the CPU. Only tensors and containers load
    (``weights_only``): a checkpoint never runs code. A missing, truncated or
    scrambled file raises :class:`CheckpointError`."""
    path = Path(path)
    if not path.is_file():
        raise CheckpointError(f"Checkpoint file does not exist: {path}", path)
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch.load raises many kinds on bad bytes; all mean the file is unusable
        raise CheckpointError(f"Unreadable/truncated checkpoint {path}: {type(e).__name__}: {e}", path) from e
    if not isinstance(state, dict):
        raise CheckpointError(f"Checkpoint {path} holds a {type(state).__name__}, not a state dict", path)
    return state


def find_run_config(checkpoint_path: "str | os.PathLike") -> Path:
    """The ``config.json`` of the run that wrote ``checkpoint_path``: beside
    it; in, or in the parent of, an ancestor holding the manager's
    ``manifest.json`` (that ancestor is the run's ``checkpoint/``
    directory), looked for up to the nearest ancestor named ``checkpoint``,
    else in the four nearest; or in one of the three directories above it.
    Nothing further up is read. Raises :class:`CheckpointError` naming every
    path searched."""
    ckpt = Path(checkpoint_path).resolve()
    parents = list(ckpt.parents)
    nearest = parents[:4]
    named = next((i for i, anc in enumerate(parents) if anc.name == "checkpoint"), None)
    candidates = [ckpt.parent / CONFIG_NAME]
    for anc in (parents[: named + 1] if named is not None else nearest):
        if (anc / MANIFEST_NAME).is_file():
            candidates += [anc / CONFIG_NAME, anc.parent / CONFIG_NAME]
    candidates += [anc / CONFIG_NAME for anc in nearest]
    searched: List[Path] = []
    for cand in candidates:
        if cand in searched:
            continue
        searched.append(cand)
        if cand.is_file():
            return cand
    raise CheckpointError(
        f"no {CONFIG_NAME} found for checkpoint {checkpoint_path}; searched: " + ", ".join(map(str, searched)),
        checkpoint_path,
    )
