"""The port's checkpoint format: ``torch.save`` of a dict of state dicts and
plain values (for DreamerV3 training: ``world_model``, ``actor``, ``critic``,
``target_critic``, ``optimizers``, ``moments``, ``ratio``, the loop's
counters and the generator state ``rng``; serving reads ``world_model`` and
``actor``), with the run's ``config.json`` beside it. Both are written
atomically (temp file, then ``os.replace``), so a reader never sees half a
file."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "find_run_config"]

CONFIG_NAME = "config.json"


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _to_cpu(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def save_checkpoint(path: "str | os.PathLike", state: Dict[str, Any], config: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``state`` (tensors at any depth are saved from the CPU) and, if given, the run
    ``config`` as ``config.json`` in the same directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cpu_state = _to_cpu(state)
    _atomic_write(path, lambda tmp: torch.save(cpu_state, tmp))
    if config is not None:
        text = json.dumps(config, indent=2, sort_keys=True)
        _atomic_write(path.parent / CONFIG_NAME, lambda tmp: tmp.write_text(text))
    return path


def load_checkpoint(path: "str | os.PathLike") -> Dict[str, Any]:
    """The saved state, on the CPU. Only tensors and containers load
    (``weights_only``): a checkpoint never runs code."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def find_run_config(checkpoint_path: "str | os.PathLike") -> Path:
    """The ``config.json`` beside the checkpoint or in one of the three
    directories above it."""
    here = Path(checkpoint_path).resolve().parent
    for _ in range(4):
        candidate = here / CONFIG_NAME
        if candidate.is_file():
            return candidate
        here = here.parent
    raise FileNotFoundError(f"no {CONFIG_NAME} beside or above {checkpoint_path}")
