"""Run directories and the metric logger (counterpart of
``sheeprl_tpu/utils/logger.py``, one process).

Every run gets a directory of its own,
``<log_root>/<root_dir>/<run_name>/version_N``, with ``N`` one more than the
highest numeric ``version_*`` already there. It holds the run's
``config.json``, its ``checkpoint/`` directory, the ``memmap_buffer/`` of a
memmapped replay buffer, and what the logger writes:

- ``metrics.jsonl``: one JSON object per :meth:`JsonlWriter.log_dict` call,
  ``{"step": <policy step>, "<name>": <value>, ...}``, scalars only;
- ``hparams.json``: the run's configuration.

TensorBoard and mlflow are not ported: ``logger.name`` is ``jsonl``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.config import plain

__all__ = ["NullWriter", "JsonlWriter", "get_logger", "get_log_dir", "METRICS_NAME", "HPARAMS_NAME"]

METRICS_NAME = "metrics.jsonl"
HPARAMS_NAME = "hparams.json"


class NullWriter:
    """The logger at ``metric.log_level <= 0``: writes nothing."""

    log_dir: Optional[str] = None

    def log_dict(self, metrics: Mapping[str, Any], step: int) -> None:
        pass

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlWriter:
    """JSON lines in place of TensorBoard's event files, with the JAX
    package's ``TensorBoardWriter`` surface. Each :meth:`log_dict` appends one
    line and flushes it, so a reader sees every line of a run that died."""

    def __init__(self, log_dir: "str | os.PathLike") -> None:
        self.log_dir = str(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._file = open(os.path.join(self.log_dir, METRICS_NAME), "a")

    def log_dict(self, metrics: Mapping[str, Any], step: int) -> None:
        row = {"step": int(step)}
        for name, value in metrics.items():
            arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
            if arr.size == 1:  # scalars only, as TensorBoard's add_scalar
                row[name] = float(arr.reshape(()))
        if len(row) > 1:
            self._file.write(json.dumps(row) + "\n")
            self._file.flush()

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        with open(os.path.join(self.log_dir, HPARAMS_NAME), "w") as f:
            json.dump(plain(params), f, indent=2, sort_keys=True, default=str)

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


def get_logger(cfg: Mapping[str, Any], log_dir: "str | os.PathLike", rank: int = 0):
    """:class:`NullWriter` at ``metric.log_level <= 0`` and on every rank
    but 0 (only rank 0 of a pod logs), else the writer ``logger.name`` names
    (``jsonl``, the default)."""
    if int((cfg.get("metric") or {}).get("log_level", 1)) <= 0 or rank != 0:
        return NullWriter()
    kind = str((cfg.get("logger") or {}).get("name") or "jsonl")
    if kind == "jsonl":
        return JsonlWriter(log_dir)
    if kind == "tensorboard":
        raise ValueError("logger.name=tensorboard needs the tensorboardX package, which the port does not use; "
                         "use logger.name=jsonl")
    if kind == "mlflow":
        raise ValueError("logger.name=mlflow needs the mlflow package, which the port does not use; "
                         "use logger.name=jsonl")
    raise ValueError(f"Unknown logger '{kind}' (logger.name=jsonl)")


def get_log_dir(cfg: Mapping[str, Any], root_dir: str, run_name: str) -> str:
    """Create and return ``<log_root>/<root_dir>/<run_name>/version_N``, ``N``
    one more than the highest numeric ``version_*`` under
    ``<log_root>/<root_dir>/<run_name>`` (0 for the first); other names are
    ignored. The directory is claimed by an exclusive ``mkdir``: of two runs
    that pick the same ``N`` at once, the second takes ``N + 1``. In a
    ``torch.distributed`` group rank 0 picks and claims it, and every rank
    gets rank 0's path (each worker timestamps its own ``run_name``)."""
    from sheeprl_tpu_torch.parallel.distributed import rank, world_size

    if world_size() > 1:
        import torch.distributed as dist

        box = [_claim_log_dir(cfg, root_dir, run_name) if rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return str(box[0])
    return _claim_log_dir(cfg, root_dir, run_name)


def _claim_log_dir(cfg: Mapping[str, Any], root_dir: str, run_name: str) -> str:
    base = Path(str(cfg.get("log_root", "logs/runs"))) / str(root_dir) / str(run_name)
    base.mkdir(parents=True, exist_ok=True)
    existing = []
    for child in base.iterdir():
        if child.is_dir() and child.name.startswith("version_"):
            try:
                existing.append(int(child.name.split("_", 1)[1]))
            except ValueError:
                pass
    version = max(existing) + 1 if existing else 0
    while True:
        log_dir = base / f"version_{version}"
        try:
            log_dir.mkdir()
            return str(log_dir)
        except FileExistsError:
            version += 1

