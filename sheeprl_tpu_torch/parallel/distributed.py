"""Multi-process bring-up over ``torch.distributed`` (counterpart of
``sheeprl_tpu/parallel/distributed.py``).

The JAX package starts one process per host and wires them with
``jax.distributed.initialize``; the port starts one process per device and
joins them in one ``torch.distributed`` process group. The backend is gloo:
NCCL refuses two ranks on one card ("Duplicate GPU detected"), and the pod
of :mod:`~sheeprl_tpu_torch.parallel.pod` puts every worker on the one
H100. The gradient collectives stage through host memory on purpose
(:mod:`~sheeprl_tpu_torch.parallel.comm`), so a gloo group serves CUDA ranks
as well as CPU ones.

``run``, ``serve`` and ``serve_fleet`` call :func:`maybe_init` with the
``fabric.distributed`` block; the ``SHEEPRL_COORDINATOR`` /
``SHEEPRL_NUM_PROCESSES`` / ``SHEEPRL_PROCESS_ID`` environment variables
(the pod launcher's per-worker pins) win over it. Outside a group
:func:`world_size` is 1 and :func:`rank` 0.
"""

from __future__ import annotations

import datetime
import os
import time
import warnings
from typing import Any, Dict, Optional

import torch.distributed as dist

__all__ = ["CoordinatorConnectError", "maybe_init", "world_size", "rank", "shutdown", "BACKEND"]

#: the process group's backend (see the module docstring)
BACKEND = "gloo"

_initialized = False


class CoordinatorConnectError(ConnectionError):
    """``init_process_group`` could not reach the coordinator within the
    connect-retry budget. Names the coordinator, so a pod operator can tell a
    dead coordinator from a bad config."""

    def __init__(self, coordinator: str, attempts: int, cause: BaseException) -> None:
        self.coordinator = coordinator
        self.attempts = attempts
        super().__init__(
            f"could not join the torch.distributed group at coordinator '{coordinator}' after {attempts} "
            f"attempt(s): {type(cause).__name__}: {cause}"
        )


def maybe_init(
    cfg: Optional[Dict[str, Any]] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group when running multi-process; returns whether
    THIS call did.

    ``cfg`` is a ``fabric.distributed``-shaped mapping (``enabled``,
    ``coordinator``, ``num_processes``, ``process_id``, ``connect_retries``,
    ``connect_backoff_s``, ``init_timeout_s``). Each field resolves as
    keyword > ``SHEEPRL_*`` environment variable > config key.
    ``enabled: false`` never joins; ``enabled: true`` requires a coordinator
    (a typed error beats N-1 processes silently training solo); ``enabled:
    null`` joins iff a coordinator or a process count was given somewhere.
    A second call, or a single process, is a no-op.

    A gang-spawned worker may call this before rank 0 listens, so the join
    is retried ``connect_retries`` more times with exponential backoff from
    ``connect_backoff_s``; exhaustion raises :class:`CoordinatorConnectError`.
    ``init_timeout_s`` becomes the group's timeout (each join and every
    collective), else torch's default."""
    global _initialized
    if _initialized:
        return False
    cfg = dict(cfg or {})
    enabled = cfg.get("enabled")
    if enabled is False:
        return False
    coordinator_address = coordinator_address or os.environ.get("SHEEPRL_COORDINATOR") or cfg.get("coordinator")
    if num_processes is None:
        if "SHEEPRL_NUM_PROCESSES" in os.environ:
            num_processes = int(os.environ["SHEEPRL_NUM_PROCESSES"])
        elif cfg.get("num_processes") is not None:
            num_processes = int(cfg["num_processes"])
    if process_id is None:
        if "SHEEPRL_PROCESS_ID" in os.environ:
            process_id = int(os.environ["SHEEPRL_PROCESS_ID"])
        elif cfg.get("process_id") is not None:
            process_id = int(cfg["process_id"])
    if coordinator_address is None and num_processes is None:
        if enabled:
            raise ValueError(
                "fabric.distributed.enabled=true but no coordinator was provided — set "
                "fabric.distributed.coordinator (or SHEEPRL_COORDINATOR) so every host "
                "joins the same torch.distributed group instead of silently training solo"
            )
        return False  # single process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a torch.distributed group needs all of fabric.distributed.coordinator, num_processes and process_id "
            f"(or SHEEPRL_COORDINATOR, SHEEPRL_NUM_PROCESSES, SHEEPRL_PROCESS_ID); got coordinator="
            f"{coordinator_address!r}, num_processes={num_processes!r}, process_id={process_id!r}"
        )
    retries = max(0, int(cfg.get("connect_retries", 3) or 0))
    backoff_s = max(0.0, float(cfg.get("connect_backoff_s", 1.0) or 0.0))
    kwargs: Dict[str, Any] = {}
    if cfg.get("init_timeout_s"):
        kwargs["timeout"] = datetime.timedelta(seconds=float(cfg["init_timeout_s"]))
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(
                BACKEND, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                rank=int(process_id), **kwargs,
            )
            break
        except Exception as e:  # the store's connect errors differ by torch version
            if attempt >= retries:
                raise CoordinatorConnectError(str(coordinator_address), retries + 1, e) from e
            delay = backoff_s * (2.0 ** attempt)
            warnings.warn(
                f"torch.distributed connect to coordinator '{coordinator_address}' failed (attempt "
                f"{attempt + 1}/{retries + 1}): {type(e).__name__}: {e} — retrying in {delay:g}s"
            )
            time.sleep(delay)
    _initialized = True
    return True


def world_size() -> int:
    """Processes in the group (1 outside one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the group (0 outside one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the group :func:`maybe_init` joined (a no-op outside one)."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
