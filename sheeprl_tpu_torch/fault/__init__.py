"""Fault-tolerant training runtime (counterpart of ``sheeprl_tpu/fault``'s
training half): crash-safe, manifest-published, optionally asynchronous
checkpoints with ``resume_from=latest`` (:mod:`~sheeprl_tpu_torch.fault.manager`),
the divergence sentinel around the in-step finite guard
(:mod:`~sheeprl_tpu_torch.fault.sentinel`), self-healing vector-env workers
(:mod:`~sheeprl_tpu_torch.fault.watchdog`) and the deterministic injection
harness that tests them (:mod:`~sheeprl_tpu_torch.fault.inject`)."""

from sheeprl_tpu_torch.fault.inject import FaultInjected, FlakyEnv, NaNInjector, fault_point
from sheeprl_tpu_torch.fault.manager import (
    CheckpointManager,
    complete_entries,
    find_latest_run_checkpoint,
    latest_complete,
    load_resume_state,
    read_manifest,
)
from sheeprl_tpu_torch.fault.sentinel import DivergenceError, DivergenceSentinel
from sheeprl_tpu_torch.fault.watchdog import EnvTimeoutError, SelfHealingEnv
from sheeprl_tpu_torch.utils.checkpoint import CheckpointError

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "DivergenceError",
    "DivergenceSentinel",
    "EnvTimeoutError",
    "FaultInjected",
    "FlakyEnv",
    "NaNInjector",
    "SelfHealingEnv",
    "complete_entries",
    "fault_point",
    "find_latest_run_checkpoint",
    "latest_complete",
    "load_resume_state",
    "read_manifest",
]
