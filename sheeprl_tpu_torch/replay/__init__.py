"""Device-resident replay (counterpart of ``sheeprl_tpu/replay``): ring
storage in card memory, one packed host->device copy per env step, and
sampling on the device, so append, sample and train are one dispatch per
env step.

- :mod:`~sheeprl_tpu_torch.replay.sumtree`: the sum-tree for PER;
- :mod:`~sheeprl_tpu_torch.replay.device_buffer`: :class:`DeviceReplayBuffer`
  (SAC's flat ring, uniform or prioritized, with the decoupled topology's
  append blobs and control jobs), the spillover sizing and the crossovers to
  the host buffers;
- :mod:`~sheeprl_tpu_torch.replay.driver`: :class:`SequenceRingDriver`
  (DreamerV3's per-env-head sequence ring), and :class:`AsyncSequenceRing`
  with :class:`SeqBlobWriter` (the same ring fed by actor threads);
- :mod:`~sheeprl_tpu_torch.replay.indices`: the host buffers' draw
  arithmetic (eligible rows, window starts) on tensors.
"""

from sheeprl_tpu_torch.replay.device_buffer import (
    ControlJob,
    DeviceReplayBuffer,
    DeviceReplayState,
    ReplayJob,
    estimate_ring_bytes,
    resolve_device_resident,
    restore_host_buffer,
    restore_host_env_buffer,
)
from sheeprl_tpu_torch.replay.driver import AsyncSequenceRing, SeqBlobWriter, SequenceRingDriver

__all__ = [
    "AsyncSequenceRing",
    "ControlJob",
    "DeviceReplayBuffer",
    "DeviceReplayState",
    "ReplayJob",
    "estimate_ring_bytes",
    "resolve_device_resident",
    "restore_host_buffer",
    "restore_host_env_buffer",
    "SeqBlobWriter",
    "SequenceRingDriver",
]
