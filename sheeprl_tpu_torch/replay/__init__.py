"""Device-resident replay (counterpart of ``sheeprl_tpu/replay``, the
SAC-shaped part): ring storage in card memory, one packed host->device copy
per env step, and sampling (uniform, or prioritized through the sum-tree)
on the device, so append, sample and train are one dispatch per env step.

- :mod:`~sheeprl_tpu_torch.replay.sumtree`: the sum-tree for PER;
- :mod:`~sheeprl_tpu_torch.replay.device_buffer`: :class:`DeviceReplayBuffer`
  and the spillover sizing.
"""

from sheeprl_tpu_torch.replay.device_buffer import (
    DeviceReplayBuffer,
    DeviceReplayState,
    ReplayJob,
    estimate_ring_bytes,
    resolve_device_resident,
    restore_host_buffer,
)

__all__ = [
    "DeviceReplayBuffer",
    "DeviceReplayState",
    "ReplayJob",
    "estimate_ring_bytes",
    "resolve_device_resident",
    "restore_host_buffer",
]
