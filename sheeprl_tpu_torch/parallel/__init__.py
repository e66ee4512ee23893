"""Runtime policies (counterpart of ``sheeprl_tpu/parallel``): the
precision policy, the Sebulba device split (:func:`partition`) and the
actor-learner pipeline (:mod:`~sheeprl_tpu_torch.parallel.pipeline`, imported
by the loops that use it). The device mesh has no counterpart yet."""

from sheeprl_tpu_torch.parallel.fabric import PRECISION_ALIASES, Precision, compute_dtype, partition

__all__ = ["PRECISION_ALIASES", "Precision", "compute_dtype", "partition"]
