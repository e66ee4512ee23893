"""Runtime policies (counterpart of ``sheeprl_tpu/parallel``): the
precision policy. The device mesh has no counterpart yet."""

from sheeprl_tpu_torch.parallel.fabric import PRECISION_ALIASES, Precision, compute_dtype

__all__ = ["PRECISION_ALIASES", "Precision", "compute_dtype"]
