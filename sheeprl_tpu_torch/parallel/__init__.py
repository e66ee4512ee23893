"""Runtime policies (counterpart of ``sheeprl_tpu/parallel``): the
precision policy, the ``fabric.devices`` rule and the run-start gradient wire
(:mod:`~sheeprl_tpu_torch.parallel.fabric`), the Sebulba device split
(:func:`partition`), the actor-learner pipeline
(:mod:`~sheeprl_tpu_torch.parallel.pipeline`), the ``torch.distributed``
group (:mod:`~sheeprl_tpu_torch.parallel.distributed`), its gradient
collectives (:mod:`~sheeprl_tpu_torch.parallel.comm`) and the pod of training
workers (:mod:`~sheeprl_tpu_torch.parallel.pod`), each imported by the code
that uses it. One process drives one device: the JAX package's device mesh
is a group of processes here."""

from sheeprl_tpu_torch.parallel.fabric import PRECISION_ALIASES, Precision, compute_dtype, partition

__all__ = ["PRECISION_ALIASES", "Precision", "compute_dtype", "partition"]
