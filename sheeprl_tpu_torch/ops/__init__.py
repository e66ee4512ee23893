from sheeprl_tpu_torch.ops.core import counter_uniform, symexp, symlog

__all__ = ["counter_uniform", "symexp", "symlog"]
