from sheeprl_tpu_torch.ops.core import counter_normal, counter_uniform, layer_norm, symexp, symlog

__all__ = ["counter_normal", "counter_uniform", "layer_norm", "symexp", "symlog"]
