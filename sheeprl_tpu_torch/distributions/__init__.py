from sheeprl_tpu_torch.distributions.core import OneHotCategorical, OneHotCategoricalStraightThrough

__all__ = ["OneHotCategorical", "OneHotCategoricalStraightThrough"]
