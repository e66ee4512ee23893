from sheeprl_tpu_torch.distributions.core import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    Normal,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    SymlogDistribution,
    TanhNormal,
    TruncatedNormal,
    TwoHotEncodingDistribution,
    kl_divergence,
)

__all__ = [
    "BernoulliSafeMode",
    "Independent",
    "MSEDistribution",
    "Normal",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "SymlogDistribution",
    "TanhNormal",
    "TruncatedNormal",
    "TwoHotEncodingDistribution",
    "kl_divergence",
]
