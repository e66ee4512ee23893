from sheeprl_tpu_torch.optim.builders import (
    ClippedOptimizer,
    StackedAdam,
    adam,
    build_optimizer,
    build_stacked_optimizer,
    clip_by_member_norm_,
)

__all__ = ["ClippedOptimizer", "StackedAdam", "adam", "build_optimizer", "build_stacked_optimizer",
           "clip_by_member_norm_"]
