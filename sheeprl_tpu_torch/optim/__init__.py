from sheeprl_tpu_torch.optim.builders import ClippedOptimizer, adam, build_optimizer

__all__ = ["ClippedOptimizer", "adam", "build_optimizer"]
