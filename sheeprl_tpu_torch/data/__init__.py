from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

__all__ = ["EnvIndependentReplayBuffer", "ReplayBuffer", "SequentialReplayBuffer"]
