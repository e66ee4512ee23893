from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer

__all__ = ["EnvIndependentReplayBuffer", "SequentialReplayBuffer"]
