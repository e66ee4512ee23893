from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer, SequentialReplayBuffer

__all__ = ["EnvIndependentReplayBuffer", "EpisodeBuffer", "ReplayBuffer", "SequentialReplayBuffer"]
