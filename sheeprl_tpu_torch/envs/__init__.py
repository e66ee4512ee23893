from sheeprl_tpu_torch.envs.dummy import AtariProtocolDummyEnv, resize_area
from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, make_vector_env

__all__ = ["AtariProtocolDummyEnv", "SyncVectorEnv", "make_vector_env", "resize_area"]
