from sheeprl_tpu_torch.envs.classic import CartPoleEnv, PendulumEnv
from sheeprl_tpu_torch.envs.dummy import AtariProtocolDummyEnv, resize_area
from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, make_env, make_vector_env

__all__ = ["AtariProtocolDummyEnv", "CartPoleEnv", "PendulumEnv", "SyncVectorEnv", "make_env", "make_vector_env", "resize_area"]
