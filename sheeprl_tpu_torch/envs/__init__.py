from sheeprl_tpu_torch.envs.classic import CartPoleEnv, PendulumEnv
from sheeprl_tpu_torch.envs.dummy import (
    COUNTER_ENVS,
    AtariProtocolDummyEnv,
    ContinuousDummyEnv,
    DiscreteDummyEnv,
    MultiDiscreteDummyEnv,
    resize_area,
    rgb_to_gray,
)
from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, make_env, make_vector_env

__all__ = [
    "AtariProtocolDummyEnv",
    "COUNTER_ENVS",
    "CartPoleEnv",
    "ContinuousDummyEnv",
    "DiscreteDummyEnv",
    "MultiDiscreteDummyEnv",
    "PendulumEnv",
    "SyncVectorEnv",
    "make_env",
    "make_vector_env",
    "resize_area",
    "rgb_to_gray",
]
