"""Batched environments on a torch device for the Anakin loops (counterpart
of ``sheeprl_tpu/envs/jax_envs``): CartPole-v1, Pendulum-v1, Acrobot-v1 and
MountainCar-v0, registered under their gymnasium ids (see :mod:`.base`)."""

from sheeprl_tpu_torch.envs.device_envs.acrobot import Acrobot, AcrobotParams, AcrobotState
from sheeprl_tpu_torch.envs.device_envs.base import (
    DEVICE_ENV_REGISTRY,
    BatchedDeviceEnv,
    DeviceEnv,
    is_device_env,
    make_device_env,
    params_batch_shape,
    register_device_env,
    stack_params,
    uniform_between,
)
from sheeprl_tpu_torch.envs.device_envs.cartpole import CartPole, CartPoleParams, CartPoleState
from sheeprl_tpu_torch.envs.device_envs.mountain_car import MountainCar, MountainCarParams, MountainCarState
from sheeprl_tpu_torch.envs.device_envs.pendulum import Pendulum, PendulumParams, PendulumState

__all__ = [
    "DEVICE_ENV_REGISTRY",
    "BatchedDeviceEnv",
    "DeviceEnv",
    "is_device_env",
    "make_device_env",
    "params_batch_shape",
    "register_device_env",
    "stack_params",
    "uniform_between",
    "CartPole",
    "CartPoleParams",
    "CartPoleState",
    "Pendulum",
    "PendulumParams",
    "PendulumState",
    "Acrobot",
    "AcrobotParams",
    "AcrobotState",
    "MountainCar",
    "MountainCarParams",
    "MountainCarState",
]
