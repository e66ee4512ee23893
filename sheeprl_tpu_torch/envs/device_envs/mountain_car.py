"""MountainCar-v0 on the device (counterpart of
``sheeprl_tpu/envs/jax_envs/mountain_car.py``): gymnasium's constants,
velocity and position update, left-wall velocity clamp, goal test, reward -1
per step and ``U(-0.6, -0.4)`` position reset, in float32; the 200-step
TimeLimit is a step counter in the state."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from sheeprl_tpu_torch.envs.device_envs.base import DeviceEnv, register_device_env, step_info, uniform_between

__all__ = ["MountainCar", "MountainCarState", "MountainCarParams"]


class MountainCarState(NamedTuple):
    physics: torch.Tensor  # (..., 2) float32: position, velocity
    t: torch.Tensor  # int32


class MountainCarParams(NamedTuple):
    min_position: torch.Tensor
    max_position: torch.Tensor
    max_speed: torch.Tensor
    goal_position: torch.Tensor
    goal_velocity: torch.Tensor
    force: torch.Tensor
    gravity: torch.Tensor
    max_episode_steps: torch.Tensor  # int32


@register_device_env("MountainCar-v0")
class MountainCar(DeviceEnv):
    reset_shape = ()
    obs_dim = 2
    n_actions = 3
    min_position, max_position, max_speed = -1.2, 0.6, 0.07
    goal_position, goal_velocity, force, gravity = 0.5, 0.0, 0.001, 0.0025

    def __init__(self, max_episode_steps: int = 200) -> None:
        self.max_episode_steps = int(max_episode_steps)

    def default_params(self, device: "torch.device | str" = "cpu") -> MountainCarParams:
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return MountainCarParams(
            min_position=f(self.min_position), max_position=f(self.max_position), max_speed=f(self.max_speed),
            goal_position=f(self.goal_position), goal_velocity=f(self.goal_velocity), force=f(self.force),
            gravity=f(self.gravity),
            max_episode_steps=torch.tensor(self.max_episode_steps, dtype=torch.int32, device=device),
        )

    def reset(self, noise: torch.Tensor, params: MountainCarParams) -> Tuple[MountainCarState, torch.Tensor]:
        position = uniform_between(noise, -0.6, -0.4)
        physics = torch.stack([position, torch.zeros_like(position)], dim=-1)
        return MountainCarState(physics, torch.zeros(noise.shape, dtype=torch.int32, device=noise.device)), physics

    def step(self, state: MountainCarState, action: torch.Tensor, p: MountainCarParams
             ) -> Tuple[MountainCarState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        position, velocity = state.physics.unbind(-1)
        velocity = velocity + (action.to(torch.int32) - 1) * p.force + torch.cos(3 * position) * (-p.gravity)
        velocity = torch.clamp(velocity, -p.max_speed, p.max_speed)
        position = torch.clamp(position + velocity, p.min_position, p.max_position)
        velocity = torch.where((position <= p.min_position) & (velocity < 0.0), 0.0, velocity)
        physics = torch.stack([position, velocity], dim=-1)
        t = state.t + 1
        terminated = (position >= p.goal_position) & (velocity >= p.goal_velocity)
        done, info = step_info(terminated, t >= p.max_episode_steps)
        return MountainCarState(physics, t), physics, torch.full_like(position, -1.0), done, info
