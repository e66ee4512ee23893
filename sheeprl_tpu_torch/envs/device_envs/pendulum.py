"""Pendulum-v1 on the device (counterpart of
``sheeprl_tpu/envs/jax_envs/pendulum.py``): gymnasium's constants,
semi-implicit Euler update, cost and ``U([-pi, pi] x [-1, 1])`` reset, in
float32; it never terminates and the 200-step TimeLimit is a step counter in
the state."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from sheeprl_tpu_torch.envs.device_envs.base import DeviceEnv, register_device_env, step_info, uniform_between

__all__ = ["Pendulum", "PendulumState", "PendulumParams"]


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32


class PendulumParams(NamedTuple):
    max_speed: torch.Tensor
    max_torque: torch.Tensor
    dt: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    length: torch.Tensor
    max_episode_steps: torch.Tensor  # int32


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


@register_device_env("Pendulum-v1")
class Pendulum(DeviceEnv):
    reset_shape = (2,)
    obs_dim = 3
    n_actions = None
    action_shape = (1,)
    max_speed, max_torque, dt, g, m, length = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
    action_low, action_high = (-max_torque,), (max_torque,)

    def __init__(self, max_episode_steps: int = 200) -> None:
        self.max_episode_steps = int(max_episode_steps)

    def default_params(self, device: "torch.device | str" = "cpu") -> PendulumParams:
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return PendulumParams(
            max_speed=f(self.max_speed), max_torque=f(self.max_torque), dt=f(self.dt), g=f(self.g), m=f(self.m),
            length=f(self.length),
            max_episode_steps=torch.tensor(self.max_episode_steps, dtype=torch.int32, device=device),
        )

    @staticmethod
    def _obs(theta: torch.Tensor, theta_dot: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)

    def reset(self, noise: torch.Tensor, params: PendulumParams) -> Tuple[PendulumState, torch.Tensor]:
        th = uniform_between(noise[..., 0], -math.pi, math.pi)
        thdot = uniform_between(noise[..., 1], -1.0, 1.0)
        t = torch.zeros(th.shape, dtype=torch.int32, device=noise.device)
        return PendulumState(th, thdot, t), self._obs(th, thdot)

    def step(self, state: PendulumState, action: torch.Tensor, p: PendulumParams
             ) -> Tuple[PendulumState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        th, thdot = state.theta, state.theta_dot
        u = torch.clamp(action[..., 0], -p.max_torque, p.max_torque)
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3.0 * p.g / (2.0 * p.length) * torch.sin(th) + 3.0 / (p.m * p.length**2) * u) * p.dt
        newthdot = torch.clamp(newthdot, -p.max_speed, p.max_speed)
        newth = th + newthdot * p.dt
        t = state.t + 1
        done, info = step_info(torch.zeros_like(t, dtype=torch.bool), t >= p.max_episode_steps)
        return PendulumState(newth, newthdot, t), self._obs(newth, newthdot), -cost, done, info
