"""CartPole-v1 on the device (counterpart of
``sheeprl_tpu/envs/jax_envs/cartpole.py``): gymnasium's constants, Euler
step, termination bounds, +1 reward per step and ``U(-0.05, 0.05)^4`` reset,
in float32 as the JAX twin computes (gymnasium and the port's host
``envs/classic.py`` keep float64), with the 500-step TimeLimit as a step
counter in the state."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from sheeprl_tpu_torch.envs.device_envs.base import DeviceEnv, register_device_env, step_info, uniform_between

__all__ = ["CartPole", "CartPoleState", "CartPoleParams"]


class CartPoleState(NamedTuple):
    physics: torch.Tensor  # (..., 4) float32: x, x_dot, theta, theta_dot
    t: torch.Tensor  # (...) int32 steps taken this episode


class CartPoleParams(NamedTuple):
    gravity: torch.Tensor
    masscart: torch.Tensor
    masspole: torch.Tensor
    length: torch.Tensor  # half the pole's length
    force_mag: torch.Tensor
    tau: torch.Tensor
    theta_threshold: torch.Tensor
    x_threshold: torch.Tensor
    max_episode_steps: torch.Tensor  # int32


@register_device_env("CartPole-v1")
class CartPole(DeviceEnv):
    reset_shape = (4,)
    obs_dim = 4
    n_actions = 2
    gravity, masscart, masspole, length, force_mag, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, max_episode_steps: int = 500) -> None:
        self.max_episode_steps = int(max_episode_steps)

    def default_params(self, device: "torch.device | str" = "cpu") -> CartPoleParams:
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return CartPoleParams(
            gravity=f(self.gravity), masscart=f(self.masscart), masspole=f(self.masspole), length=f(self.length),
            force_mag=f(self.force_mag), tau=f(self.tau), theta_threshold=f(self.theta_threshold),
            x_threshold=f(self.x_threshold),
            max_episode_steps=torch.tensor(self.max_episode_steps, dtype=torch.int32, device=device),
        )

    def reset(self, noise: torch.Tensor, params: CartPoleParams) -> Tuple[CartPoleState, torch.Tensor]:
        physics = uniform_between(noise, -0.05, 0.05)
        return CartPoleState(physics, torch.zeros(noise.shape[:-1], dtype=torch.int32, device=noise.device)), physics

    def step(self, state: CartPoleState, action: torch.Tensor, p: CartPoleParams
             ) -> Tuple[CartPoleState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        total_mass = p.masspole + p.masscart
        polemass_length = p.masspole * p.length
        x, x_dot, theta, theta_dot = state.physics.unbind(-1)
        force = torch.where(action == 1, p.force_mag, -p.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (p.gravity * sintheta - costheta * temp) / (
            p.length * (4.0 / 3.0 - p.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + p.tau * x_dot
        x_dot = x_dot + p.tau * xacc
        theta = theta + p.tau * theta_dot
        theta_dot = theta_dot + p.tau * thetaacc
        physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state.t + 1
        terminated = (x < -p.x_threshold) | (x > p.x_threshold) | (theta < -p.theta_threshold) | (theta > p.theta_threshold)
        done, info = step_info(terminated, t >= p.max_episode_steps)
        return CartPoleState(physics, t), physics, torch.ones_like(x), done, info
