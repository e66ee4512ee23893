"""Acrobot-v1 on the device (counterpart of
``sheeprl_tpu/envs/jax_envs/acrobot.py``): gymnasium's constants, one RK4
stage over ``dt = 0.2`` of the "book" dynamics, angle wrap and velocity
bounds, reward -1 (0 on the terminating step) and ``U(-0.1, 0.1)^4`` reset,
in float32; the 500-step TimeLimit is a step counter in the state."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from sheeprl_tpu_torch.envs.device_envs.base import DeviceEnv, register_device_env, step_info, uniform_between

__all__ = ["Acrobot", "AcrobotState", "AcrobotParams"]


class AcrobotState(NamedTuple):
    physics: torch.Tensor  # (..., 4) float32: theta1, theta2, dtheta1, dtheta2
    t: torch.Tensor  # int32


class AcrobotParams(NamedTuple):
    dt: torch.Tensor
    link_length_1: torch.Tensor
    link_mass_1: torch.Tensor
    link_mass_2: torch.Tensor
    link_com_pos_1: torch.Tensor
    link_com_pos_2: torch.Tensor
    link_moi: torch.Tensor
    max_vel_1: torch.Tensor
    max_vel_2: torch.Tensor
    gravity: torch.Tensor
    max_episode_steps: torch.Tensor  # int32


def _wrap(x: torch.Tensor, m: float, M: float) -> torch.Tensor:
    return torch.remainder(x - m, M - m) + m


@register_device_env("Acrobot-v1")
class Acrobot(DeviceEnv):
    reset_shape = (4,)
    obs_dim = 6
    n_actions = 3
    dt, link_length_1, link_mass_1, link_mass_2, link_com_pos_1, link_com_pos_2, link_moi = (
        0.2, 1.0, 1.0, 1.0, 0.5, 0.5, 1.0)
    max_vel_1, max_vel_2, gravity = 4 * math.pi, 9 * math.pi, 9.8

    def __init__(self, max_episode_steps: int = 500) -> None:
        self.max_episode_steps = int(max_episode_steps)

    def default_params(self, device: "torch.device | str" = "cpu") -> AcrobotParams:
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return AcrobotParams(
            dt=f(self.dt), link_length_1=f(self.link_length_1), link_mass_1=f(self.link_mass_1),
            link_mass_2=f(self.link_mass_2), link_com_pos_1=f(self.link_com_pos_1),
            link_com_pos_2=f(self.link_com_pos_2), link_moi=f(self.link_moi), max_vel_1=f(self.max_vel_1),
            max_vel_2=f(self.max_vel_2), gravity=f(self.gravity),
            max_episode_steps=torch.tensor(self.max_episode_steps, dtype=torch.int32, device=device),
        )

    @staticmethod
    def _obs(s: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = s.unbind(-1)
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2), d1, d2], dim=-1)

    def reset(self, noise: torch.Tensor, params: AcrobotParams) -> Tuple[AcrobotState, torch.Tensor]:
        physics = uniform_between(noise, -0.1, 0.1)
        t = torch.zeros(noise.shape[:-1], dtype=torch.int32, device=noise.device)
        return AcrobotState(physics, t), self._obs(physics)

    @staticmethod
    def _dsdt(s: torch.Tensor, torque: torch.Tensor, p: AcrobotParams) -> torch.Tensor:
        m1, m2, l1 = p.link_mass_1, p.link_mass_2, p.link_length_1
        lc1, lc2 = p.link_com_pos_1, p.link_com_pos_2
        i1 = i2 = p.link_moi
        g = p.gravity
        theta1, theta2, dtheta1, dtheta2 = s.unbind(-1)
        d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(theta2)) + i1 + i2
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(theta2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (torque + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * torch.sin(theta2) - phi2) / (
            m2 * lc2**2 + i2 - d2**2 / d1
        )
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)

    def step(self, state: AcrobotState, action: torch.Tensor, p: AcrobotParams
             ) -> Tuple[AcrobotState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        torque = action.to(torch.float32) - 1.0  # actions 0, 1, 2: torques -1, 0, +1
        y0 = state.physics
        dt = p.dt.unsqueeze(-1) if p.dt.dim() else p.dt  # (P, 1) -> (P, 1, 1) over the physics' last axis
        dt2 = dt / 2.0
        k1 = self._dsdt(y0, torque, p)
        k2 = self._dsdt(y0 + dt2 * k1, torque, p)
        k3 = self._dsdt(y0 + dt2 * k2, torque, p)
        k4 = self._dsdt(y0 + dt * k3, torque, p)
        ns = y0 + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        t1, t2, d1, d2 = ns.unbind(-1)
        ns = torch.stack([
            _wrap(t1, -math.pi, math.pi),
            _wrap(t2, -math.pi, math.pi),
            torch.clamp(d1, -p.max_vel_1, p.max_vel_1),
            torch.clamp(d2, -p.max_vel_2, p.max_vel_2),
        ], dim=-1)
        t = state.t + 1
        terminated = (-torch.cos(ns[..., 0]) - torch.cos(ns[..., 1] + ns[..., 0])) > 1.0
        done, info = step_info(terminated, t >= p.max_episode_steps)
        reward = torch.where(terminated, 0.0, -1.0).to(torch.float32)
        return AcrobotState(ns, t), self._obs(ns), reward, done, info
