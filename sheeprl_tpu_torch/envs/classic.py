"""CartPole-v1 and Pendulum-v1 in numpy, without gymnasium (counterparts of
what the JAX package builds with ``gymnasium.make`` through
``sheeprl_tpu/envs/factory.py``, and of its pure-JAX twins
``sheeprl_tpu/envs/jax_envs/{cartpole,pendulum}.py``).

gymnasium's ``CartPoleEnv`` semantics, line for line: the same constants,
Euler step and termination bounds, +1 reward per step, the reset draw
``U(-0.05, 0.05)^4`` from ``np.random.default_rng(seed)`` (gymnasium's
``np_random``), the physics state kept in float64 and the observation
returned as float32, and the 500-step ``TimeLimit`` truncation that
``gymnasium.make`` adds. One seed and one action sequence give gymnasium's
trajectory bit for bit. The observation is a dict under the MLP encoder key,
as the JAX factory wraps a 1-D Box (``_AsDictObs``).

Pendulum-v1 follows gymnasium's ``PendulumEnv`` the same way: float64 state
``(theta, theta_dot)`` drawn ``U(-[pi, 1], [pi, 1])`` from the seeded
generator, the torque clipped to [-2, 2], reward ``-(angle_normalize(theta)^2
+ 0.1 theta_dot^2 + 0.001 u^2)`` with gymnasium's types, speed clipped to
+-8, the float32 observation ``[cos theta, sin theta, theta_dot]``; it never
terminates and is truncated after 200 steps.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

__all__ = ["CartPoleEnv", "PendulumEnv"]


class CartPoleEnv:
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02  # seconds between state updates
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, obs_key: str = "state", max_episode_steps: int = 500, seed: Optional[int] = None) -> None:
        self.obs_key = str(obs_key)
        self.max_episode_steps = int(max_episode_steps)
        self._rng = np.random.default_rng(seed)
        self.state: Optional[np.ndarray] = None
        self._elapsed = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        """The run config's ``spaces`` block for this env."""
        return {"obs": {self.obs_key: {"shape": [4], "dtype": "float32"}}, "actions": {"n": [2], "continuous": False}}

    def _observe(self) -> Dict[str, np.ndarray]:
        return {self.obs_key: np.array(self.state, dtype=np.float32)}

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._elapsed = 0
        return self._observe(), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._observe(), 1.0, terminated, truncated, {}

    def close(self) -> None:
        pass


class PendulumEnv:
    max_speed = 8
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0  # noqa: E741 - gymnasium's name

    def __init__(self, obs_key: str = "state", max_episode_steps: int = 200, seed: Optional[int] = None) -> None:
        self.obs_key = str(obs_key)
        self.max_episode_steps = int(max_episode_steps)
        self._rng = np.random.default_rng(seed)
        self.state: Optional[np.ndarray] = None
        self._elapsed = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        """The run config's ``spaces`` block: a Box action of one torque."""
        return {
            "obs": {self.obs_key: {"shape": [3], "dtype": "float32"}},
            "actions": {"shape": [1], "low": [-self.max_torque], "high": [self.max_torque], "continuous": True},
        }

    def _observe(self) -> Dict[str, np.ndarray]:
        theta, theta_dot = self.state
        return {self.obs_key: np.array([np.cos(theta), np.sin(theta), theta_dot], dtype=np.float32)}

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._elapsed = 0
        return self._observe(), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        th, thdot = self.state
        # gymnasium indexes the clipped action array: the torque keeps the action's dtype
        u = np.clip(np.reshape(action, (-1,)), -self.max_torque, self.max_torque)[0]
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th) + 3.0 / (self.m * self.l**2) * u) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        self.state = np.array([newth, newthdot])
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._observe(), -costs, False, truncated, {}

    def close(self) -> None:
        pass


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi
