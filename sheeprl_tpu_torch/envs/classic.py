"""CartPole-v1, Pendulum-v1, Acrobot-v1 and MountainCar-v0 in numpy,
without gymnasium (counterparts of what the JAX package builds with
``gymnasium.make`` through ``sheeprl_tpu/envs/factory.py``, and of its
pure-JAX twins ``sheeprl_tpu/envs/jax_envs/{cartpole,pendulum,acrobot,
mountain_car}.py``).

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

Acrobot-v1 follows gymnasium's ``AcrobotEnv``: the reset draw
``U(-0.1, 0.1)^4`` cast to float32, then each step one RK4 stage over
``[0, dt=0.2]`` of the "book" dynamics in float64, both angles wrapped to
``[-pi, pi]`` and the velocities bounded at 4 pi and 9 pi; the float32
observation ``[cos t1, sin t1, cos t2, sin t2, dt1, dt2]``; reward -1, 0 on
the step that lifts the tip above the bar (``-cos t1 - cos(t1 + t2) > 1``,
which terminates); truncated after 500 steps. Three actions: torque -1, 0, +1.

MountainCar-v0 follows gymnasium's ``MountainCarEnv``: position drawn
``U(-0.6, -0.4)`` with velocity 0 in float64, the velocity pushed by
``(action - 1) * 0.001 - 0.0025 cos(3 position)`` and clipped to +-0.07,
the position clipped to ``[-1.2, 0.6]`` (where the velocity stops if it
points left), termination at ``position >= 0.5``, reward -1 every step,
truncated after 200 steps; the float32 observation ``[position, velocity]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

__all__ = ["CartPoleEnv", "PendulumEnv", "AcrobotEnv", "MountainCarEnv", "CLASSIC_ENVS"]


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


def _wrap(x, m, M):
    diff = M - m
    while x > M:
        x = x - diff
    while x < m:
        x = x + diff
    return x


def _bound(x, m, M):
    return min(max(x, m), M)


class AcrobotEnv:
    dt = 0.2
    LINK_LENGTH_1 = 1.0
    LINK_LENGTH_2 = 1.0
    LINK_MASS_1 = 1.0
    LINK_MASS_2 = 1.0
    LINK_COM_POS_1 = 0.5
    LINK_COM_POS_2 = 0.5
    LINK_MOI = 1.0
    MAX_VEL_1 = 4 * np.pi
    MAX_VEL_2 = 9 * np.pi
    AVAIL_TORQUE = [-1.0, 0.0, +1]

    def __init__(self, obs_key: str = "state", max_episode_steps: int = 500, seed: Optional[int] = None) -> None:
        self.obs_key = str(obs_key)
        self.max_episode_steps = int(max_episode_steps)
        self._rng = np.random.default_rng(seed)
        self.state: Optional[np.ndarray] = None
        self._elapsed = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        """The run config's ``spaces`` block: three torques."""
        return {"obs": {self.obs_key: {"shape": [6], "dtype": "float32"}}, "actions": {"n": [3], "continuous": False}}

    def _observe(self) -> Dict[str, np.ndarray]:
        s = self.state
        return {self.obs_key: np.array([np.cos(s[0]), np.sin(s[0]), np.cos(s[1]), np.sin(s[1]), s[2], s[3]],
                                       dtype=np.float32)}

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.1, high=0.1, size=(4,)).astype(np.float32)
        self._elapsed = 0
        return self._observe(), {}

    def _dsdt(self, s_augmented):
        m1, m2 = self.LINK_MASS_1, self.LINK_MASS_2
        l1 = self.LINK_LENGTH_1
        lc1, lc2 = self.LINK_COM_POS_1, self.LINK_COM_POS_2
        I1 = I2 = self.LINK_MOI
        g = 9.8
        a = s_augmented[-1]
        theta1, theta2, dtheta1, dtheta2 = s_augmented[:-1]
        d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * np.cos(theta2)) + I1 + I2
        d2 = m2 * (lc2**2 + l1 * lc2 * np.cos(theta2)) + I2
        phi2 = m2 * lc2 * g * np.cos(theta1 + theta2 - np.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * np.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * np.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * np.cos(theta1 - np.pi / 2)
            + phi2
        )
        ddtheta2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * np.sin(theta2) - phi2) / (
            m2 * lc2**2 + I2 - d2**2 / d1
        )
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return dtheta1, dtheta2, ddtheta1, ddtheta2, 0.0

    def _rk4(self, y0: np.ndarray) -> np.ndarray:
        """gymnasium's ``rk4`` over the one interval ``[0, dt]``."""
        yout = np.zeros((2, len(y0)), np.float64)
        yout[0] = y0
        t = [0, self.dt]
        dt = t[1] - t[0]
        dt2 = dt / 2.0
        y0 = yout[0]
        k1 = np.asarray(self._dsdt(y0))
        k2 = np.asarray(self._dsdt(y0 + dt2 * k1))
        k3 = np.asarray(self._dsdt(y0 + dt2 * k2))
        k4 = np.asarray(self._dsdt(y0 + dt * k3))
        yout[1] = y0 + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return yout[-1][:4]

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        ns = self._rk4(np.append(self.state, self.AVAIL_TORQUE[int(action)]))
        ns[0] = _wrap(ns[0], -np.pi, np.pi)
        ns[1] = _wrap(ns[1], -np.pi, np.pi)
        ns[2] = _bound(ns[2], -self.MAX_VEL_1, self.MAX_VEL_1)
        ns[3] = _bound(ns[3], -self.MAX_VEL_2, self.MAX_VEL_2)
        self.state = ns
        terminated = bool(-np.cos(ns[0]) - np.cos(ns[1] + ns[0]) > 1.0)
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._observe(), -1.0 if not terminated else 0.0, terminated, truncated, {}

    def close(self) -> None:
        pass


class MountainCarEnv:
    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.5
    goal_velocity = 0
    force = 0.001
    gravity = 0.0025

    def __init__(self, obs_key: str = "state", max_episode_steps: int = 200, seed: Optional[int] = None) -> None:
        self.obs_key = str(obs_key)
        self.max_episode_steps = int(max_episode_steps)
        self._rng = np.random.default_rng(seed)
        self.state = None
        self._elapsed = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        """The run config's ``spaces`` block: push left, no push, push right."""
        return {"obs": {self.obs_key: {"shape": [2], "dtype": "float32"}}, "actions": {"n": [3], "continuous": False}}

    def _observe(self) -> Dict[str, np.ndarray]:
        return {self.obs_key: np.array(self.state, dtype=np.float32)}

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = np.array([self._rng.uniform(low=-0.6, high=-0.4), 0])
        self._elapsed = 0
        return self._observe(), {}

    def step(self, action):
        if self.state is None:
            raise RuntimeError("call reset before step")
        position, velocity = self.state
        velocity += (action - 1) * self.force + math.cos(3 * position) * (-self.gravity)
        velocity = np.clip(velocity, -self.max_speed, self.max_speed)
        position += velocity
        position = np.clip(position, self.min_position, self.max_position)
        if position == self.min_position and velocity < 0:
            velocity = 0
        terminated = bool(position >= self.goal_position and velocity >= self.goal_velocity)
        self.state = (position, velocity)
        self._elapsed += 1
        truncated = self._elapsed >= self.max_episode_steps
        return self._observe(), -1.0, terminated, truncated, {}

    def close(self) -> None:
        pass


#: env id -> the classic-control env class, each observing one vector
CLASSIC_ENVS = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    "Acrobot-v1": AcrobotEnv,
    "MountainCar-v0": MountainCarEnv,
}
