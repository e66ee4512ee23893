"""Env wrappers (counterpart of ``sheeprl_tpu/envs/wrappers.py``) over the
port's plain-spec envs: an env's ``spaces`` is the run config's ``spaces``
block (``{"obs": {key: {"shape", "dtype"}}, "actions": {...}}``), not a
gymnasium space, so each wrapper rewrites that block where it changes an
observation.

- :class:`DilatedDeque`, a bounded history that yields every
  ``dilation``-th entry, behind both frame and action stacking;
- :func:`encode_action`, the flat float32 encoding of an action (identity
  for a Box, one-hot for one discrete head, the one-hots concatenated for
  several);
- :class:`ActionRepeat`, :class:`MaskVelocityWrapper`, :class:`FrameStack`,
  :class:`RewardAsObservationWrapper`, :class:`ActionsAsObservationWrapper`,
  with the JAX wrappers' semantics and checks;
- :class:`RestartOnException`, which rebuilds a crashed env in place and
  says so in the step's ``info``, for the Dreamer loops' buffer patch.

Frames are channel-last, so ``FrameStack`` gives ``(H, W, C * num_stack)``.
The JAX ``FrameStack`` re-primes its history on DIAMBRA's round and stage
flags; no env of the port emits them, so the port's has no such flush."""

from __future__ import annotations

import copy
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Sequence, Tuple, Type, Union

import numpy as np

__all__ = [
    "Wrapper",
    "DilatedDeque",
    "encode_action",
    "VELOCITY_SLOTS",
    "MaskVelocityWrapper",
    "ActionRepeat",
    "FrameStack",
    "RewardAsObservationWrapper",
    "ActionsAsObservationWrapper",
    "RestartOnException",
]


class Wrapper:
    """Forwards ``step``, ``reset``, ``close``, ``spaces`` and every other
    attribute to the wrapped env."""

    def __init__(self, env: Any) -> None:
        self.env = env

    def __getattr__(self, name: str) -> Any:
        if name == "env":  # not set yet: no recursion through __getattr__
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def spaces(self) -> Dict[str, dict]:
        return self.env.spaces

    def step(self, action):
        return self.env.step(action)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def close(self) -> None:
        self.env.close()


class DilatedDeque:
    """Fixed-capacity history of ``size * dilation`` entries whose snapshot is
    every ``dilation``-th element (oldest to newest), concatenated on the
    last axis. ``fill`` primes the whole history with one value."""

    def __init__(self, size: int, dilation: int = 1):
        if size < 1:
            raise ValueError(f"history size must be >= 1, got {size}")
        if dilation < 1:
            raise ValueError(f"dilation must be >= 1, got {dilation}")
        self.size = size
        self.dilation = dilation
        self._buf: deque = deque(maxlen=size * dilation)

    def push(self, item: np.ndarray) -> None:
        self._buf.append(item)

    def fill(self, item: np.ndarray) -> None:
        self._buf.clear()
        self._buf.extend([item] * self._buf.maxlen)

    def pad_with_last(self) -> None:
        """Re-prime the history with its newest entry."""
        self.fill(self._buf[-1])

    def snapshot(self) -> np.ndarray:
        picked = [self._buf[i] for i in range(self.dilation - 1, len(self._buf), self.dilation)]
        if len(picked) != self.size:
            raise RuntimeError(f"history holds {len(picked)} strided entries, expected {self.size}")
        return np.concatenate(picked, axis=-1)


def _is_box(actions: Dict[str, Any]) -> bool:
    return bool(actions.get("continuous", False))


def encode_action(action: Any, actions: Dict[str, Any]) -> np.ndarray:
    """Flat float32 encoding of an action under the action spec ``actions``:
    identity for a Box, one-hot for one discrete head, the heads' one-hots
    concatenated for several (a MultiDiscrete)."""
    if _is_box(actions):
        return np.asarray(action, dtype=np.float32).reshape(-1)
    sizes = [int(n) for n in actions["n"]]
    parts = []
    for a, n in zip(np.asarray(action).reshape(-1), sizes):
        part = np.zeros(n, dtype=np.float32)
        part[int(a)] = 1.0
        parts.append(part)
    return np.concatenate(parts)


#: the velocity entries of the classic-control state vectors, by env id
VELOCITY_SLOTS: Dict[str, Tuple[int, ...]] = {
    "CartPole-v0": (1, 3),
    "CartPole-v1": (1, 3),
    "MountainCar-v0": (1,),
    "MountainCarContinuous-v0": (1,),
    "Pendulum-v1": (2,),
    "LunarLander-v2": (2, 3, 5),
    "LunarLanderContinuous-v2": (2, 3, 5),
    "LunarLander-v3": (2, 3, 5),
}


class MaskVelocityWrapper(Wrapper):
    """Zero the velocity entries of a classic-control env's vector
    observation (under ``key``), making the MDP partially observable. An env
    id outside :data:`VELOCITY_SLOTS` raises, as in the JAX package."""

    def __init__(self, env: Any, env_id: str, key: str) -> None:
        super().__init__(env)
        if env_id not in VELOCITY_SLOTS:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self._key = key
        self.mask = np.ones(tuple(env.spaces["obs"][key]["shape"]), dtype=np.float32)
        self.mask[list(VELOCITY_SLOTS[env_id])] = 0.0

    def _mask(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        obs = dict(obs)
        obs[self._key] = obs[self._key] * self.mask
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._mask(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._mask(obs), info


class ActionRepeat(Wrapper):
    """Apply each action ``amount`` times, summing the rewards and stopping
    early when the episode ends."""

    def __init__(self, env: Any, amount: int = 1) -> None:
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = int(amount)

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        total = 0.0 + reward
        for _ in range(self._amount - 1):
            if done or truncated:
                break
            obs, reward, done, truncated, info = self.env.step(action)
            total += reward
        return obs, total, done, truncated, info


class FrameStack(Wrapper):
    """Stack the last ``num_stack`` (``dilation``-strided) frames of each
    pixel key in ``cnn_keys`` on the channel axis: ``(H, W, C * num_stack)``."""

    def __init__(self, env: Any, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1) -> None:
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack, expected a value greater than zero, got {num_stack}")
        obs_spec = env.spaces["obs"]
        stackable = [k for k, v in obs_spec.items() if k in (cnn_keys or ()) and len(v["shape"]) == 3]
        if not stackable:
            raise RuntimeError("Specify at least one valid cnn key to be stacked")
        self._histories = {k: DilatedDeque(num_stack, dilation) for k in stackable}
        self._spaces = copy.deepcopy(env.spaces)
        for k in stackable:
            *hw, c = obs_spec[k]["shape"]
            self._spaces["obs"][k]["shape"] = [*hw, c * num_stack]

    @property
    def spaces(self) -> Dict[str, dict]:
        return self._spaces

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        obs = dict(obs)
        for k, hist in self._histories.items():
            hist.push(obs[k])
            obs[k] = hist.snapshot()
        return obs, reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        obs = dict(obs)
        for k, hist in self._histories.items():
            hist.fill(obs[k])
            obs[k] = hist.snapshot()
        return obs, info


class RewardAsObservationWrapper(Wrapper):
    """Feed the last reward back as a ``reward`` observation ``(1,)`` float32
    (0 at a reset)."""

    def __init__(self, env: Any) -> None:
        super().__init__(env)
        self._spaces = copy.deepcopy(env.spaces)
        self._spaces["obs"] = {"reward": {"shape": [1], "dtype": "float32"}, **self._spaces["obs"]}

    @property
    def spaces(self) -> Dict[str, dict]:
        return self._spaces

    @staticmethod
    def _attach(obs: Dict[str, Any], reward: Any) -> Dict[str, Any]:
        obs = dict(obs)
        obs["reward"] = np.asarray(reward, dtype=np.float32).reshape(-1)
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._attach(obs, reward), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._attach(obs, 0.0), info


class ActionsAsObservationWrapper(Wrapper):
    """Expose the last ``num_stack`` (``dilation``-strided) actions, encoded
    by :func:`encode_action`, as a flat ``action_stack`` observation; a reset
    fills the history with the encoded ``noop``."""

    def __init__(self, env: Any, num_stack: int, noop: Union[float, int, List[int]], dilation: int = 1) -> None:
        super().__init__(env)
        if num_stack < 1:
            raise ValueError(
                "The number of actions to the `action_stack` observation must be greater or equal than 1, "
                f"got: {num_stack}"
            )
        if dilation < 1:
            raise ValueError(f"The actions stack dilation argument must be greater than zero, got: {dilation}")
        if not isinstance(noop, (int, float, list)):
            raise ValueError(f"The noop action must be an integer or float or list, got: {noop} ({type(noop)})")
        actions = env.spaces["actions"]
        self._validate_noop(noop, actions)
        if _is_box(actions):
            self._noop_vec = np.full((int(np.prod(actions["shape"])),), noop, dtype=np.float32)
        else:
            self._noop_vec = encode_action(noop, actions)
        self._actions = actions
        self._history = DilatedDeque(num_stack, dilation)
        self._spaces = copy.deepcopy(env.spaces)
        self._spaces["obs"]["action_stack"] = {"shape": [self._noop_vec.shape[0] * num_stack], "dtype": "float32"}

    @property
    def spaces(self) -> Dict[str, dict]:
        return self._spaces

    @staticmethod
    def _validate_noop(noop: Any, actions: Dict[str, Any]) -> None:
        if _is_box(actions):
            if isinstance(noop, list):
                raise ValueError(f"The noop actions must be a float for continuous action spaces, got: {noop}")
            return
        sizes = list(actions["n"])
        if len(sizes) > 1:
            if not isinstance(noop, list):
                raise ValueError(f"The noop actions must be a list for multi-discrete action spaces, got: {noop}")
            if len(sizes) != len(noop):
                raise RuntimeError(
                    "The number of noop actions must equal the number of actions of the environment. "
                    f"Got env_action_space = {sizes} and noop = {noop}"
                )
        elif isinstance(noop, (list, float)):
            raise ValueError(f"The noop actions must be an integer for discrete action spaces, got: {noop}")

    def step(self, action):
        self._history.push(encode_action(action, self._actions))
        obs, reward, done, truncated, info = self.env.step(action)
        obs = dict(obs)
        obs["action_stack"] = self._history.snapshot()
        return obs, reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self._history.fill(self._noop_vec)
        obs = dict(obs)
        obs["action_stack"] = self._history.snapshot()
        return obs, info


class RestartOnException(Wrapper):
    """Rebuilds the env from ``env_fn`` when one of ``exceptions`` escapes
    its ``step`` or ``reset`` (the JAX wrapper's semantics): a failed step
    comes back as the fresh env's reset observation with reward 0, neither
    terminated nor truncated, and ``info["restart_on_exception"] = True``; a
    failed reset as the fresh env's reset with the same flag. More than
    ``maxfails`` failures inside one ``window`` of seconds raise. Each
    rebuild waits ``wait`` seconds first (the JAX default 20; tests pass 0).
    The Dreamer loops turn the flag into a truncation of the env's last
    stored row."""

    def __init__(self, env_fn: Callable[[], Any],
                 exceptions: Union[Type[BaseException], Sequence[Type[BaseException]]] = (Exception,),
                 window: float = 300.0, maxfails: int = 2, wait: float = 20.0) -> None:
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions) if isinstance(exceptions, (tuple, list)) else (exceptions,)
        self._window = float(window)
        self._maxfails = int(maxfails)
        self._wait = float(wait)
        self._window_start = time.time()
        self._fail_count = 0
        super().__init__(env_fn())

    def _recover(self, exc: BaseException, phase: str) -> None:
        now = time.time()
        if now - self._window_start > self._window:
            self._window_start = now
            self._fail_count = 0
        self._fail_count += 1
        if self._fail_count > self._maxfails:
            raise RuntimeError(f"The env crashed too many times: {self._fail_count}") from exc
        warnings.warn(f"{phase} - Restarting env after crash with {type(exc).__name__}: {exc}")
        time.sleep(self._wait)
        self.env = self._env_fn()

    def step(self, action):
        try:
            return self.env.step(action)
        except self._exceptions as exc:
            self._recover(exc, "STEP")
            obs, info = self.env.reset()
            return obs, 0.0, False, False, {**info, "restart_on_exception": True}

    def reset(self, seed=None, options=None):
        try:
            return self.env.reset(seed=seed, options=options)
        except self._exceptions as exc:
            self._recover(exc, "RESET")
            obs, info = self.env.reset(seed=seed, options=options)
            return obs, {**info, "restart_on_exception": True}
