"""A plain synchronous vector over ``num_envs`` envs, with the conventions
the JAX package's coupled loops rely on (gymnasium's ``SAME_STEP``
autoreset): an env that ends is reset in the same ``step``, its returned
observation is the reset one, and ``infos["final_obs"][i]`` holds the last
observation of the episode that ended (None elsewhere). An episode that
reaches ``max_episode_steps`` ends truncated, as ``TimeLimit`` does.

With ``restart_attempts > 0`` or a ``step_timeout`` (``env.restart_attempts``,
``env.restart_backoff``, ``env.step_timeout``), each env is wrapped in a
:class:`~sheeprl_tpu_torch.fault.watchdog.SelfHealingEnv` holding its
factory: a crash or hang rebuilds the env with bounded retries and
exponential backoff and comes back as a truncation; ``env_restarts`` counts
the rebuilds (the run summary's ``Fault/env_restarts``). With
``restart_on_exception`` (the Dreamer V3 family's loops, as in JAX) each env
is a :class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException` first: a
step it recovered shows in ``infos["restart_on_exception"]`` (one bool per
env) and starts the env's episode counters again."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs.classic import CLASSIC_ENVS
from sheeprl_tpu_torch.envs.dummy import COUNTER_ENVS, AtariProtocolDummyEnv
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FrameStack,
    MaskVelocityWrapper,
    RestartOnException,
    RewardAsObservationWrapper,
)

__all__ = ["SyncVectorEnv", "make_env", "make_vector_env"]


class SyncVectorEnv:
    def __init__(self, env_fns: Sequence[Callable[[], Any]], max_episode_steps: Optional[int] = None,
                 restart_attempts: int = 0, restart_backoff: float = 0.5,
                 step_timeout: Optional[float] = None) -> None:
        self._restart_counter = [0]
        if restart_attempts > 0 or (step_timeout and step_timeout > 0):
            from sheeprl_tpu_torch.fault.watchdog import SelfHealingEnv

            env_fns = [
                lambda fn=fn: SelfHealingEnv(fn, attempts=max(1, int(restart_attempts)), backoff=restart_backoff,
                                             step_timeout=step_timeout, restart_counter=self._restart_counter)
                for fn in env_fns
            ]
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.max_episode_steps = int(max_episode_steps) if max_episode_steps else None
        self._elapsed = np.zeros(self.num_envs, dtype=np.int64)
        self._returns = np.zeros(self.num_envs, dtype=np.float64)

    @property
    def env_restarts(self) -> int:
        """Envs rebuilt by their watchdogs so far."""
        return self._restart_counter[0]

    @property
    def spaces(self) -> Dict[str, dict]:
        return self.envs[0].spaces

    @staticmethod
    def _stack(obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([o[k] for o in obs]) for k in obs[0]}

    def reset(self, seed: Optional[int] = None):
        """Env ``i`` is reset with ``seed + i``, as gymnasium's vector envs do."""
        self._elapsed[:] = 0
        self._returns[:] = 0
        obs = [env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]
        return self._stack(obs), {}

    def step(self, actions: np.ndarray):
        obs, rewards, terminated, truncated = [], [], [], []
        final_obs: List[Optional[Dict[str, np.ndarray]]] = [None] * self.num_envs
        episodes = []
        restarted = np.zeros(self.num_envs, dtype=bool)
        for i, (env, action) in enumerate(zip(self.envs, np.asarray(actions).reshape(self.num_envs, -1))):
            o, r, term, trunc, info = env.step(action[0] if action.size == 1 else action)
            if info.get("restart_on_exception", False):
                restarted[i] = True  # a fresh env on its reset observation: a new episode
                self._elapsed[i] = 0
                self._returns[i] = 0
            self._elapsed[i] += 1
            self._returns[i] += r
            if self.max_episode_steps is not None and self._elapsed[i] >= self.max_episode_steps:
                trunc = True
            if term or trunc:
                final_obs[i] = o
                episodes.append((i, float(self._returns[i]), int(self._elapsed[i])))
                o, _ = env.reset()
                self._elapsed[i] = 0
                self._returns[i] = 0
            obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        infos: Dict[str, Any] = {}
        if episodes:
            infos["final_obs"] = final_obs
            infos["episodes"] = episodes
        if restarted.any():
            infos["restart_on_exception"] = restarted
        return (
            self._stack(obs),
            np.asarray(rewards, dtype=np.float64),
            np.asarray(terminated, dtype=bool),
            np.asarray(truncated, dtype=bool),
            infos,
        )

    def close(self) -> None:
        for env in self.envs:
            env.close()


def _base_env(cfg: Any, seed: int) -> Any:
    """The env ``cfg.env.id`` names, before any wrapper."""
    env_cfg = cfg.env
    if env_cfg.id == "atari_protocol_dummy":
        wrapper = env_cfg.get("wrapper") or {}
        return AtariProtocolDummyEnv(
            screen_size=int(env_cfg.screen_size),
            frame_skip=int(env_cfg.action_repeat),
            grayscale=bool(env_cfg.get("grayscale", False)),
            noop_max=int(wrapper.get("noop_max", 30)),
            seed=seed,
        )
    if env_cfg.id in COUNTER_ENVS:
        return COUNTER_ENVS[env_cfg.id](screen_size=int(env_cfg.screen_size))
    if env_cfg.id in CLASSIC_ENVS:
        mlp_keys = list(cfg.algo.mlp_keys.encoder)
        if not mlp_keys or list(cfg.algo.cnn_keys.encoder):
            raise ValueError(
                f"{env_cfg.id} gives one vector observation: set algo.mlp_keys.encoder=[state] and no cnn keys"
            )
        return CLASSIC_ENVS[env_cfg.id](obs_key=mlp_keys[0], seed=seed)
    raise NotImplementedError(
        f"env '{env_cfg.id}' is not ported yet; atari_protocol_dummy, {', '.join(COUNTER_ENVS)}, "
        f"{', '.join(CLASSIC_ENVS)} only"
    )


def make_env(cfg: Any, seed: int) -> Any:
    """One env of the kind ``cfg.env.id`` names, seeded with ``seed``: the
    Atari-protocol dummy, a step-counter dummy (``continuous_dummy``,
    ``discrete_dummy``, ``multidiscrete_dummy``: keys ``rgb`` and
    ``state``), or CartPole-v1, Pendulum-v1, Acrobot-v1 or MountainCar-v0
    with its observation under the first MLP encoder key.

    The JAX factory's wrappers follow in its order (``env.*`` keys, their
    defaults in brackets): :class:`ActionRepeat` by ``action_repeat`` [1],
    unless the env skips frames itself (the Atari-protocol dummy's
    ``frame_skip``); :class:`MaskVelocityWrapper` with ``mask_velocities``
    [false]; :class:`FrameStack` of the pixel keys with ``frame_stack`` [1]
    > 1, every ``frame_stack_dilation`` [1] frames;
    :class:`ActionsAsObservationWrapper` with
    ``actions_as_observation.num_stack`` [-1] > 0;
    :class:`RewardAsObservationWrapper` with ``reward_as_observation``
    [false]. The vector env applies ``max_episode_steps``. The port's envs
    give their frames at ``screen_size`` and record no video:
    ``capture_video`` raises, and ``grayscale`` raises on every env but the
    Atari-protocol dummy, whose frames it turns gray."""
    env_cfg = cfg.env
    if env_cfg.get("capture_video", False):
        raise ValueError("env.capture_video=true: the port records no video (it has no gymnasium RecordVideo)")
    if env_cfg.get("grayscale", False) and env_cfg.id != "atari_protocol_dummy":
        raise NotImplementedError(f"env.grayscale=true: {env_cfg.id} gives RGB frames only in the port")
    env = _base_env(cfg, seed)
    cnn_enc = list(cfg.algo.cnn_keys.encoder or [])
    mlp_enc = list(cfg.algo.mlp_keys.encoder or [])

    action_repeat = int(env_cfg.get("action_repeat", 1) or 1)
    if action_repeat > 1 and int(getattr(env, "frame_skip", 1) or 1) <= 1:
        env = ActionRepeat(env, action_repeat)
    if env_cfg.get("mask_velocities", False):
        env = MaskVelocityWrapper(env, env_cfg.id, mlp_enc[0] if env_cfg.id in CLASSIC_ENVS else None)
    if not cnn_enc + mlp_enc:
        raise ValueError(
            "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be non-empty lists of strings, got: "
            f"cnn={cnn_enc} mlp={mlp_enc}"
        )
    obs_spec = env.spaces["obs"]
    if not set(obs_spec) & set(cnn_enc + mlp_enc):
        raise ValueError(
            f"The user specified keys `{mlp_enc + cnn_enc}` are not a subset of the environment "
            f"`{list(obs_spec)}` observation keys."
        )
    cnn_keys = sorted(k for k in obs_spec if len(obs_spec[k]["shape"]) in (2, 3) and k in cnn_enc)
    frame_stack = int(env_cfg.get("frame_stack", 1) or 1)
    if cnn_keys and frame_stack > 1:
        dilation = int(env_cfg.get("frame_stack_dilation", 1))
        if dilation <= 0:
            raise ValueError(f"The frame stack dilation argument must be greater than zero, got: {dilation}")
        env = FrameStack(env, frame_stack, cnn_keys, dilation)
    actions_obs = env_cfg.get("actions_as_observation") or {}
    if int(actions_obs.get("num_stack", -1)) > 0:
        env = ActionsAsObservationWrapper(env, **actions_obs)
    if env_cfg.get("reward_as_observation", False):
        env = RewardAsObservationWrapper(env)
    return env


def make_vector_env(cfg: Any, seed: int, restart_on_exception: bool = False, rank: int = 0) -> SyncVectorEnv:
    """``cfg.env.num_envs`` copies of the env ``cfg.env.id`` names; env ``i``
    of rank ``rank`` is built with ``seed + rank * num_envs + i`` (JAX
    ``vectorize_env``), wrapped in :class:`RestartOnException` with
    ``restart_on_exception``, self-healing as ``env.restart_attempts`` and
    ``env.step_timeout`` ask."""
    n = int(cfg.env.num_envs)
    envs = [lambda i=i: make_env(cfg, seed + rank * n + i) for i in range(n)]
    if restart_on_exception:
        envs = [lambda fn=fn: RestartOnException(fn) for fn in envs]
    return SyncVectorEnv(
        envs, cfg.env.get("max_episode_steps"), restart_attempts=int(cfg.env.get("restart_attempts", 0) or 0),
        restart_backoff=float(cfg.env.get("restart_backoff", 0.5)), step_timeout=cfg.env.get("step_timeout"),
    )
