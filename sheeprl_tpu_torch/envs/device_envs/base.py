"""Environments that step on a torch device, a whole batch per call
(counterpart of ``sheeprl_tpu/envs/jax_envs/base.py``): the Anakin loops
roll out over them with no copy to the host.

A :class:`DeviceEnv` is a set of elementwise tensor functions over a batch
of envs of any leading shape: ``reset(noise, params) -> (state, obs)`` and
``step(state, action, params) -> (state, obs, reward, done, info)``. The
state is a NamedTuple of tensors with the batch's leading shape (the
TimeLimit step counter ``t`` among them, int32), ``info`` holds the
``terminated`` and ``truncated`` flags, and ``done`` is their union. Raw envs
do not reset themselves. They compute in float32, as their JAX twins do.

``params`` is the env's dynamics constants (gravity, masses, the TimeLimit
bound, ...) as a NamedTuple of 0-dim tensors (:meth:`DeviceEnv.default_params`).
Stacked to ``(P,)`` it is a population's scenario axis: the batch is then
``(P, N)``, and :class:`BatchedDeviceEnv` broadcasts member ``p``'s constants
over its ``N`` envs, so P scenarios step in one call.

A reset takes its randomness as ``noise``: unit uniforms in ``[0, 1)`` of
the batch's shape plus :attr:`DeviceEnv.reset_shape`, which the env scales to
its reset range as ``jax.random.uniform`` scales its unit draws (one
multiply-add, one rounding: :func:`uniform_between`). :class:`BatchedDeviceEnv`
draws that noise from an explicit ``torch.Generator`` on the env's device,
or takes it as an argument, so a test can feed the draws of JAX's per-env
reset keys.

:class:`BatchedDeviceEnv` adds gymnasium's same-step autoreset: on the step
that ends an episode the returned observation is the new episode's first,
and ``info["final_obs"]`` holds the terminal one. As in the JAX package, a
fresh reset is computed for every env on every step and selected where
``done``: shapes stay static and nothing reads the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DeviceEnv",
    "BatchedDeviceEnv",
    "DEVICE_ENV_REGISTRY",
    "register_device_env",
    "make_device_env",
    "is_device_env",
    "uniform_between",
    "params_batch_shape",
    "stack_params",
    "step_info",
]


def uniform_between(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``max(low, u * (high - low) + low)`` in float32 from unit uniforms
    ``u`` (``low``, ``high`` and their difference rounded to float32 first),
    the multiply-add rounded once, as XLA fuses it in ``jax.random.uniform``
    (the exact product and sum in float64). The bounds stay Python numbers:
    no tensor is copied to the device."""
    low32 = float(np.float32(low))
    scale = float(np.float32(np.float32(high) - np.float32(low)))
    return torch.clamp((u.to(torch.float64) * scale + low32).to(torch.float32), min=low32)


def params_batch_shape(params: Any) -> Tuple[int, ...]:
    """The leading (member) shape the params' fields share: ``()`` for one
    scenario, ``(P,)`` for a stacked population."""
    shapes = {tuple(getattr(params, f).shape) for f in params._fields}
    if len(shapes) != 1:
        raise ValueError(f"env params' fields disagree on their leading shape: {sorted(shapes)}")
    return shapes.pop()


def stack_params(rows: Any, device: "torch.device | str | None" = None) -> Any:
    """A ``(P,)``-stacked params NamedTuple from a sequence of single-scenario
    ones."""
    first = rows[0]
    return type(first)(*[torch.stack([getattr(r, f) for r in rows]).to(device or getattr(first, f).device)
                         for f in first._fields])


class DeviceEnv:
    """One kind of env as batched tensor functions (see the module's
    docstring). Subclasses set :attr:`id` through :func:`register_device_env`,
    :attr:`reset_shape`, :attr:`obs_dim` and the action space."""

    id: str = ""
    #: trailing shape of the unit uniforms one env's reset takes
    reset_shape: Tuple[int, ...] = ()
    #: observation width
    obs_dim: int = 0
    #: discrete: the number of actions; continuous: None
    n_actions: Optional[int] = None
    #: continuous: the action width and bounds
    action_shape: Tuple[int, ...] = ()
    action_low: Tuple[float, ...] = ()
    action_high: Tuple[float, ...] = ()

    @property
    def is_continuous(self) -> bool:
        return self.n_actions is None

    def spaces(self, obs_key: str) -> Dict[str, dict]:
        """The run config's ``spaces`` block, as the host env of the same id
        gives it (:mod:`sheeprl_tpu_torch.envs.classic`)."""
        obs = {obs_key: {"shape": [self.obs_dim], "dtype": "float32"}}
        if self.is_continuous:
            actions = {"shape": list(self.action_shape), "low": list(self.action_low),
                       "high": list(self.action_high), "continuous": True}
        else:
            actions = {"n": [int(self.n_actions)], "continuous": False}
        return {"obs": obs, "actions": actions}

    def default_params(self, device: "torch.device | str" = "cpu") -> Any:  # pragma: no cover - interface
        """The dynamics constants: float32 0-dim tensors, the TimeLimit bound
        ``max_episode_steps`` int32."""
        raise NotImplementedError

    def reset(self, noise: torch.Tensor, params: Any) -> Tuple[Any, torch.Tensor]:  # pragma: no cover - interface
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor, params: Any) -> Tuple[Any, torch.Tensor, torch.Tensor,
                                                                          torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError  # pragma: no cover - interface


def _per_env(params: Any) -> Any:
    """Member constants ``(P,)`` -> ``(P, 1)``, so they broadcast over the
    member's envs; 0-dim constants stay as they are."""
    return type(params)(*[p.unsqueeze(-1) if p.dim() else p for p in params])


def _select(done: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), new, old)


class BatchedDeviceEnv:
    """``num_envs`` envs of one kind with gymnasium's same-step autoreset.
    The batch is ``params``' leading shape plus ``(num_envs,)``."""

    def __init__(self, env: DeviceEnv, num_envs: int) -> None:
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self.env = env
        self.num_envs = int(num_envs)

    def batch_shape(self, params: Any) -> Tuple[int, ...]:
        return params_batch_shape(params) + (self.num_envs,)

    def reset_noise(self, params: Any, generator: Optional[torch.Generator] = None,
                    lead: Tuple[int, ...] = ()) -> torch.Tensor:
        """Unit uniforms for one reset of every env (``lead`` prepends, e.g.
        a rollout's steps), drawn on the params' device."""
        device = params[0].device
        shape = tuple(lead) + self.batch_shape(params) + tuple(self.env.reset_shape)
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)

    def reset(self, params: Any, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> Tuple[Any, torch.Tensor]:
        if noise is None:
            noise = self.reset_noise(params, generator)
        return self.env.reset(noise, _per_env(params))

    def step(
        self,
        state: Any,
        action: torch.Tensor,
        params: Any,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One step of every env; where an episode ended, the state and the
        observation are a fresh reset's (from ``noise``, else drawn from
        ``generator``) and ``info["final_obs"]`` holds the terminal
        observation (meaningful where ``done``)."""
        per_env = _per_env(params)
        stepped, obs, reward, done, info = self.env.step(state, action, per_env)
        if noise is None:
            noise = self.reset_noise(params, generator)
        fresh, fresh_obs = self.env.reset(noise, per_env)
        new_state = type(stepped)(*[_select(done, f, s) for f, s in zip(fresh, stepped)])
        info = dict(info)
        info["final_obs"] = obs
        return new_state, _select(done, fresh_obs, obs), reward, done, info


DEVICE_ENV_REGISTRY: Dict[str, Callable[..., DeviceEnv]] = {}


def register_device_env(env_id: str) -> Callable:
    """Class decorator: register a :class:`DeviceEnv` under its gymnasium id."""

    def decorator(cls):
        DEVICE_ENV_REGISTRY[env_id] = cls
        cls.id = env_id
        return cls

    return decorator


def is_device_env(env_id: str) -> bool:
    return env_id in DEVICE_ENV_REGISTRY


def make_device_env(env_id: str, swept_params: Tuple[str, ...] = (), **kwargs: Any) -> DeviceEnv:
    """Build a registered :class:`DeviceEnv`. ``swept_params`` names the
    params fields a population sweep (``algo.population.env_params.*``) sets
    per member: a constructor kwarg naming one of them raises, since the
    sweep would silently override it."""
    if env_id not in DEVICE_ENV_REGISTRY:
        raise ValueError(
            f"No device environment registered for '{env_id}'. Available: {sorted(DEVICE_ENV_REGISTRY)}. "
            "On-device (Anakin) training requires one; use the host-loop algorithms (e.g. algo=ppo) for "
            "other envs."
        )
    env = DEVICE_ENV_REGISTRY[env_id](**kwargs)
    if swept_params:
        fields = set(getattr(env.default_params(), "_fields", ()))
        clash = sorted(set(kwargs) & fields & set(swept_params))
        if clash:
            raise ValueError(
                f"Env constructor kwarg(s) {clash} for '{env_id}' duplicate swept env params — "
                f"algo.population.env_params.{clash[0]} already varies this field per member, so the "
                "constructor value would be silently ignored (every scenario trains on the swept value). "
                f"Drop the env kwarg or remove algo.population.env_params.{clash[0]}."
            )
    return env


def step_info(terminated: torch.Tensor, truncated: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(done, info)`` from the two flags."""
    return terminated | truncated, {"terminated": terminated, "truncated": truncated}
