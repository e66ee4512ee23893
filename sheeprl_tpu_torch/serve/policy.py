"""The contract between a per-algorithm policy builder and the serving tier
(counterpart of ``sheeprl_tpu/serve/policy.py``).

A builder turns a checkpoint into a :class:`ServePolicy` (stateless: one
action per observation row, served by
:class:`~sheeprl_tpu_torch.serve.engine.BucketEngine`) or a
:class:`StatefulServePolicy` (per-session state carried across requests,
served by :class:`~sheeprl_tpu_torch.serve.sessions.SessionEngine`): the
programs over a batch of prepared rows, the host-side observation
preparation and the rebuild hook for a weight swap. Everything downstream
(engines, scheduler, weight store) is algorithm-blind.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["ServePolicy", "StatefulServePolicy", "actions_to_host"]


def actions_to_host(actions: torch.Tensor) -> np.ndarray:
    """A dispatch's actions as a numpy array: bfloat16 ones (a ``bf16-mixed``
    policy's) widened to float32, which holds them exactly."""
    return (actions.float() if actions.dtype == torch.bfloat16 else actions).cpu().numpy()


def _validate_batch(obs_spec: Dict[str, Tuple[Tuple[int, ...], Any]], obs: Dict[str, np.ndarray]) -> int:
    """The shared leading batch size of a prepared batch; raises
    ``ValueError`` on unknown or missing keys, a per-row shape mismatch or
    inconsistent batch sizes."""
    if set(obs) != set(obs_spec):
        raise ValueError(f"observation keys {sorted(obs)} do not match the policy's spec {sorted(obs_spec)}")
    n = None
    for k, (shape, _) in obs_spec.items():
        v = obs[k]
        if v.ndim != len(shape) + 1 or tuple(v.shape[1:]) != tuple(shape):
            raise ValueError(f"observation '{k}' has per-row shape {tuple(v.shape[1:])}, expected {tuple(shape)}")
        if n is None:
            n = int(v.shape[0])
        elif int(v.shape[0]) != n:
            raise ValueError(f"inconsistent batch sizes across observation keys: {n} vs {v.shape[0]}")
    return int(n or 0)


@dataclasses.dataclass
class ServePolicy:
    """One stateless policy.

    ``greedy_fn(params, obs)`` and ``sample_fn(params, obs, draws)`` take
    ``obs``, a dict of ``(B, ...)`` tensors on ``device`` matching
    ``obs_spec``, and return env-format actions ``(B, action_dim)``
    (discrete heads: the argmax index per head; continuous: the action
    vector): the host-side conversion of the offline ``test`` loop, moved
    inside. ``sample_fn`` takes its random numbers as ``draws``, which
    ``draw_fn(seed, counter)`` builds from per-row int64 ``(B,)`` seeds and
    counters (row ``i`` of the draws depends on row ``i`` of both only), so
    a test can feed another framework's draws. Rows must be independent:
    row ``i`` of a batched call equals calling with that row alone, which is
    what makes bucket padding free.

    ``prepare`` maps raw env observations (numpy) to the prepared float
    arrays; ``params_from_state`` rebuilds ``params`` from a checkpoint
    state for a hot swap.
    """

    name: str
    params: Any
    #: key -> (per-row shape, dtype) of the PREPARED observation leaves
    obs_spec: Dict[str, Tuple[Tuple[int, ...], Any]]
    action_dim: int
    greedy_fn: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
    sample_fn: Callable[[Any, Dict[str, torch.Tensor], Any], torch.Tensor]
    draw_fn: Callable[[torch.Tensor, torch.Tensor], Any]
    prepare: Callable[[Dict[str, np.ndarray], int], Dict[str, np.ndarray]]
    params_from_state: Callable[[Any], Any]
    device: torch.device

    def validate_batch(self, obs: Dict[str, np.ndarray]) -> int:
        return _validate_batch(self.obs_spec, obs)


@dataclasses.dataclass
class StatefulServePolicy:
    """One stateful policy, stepped server-side.

    ``step_fn(params, obs, state, greedy)`` takes ``obs``, a dict of ``(B,
    ...)`` tensors on ``device`` matching ``obs_spec``, and ``state``, a dict
    of ``(B, ...)`` tensors (one row per session). It returns ``(actions,
    state')``: env-format actions ``(B, action_dim)`` and the advanced state
    with the same keys, shapes and dtypes. Rows must be independent: row
    ``i`` of a batched step equals stepping that row alone, which is what
    makes bucket padding and cross-session batching free. In-step randomness
    comes from a seed and a step counter carried in each row.

    ``init_fn(params, n)`` builds ``n`` identical fresh rows from the live
    weights. ``prepare`` maps raw env observations (numpy) to the prepared
    float arrays; ``params_from_state`` rebuilds ``params`` from a
    checkpoint state for a hot swap.
    """

    name: str
    params: Any
    #: key -> (per-row shape, dtype) of the PREPARED observation leaves
    obs_spec: Dict[str, Tuple[Tuple[int, ...], Any]]
    action_dim: int
    step_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_fn: Callable[[Any, int], Dict[str, torch.Tensor]]
    prepare: Callable[[Dict[str, np.ndarray], int], Dict[str, np.ndarray]]
    params_from_state: Callable[[Any], Any]
    device: torch.device

    def validate_batch(self, obs: Dict[str, np.ndarray]) -> int:
        return _validate_batch(self.obs_spec, obs)

    def state_spec(self, params: Any = None) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Per-row state shapes and dtypes (without the row axis), derived by
        calling ``init_fn(params, 1)``. The session cache allocates its slab
        from this, and the swap check compares against it."""
        params = self.params if params is None else params
        with torch.no_grad():
            row = self.init_fn(params, 1)
        return {k: (tuple(v.shape[1:]), v.dtype) for k, v in row.items()}
