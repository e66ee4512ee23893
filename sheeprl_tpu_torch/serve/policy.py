"""The contract between a per-algorithm stateful policy builder and the
serving tier (counterpart of ``sheeprl_tpu/serve/policy.py``,
``StatefulServePolicy``).

A builder turns a checkpoint into a :class:`StatefulServePolicy`: a step over
a batch of per-session state rows, the rows' initial state, the host-side
observation preparation and the rebuild hook for a weight swap. Everything
downstream (session cache, engine, scheduler, weight store) is
algorithm-blind.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["StatefulServePolicy"]


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

    params: Any
    #: key -> (per-row shape, dtype) of the PREPARED observation leaves
    obs_spec: Dict[str, Tuple[Tuple[int, ...], Any]]
    step_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_fn: Callable[[Any, int], Dict[str, torch.Tensor]]
    prepare: Callable[[Dict[str, np.ndarray], int], Dict[str, np.ndarray]]
    params_from_state: Callable[[Any], Any]
    device: torch.device

    def validate_batch(self, obs: Dict[str, np.ndarray]) -> int:
        """The shared leading batch size of a prepared batch; raises
        ``ValueError`` on unknown or missing keys, a per-row shape mismatch or
        inconsistent batch sizes."""
        if set(obs) != set(self.obs_spec):
            raise ValueError(f"observation keys {sorted(obs)} do not match the policy's spec {sorted(self.obs_spec)}")
        n = None
        for k, (shape, _) in self.obs_spec.items():
            v = obs[k]
            if v.ndim != len(shape) + 1 or tuple(v.shape[1:]) != tuple(shape):
                raise ValueError(f"observation '{k}' has per-row shape {tuple(v.shape[1:])}, expected {tuple(shape)}")
            if n is None:
                n = int(v.shape[0])
            elif int(v.shape[0]) != n:
                raise ValueError(f"inconsistent batch sizes across observation keys: {n} vs {v.shape[0]}")
        return int(n or 0)

    def state_spec(self, params: Any = None) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Per-row state shapes and dtypes (without the row axis), derived by
        calling ``init_fn(params, 1)``. The session cache allocates its slab
        from this, and the swap check compares against it."""
        params = self.params if params is None else params
        with torch.no_grad():
            row = self.init_fn(params, 1)
        return {k: (tuple(v.shape[1:]), v.dtype) for k, v in row.items()}
