"""``fabric.precision`` as a dtype policy (counterpart of ``Precision`` in
``sheeprl_tpu/parallel/fabric.py``).

The Lightning-style strings map to a parameter dtype and a compute dtype.
Every family's ``build_agent`` reads the compute dtype and sets it on each of its
layers (:func:`sheeprl_tpu_torch.models.blocks.set_compute_dtype`), as the
JAX package hands ``dtype=fabric.precision.compute_dtype`` to its flax
modules. No ``build_agent`` of either package passes the parameter dtype on, so
parameters, gradients, optimizer state and checkpoints are float32 under
every alias; ``param_dtype`` is kept for the table's sake. There is no
float16 and no loss scaling: ``16-mixed`` and ``16-true`` are bfloat16, as
in the JAX package.

:func:`partition` is ``Fabric.partition``'s rule for the Sebulba topologies
on the port's one device.

:func:`setup` is the rest of ``Fabric.from_config`` that the port has: the
``fabric.devices`` rule (one device per process: more devices are more
processes, ``run --pod N``) and the gradient wire dtype, applied once at the
start of a run. The rank accessors read the ``torch.distributed`` group
(:mod:`~sheeprl_tpu_torch.parallel.distributed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from sheeprl_tpu_torch.parallel import distributed
from sheeprl_tpu_torch.parallel.comm import get_grad_reduce_dtype, parse_grad_reduce_dtype, set_grad_reduce_dtype

__all__ = [
    "PRECISION_ALIASES", "Precision", "compute_dtype", "partition", "resolve_devices", "visible_devices", "setup",
    "world_size", "global_rank", "is_global_zero", "rank_seed",
]

#: alias -> (parameter dtype, compute dtype), the JAX package's table
PRECISION_ALIASES = {
    "32-true": ("float32", "float32"),
    "32": ("float32", "float32"),
    "bf16-mixed": ("float32", "bfloat16"),
    "bf16-true": ("bfloat16", "bfloat16"),
    "16-mixed": ("float32", "bfloat16"),
    "16-true": ("bfloat16", "bfloat16"),
}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Parameter and compute dtypes of one ``fabric.precision`` string.

    ``param_dtype`` is the JAX table's value and is not applied: no agent
    builder reads it, and parameters stay float32 under every alias (a
    ``bf16-true`` run too). ``compute_dtype`` is what the builders set."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    @classmethod
    def from_string(cls, spec: str) -> "Precision":
        if spec not in PRECISION_ALIASES:
            raise ValueError(f"Unknown precision '{spec}'. Known: {sorted(PRECISION_ALIASES)}")
        p, c = PRECISION_ALIASES[spec]
        return cls(param_dtype=getattr(torch, p), compute_dtype=getattr(torch, c))

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "Precision":
        """The policy of a run config's ``fabric.precision`` (``32-true``
        when unset)."""
        return cls.from_string(str((cfg.get("fabric") or {}).get("precision", "32-true")))


def compute_dtype(cfg: Mapping[str, Any]) -> torch.dtype:
    """The compute dtype a run config's ``fabric.precision`` asks for."""
    return Precision.from_config(cfg).compute_dtype


def partition(device: "torch.device | str", actor_devices: "int | str" = "auto") -> Tuple[torch.device, torch.device]:
    """``(actor_device, learner_device)`` for a Sebulba pipeline by the JAX
    ``Fabric.partition`` rule on the port's one device: ``"auto"`` and 0
    time-slice, the actors sharing the learner's device (the overlap is
    between the host's env steps and the card, and between CUDA streams);
    an ``actor_devices`` that leaves no learner device raises JAX's
    ``ValueError``. The port builds no sub-fabric."""
    if isinstance(actor_devices, str):
        if actor_devices.lower() != "auto":
            raise ValueError(f"actor_devices must be an int or 'auto', got {actor_devices!r}")
        n_act = 0
    else:
        n_act = int(actor_devices)
    if n_act != 0:
        raise ValueError(
            f"actor_devices ({n_act}) must leave at least one learner device "
            "(fabric has 1); use 0 (or 'auto' on one chip) to time-slice."
        )
    device = torch.device(device)
    return device, device


def visible_devices(accelerator: Optional[str]) -> int:
    """Devices a process of this accelerator sees: the CPU is one, a CUDA
    accelerator every card ``torch.cuda.device_count`` counts (no context is
    made)."""
    return 1 if str(accelerator or "cuda").lower() == "cpu" else torch.cuda.device_count()


def resolve_devices(devices: Any, visible: int) -> int:
    """``fabric.devices`` as JAX's ``Fabric`` resolves it: ``auto``, null and
    -1 are every visible device, a count above the visible ones raises JAX's
    ``ValueError``. A count above 1 raises ``NotImplementedError``: the port
    drives one device per process."""
    if devices in ("auto", None, -1):
        n = visible
    else:
        n = int(devices)
        if n > visible:
            raise ValueError(f"Requested {n} devices but only {visible} are visible")
    if n > 1:
        raise NotImplementedError(
            f"fabric.devices resolves to {n}: the port drives one device per process; train over {n} devices as a "
            f"pod of {n} worker processes, one device each, with `run --pod {n}` (or fabric.pod.workers={n})"
        )
    return n


def setup(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """Apply a run config's ``fabric`` block at the start of a run, after
    the process group is joined: check ``fabric.devices``
    (:func:`resolve_devices`) and set the gradient wire dtype once
    (``fresh_run=True``); ``auto`` is bfloat16 when the group spans more than
    one process and float32 otherwise, where the reduction is no collective
    and a cast would round the gradients for nothing. Returns the resolved
    ``devices``, ``world_size``, ``rank`` and ``grad_reduce_dtype``."""
    fabric = cfg.get("fabric") or {}
    devices = resolve_devices(fabric.get("devices", 1), visible_devices(fabric.get("accelerator")))
    world = distributed.world_size()
    wire = fabric.get("grad_reduce_dtype", "auto")
    if parse_grad_reduce_dtype(wire) == "auto":
        wire = "bfloat16" if world > 1 else "float32"
    set_grad_reduce_dtype(wire, fresh_run=True)
    return {"devices": devices, "world_size": world, "rank": distributed.rank(),
            "grad_reduce_dtype": "float32" if get_grad_reduce_dtype() is None else "bfloat16"}


#: the group's size and this process's rank (1 and 0 outside a pod), one device a process
world_size = distributed.world_size
global_rank = distributed.rank


def is_global_zero() -> bool:
    """Rank 0: the process that logs, saves the config and checkpoints."""
    return distributed.rank() == 0


def rank_seed(seed: int, rank: int, iteration: int) -> int:
    """A 63-bit seed of rank ``rank``'s own draws from ``iteration`` on: a
    function of the three numbers alone, so a rank resumed at an iteration
    draws what a rank started there would (the off-policy and Dreamer loops
    re-seed their generators with it at a run's start above one process,
    JAX's ``fold_in(key, axis_index("dp"))``)."""
    return int(np.random.SeedSequence([int(seed), int(rank), int(iteration)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
