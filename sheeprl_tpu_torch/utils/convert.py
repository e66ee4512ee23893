"""Carry weights across from the JAX package: flax parameter trees, held as
numpy arrays, to the port's ``state_dict``s.

The port's modules keep the flax submodule names, so a leaf's path is its
``state_dict`` key once the ``params`` collection level is dropped. Leaves
change by name:

- Dense ``kernel`` ``(in, out)`` -> Linear ``weight`` ``(out, in)``;
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``; ``bias`` stays ``bias``;
- ``initial_recurrent_state`` is copied as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "dreamer_v3_state_from_jax"]

#: world-model subtrees that serving runs; the decoders and the reward and
#: continue heads belong to training
_DREAMER_WM_SERVING = ("encoder", "recurrent_model", "representation_model", "transition_model")


def _leaf(name: str, value: Any) -> "tuple[str, torch.Tensor]":
    a = np.asarray(value)
    if name == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {a.ndim} has no torch layout here")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return name, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten one flax variable tree (with or without its ``params``
    level) into ``state_dict`` entries under ``prefix``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{key}."))
        else:
            name, tensor = _leaf(key, value)
            out[f"{prefix}{name}"] = tensor
    return out


def dreamer_v3_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor", ...}`` as the JAX ``build_agent`` returns
    them (numpy trees) -> the port's checkpoint state ``{"world_model":
    state_dict, "actor": state_dict}``."""
    wm = params["world_model"]
    world_model: Dict[str, torch.Tensor] = {}
    for name in _DREAMER_WM_SERVING:
        world_model.update(flax_to_state_dict(wm[name], f"{name}."))
    world_model["initial_recurrent_state"] = torch.from_numpy(np.array(wm["initial_recurrent_state"], dtype=np.float32))
    return {"world_model": world_model, "actor": flax_to_state_dict(params["actor"])}
