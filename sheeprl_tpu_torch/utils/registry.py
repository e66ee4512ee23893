"""Policy-builder registry (counterpart of ``sheeprl_tpu/utils/registry.py``,
serving part): algorithm name -> the stateful policy builder that serves it.
Registration happens when the builder's module is imported; the CLI imports
the built-in modules on first lookup."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional

__all__ = ["register_policy_builder", "resolve_policy_builder", "registered_policy_builder_names"]

policy_builder_registry: Dict[str, Callable] = {}

_BUILTIN_MODULES = ["sheeprl_tpu_torch.algos.dreamer_v3.evaluate"]


def register_policy_builder(algorithms: List[str]) -> Callable[[Callable], Callable]:
    def decorator(fn: Callable) -> Callable:
        for name in algorithms:
            policy_builder_registry[name] = fn
        return fn

    return decorator


def _import_builtins() -> None:
    for module in _BUILTIN_MODULES:
        importlib.import_module(module)


def resolve_policy_builder(name: str) -> Optional[Callable]:
    _import_builtins()
    return policy_builder_registry.get(name)


def registered_policy_builder_names() -> List[str]:
    _import_builtins()
    return sorted(policy_builder_registry)
