"""Algorithm registry (counterpart of ``sheeprl_tpu/utils/registry.py``):
algorithm name -> the module that trains it (and whether that trainer is
decoupled, JAX's ``register_algorithm(decoupled=True)``), the evaluation
that tests its checkpoint, the policy builder that serves it, and the
flywheel's learner-ingest that trains it on served rows
(:mod:`sheeprl_tpu_torch.serve.flywheel`). Evaluations, builders and ingests
register when their module is imported; the lookups import the built-in
modules first."""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "TRAINERS",
    "DECOUPLED",
    "register_policy_builder",
    "resolve_policy_builder",
    "registered_policy_builder_names",
    "register_evaluation",
    "resolve_evaluation",
    "register_flywheel_ingest",
    "resolve_flywheel_ingest",
    "registered_flywheel_ingest_names",
    "algorithm_table",
]

#: algo.name -> the module whose ``main(cfg, device)`` trains it
TRAINERS: Dict[str, str] = {
    "a2c": "sheeprl_tpu_torch.algos.a2c.a2c",
    "dreamer_v1": "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "dreamer_v2": "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "dreamer_sebulba": "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba",
    "dreamer_v3": "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "droq": "sheeprl_tpu_torch.algos.droq.droq",
    "p2e_dv1_exploration": "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "p2e_dv1_finetuning": "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "p2e_dv2_exploration": "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "p2e_dv2_finetuning": "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "p2e_dv3_exploration": "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "p2e_dv3_finetuning": "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "ppo": "sheeprl_tpu_torch.algos.ppo.ppo",
    "ppo_anakin": "sheeprl_tpu_torch.algos.ppo.ppo_anakin",
    "ppo_anakin_population": "sheeprl_tpu_torch.algos.ppo.ppo_anakin_population",
    "ppo_decoupled": "sheeprl_tpu_torch.algos.ppo.ppo_decoupled",
    "ppo_recurrent": "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "ppo_sebulba": "sheeprl_tpu_torch.algos.ppo.ppo_sebulba",
    "sac": "sheeprl_tpu_torch.algos.sac.sac",
    "sac_ae": "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
    "sac_decoupled": "sheeprl_tpu_torch.algos.sac.sac_decoupled",
    "sac_sebulba": "sheeprl_tpu_torch.algos.sac.sac_sebulba",
}

#: the trainers that JAX registers ``decoupled=True``: a player or actor
#: threads beside the learner
DECOUPLED = frozenset({"ppo_decoupled", "ppo_sebulba", "sac_decoupled", "sac_sebulba", "dreamer_sebulba"})

policy_builder_registry: Dict[str, Callable] = {}
evaluation_registry: Dict[str, Callable] = {}
flywheel_ingest_registry: Dict[str, Callable] = {}

_BUILTIN_MODULES = [
    "sheeprl_tpu_torch.algos.a2c.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v1.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v2.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v3.evaluate",
    "sheeprl_tpu_torch.algos.droq.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv1.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv2.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv3.evaluate",
    "sheeprl_tpu_torch.algos.ppo.evaluate",
    "sheeprl_tpu_torch.algos.ppo_recurrent.evaluate",
    "sheeprl_tpu_torch.algos.sac.evaluate",
    "sheeprl_tpu_torch.algos.sac.flywheel",
    "sheeprl_tpu_torch.algos.sac_ae.evaluate",
]


def _register_into(registry: Dict[str, Callable], algorithms: List[str]) -> Callable[[Callable], Callable]:
    def decorator(fn: Callable) -> Callable:
        for name in algorithms:
            registry[name] = fn
        return fn

    return decorator


def register_policy_builder(algorithms: List[str]) -> Callable[[Callable], Callable]:
    """Register ``fn(cfg, state, device) -> ServePolicy | StatefulServePolicy``
    as the serving policy builder of ``algorithms``."""
    return _register_into(policy_builder_registry, algorithms)


def register_evaluation(algorithms: List[str]) -> Callable[[Callable], Callable]:
    """Register ``fn(cfg, state, device) -> {"reward", "steps"}`` as the
    evaluation of ``algorithms``' checkpoints."""
    return _register_into(evaluation_registry, algorithms)


def register_flywheel_ingest(algorithms: List[str]) -> Callable[[Callable], Callable]:
    """Register ``fn(cfg, agent_state, device)`` as the flywheel
    learner-ingest of ``algorithms``: an object with ``row_width``,
    ``ingest(rows)``, ``consumed`` (rows trained into its replay),
    ``grad_steps`` and ``agent_state()`` (what ``serve``'s builder rebuilds
    from)."""
    return _register_into(flywheel_ingest_registry, algorithms)


def _import_builtins() -> None:
    for module in _BUILTIN_MODULES:
        importlib.import_module(module)


def resolve_policy_builder(name: str) -> Optional[Callable]:
    _import_builtins()
    return policy_builder_registry.get(name)


def registered_policy_builder_names() -> List[str]:
    _import_builtins()
    return sorted(policy_builder_registry)


def resolve_evaluation(name: str) -> Optional[Callable]:
    _import_builtins()
    return evaluation_registry.get(name)


def resolve_flywheel_ingest(name: str) -> Optional[Callable]:
    _import_builtins()
    return flywheel_ingest_registry.get(name)


def registered_flywheel_ingest_names() -> List[str]:
    _import_builtins()
    return sorted(flywheel_ingest_registry)


def algorithm_table() -> List[Dict[str, Any]]:
    """One row per algorithm the port knows: its name, its trainer module
    (None if it only evaluates or serves), whether an evaluation and a
    serving policy builder are registered for it, and whether its trainer is
    decoupled (JAX's flag)."""
    _import_builtins()
    names = sorted(set(TRAINERS) | set(evaluation_registry) | set(policy_builder_registry))
    return [
        {
            "name": name,
            "trainer": TRAINERS.get(name),
            "evaluation": name in evaluation_registry,
            "serving": name in policy_builder_registry,
            "decoupled": name in DECOUPLED,
        }
        for name in names
    ]
