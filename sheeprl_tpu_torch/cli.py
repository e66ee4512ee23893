"""Command line (counterpart of ``sheeprl_tpu/cli.py``: the ``run``,
``serve``, ``evaluation`` and ``agents`` verbs)::

    python -m sheeprl_tpu_torch run \\
        preset=<configs/*.json: sac_per, sac, droq, sac_ae, ppo, ppo_anakin, ppo_anakin_population, a2c,
                ppo_decoupled, ppo_sebulba, sac_decoupled, sac_sebulba, sac_sebulba_per, dreamer_sebulba_atari_dummy,
                ppo_recurrent, dreamer_v3_100k_atari_dummy,
                dreamer_v3_100k_atari_dummy_resident, dreamer_v3_continuous_dummy,
                p2e_dv3_exploration_atari_dummy, p2e_dv3_finetuning_atari_dummy, dreamer_v2_atari_dummy,
                dreamer_v2_ms_pacman_dummy, p2e_dv2_exploration_atari_dummy, p2e_dv2_finetuning_atari_dummy,
                dreamer_v1_atari_dummy, p2e_dv1_exploration_atari_dummy, p2e_dv1_finetuning_atari_dummy> \\
        [fabric.accelerator=cuda|cpu] [fabric.precision=32-true|bf16-mixed|...] [algo.total_steps=...] \\
        [checkpoint.resume_from=<ckpt>|latest] [checkpoint.exploration_ckpt_path=<ckpt>] [dry_run=true] ...
    python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt> \\
        [fabric.accelerator=cuda|cpu] [serve.port=0] [serve.buckets=[1,8,32,128]] [serve.engine=aot|naive] \\
        [serve.session.buckets=[1,8,32]] [serve.watch=true] [serve.watch_poll_s=2.0] ...
    python -m sheeprl_tpu_torch evaluation checkpoint_path=<ckpt> [fabric.accelerator=cuda|cpu] [seed=...]
    python -m sheeprl_tpu_torch agents

``run`` trains from a preset (``configs/<name>.json``), or resuming, from the
checkpoint's ``config.json``, with the algorithm ``algo.name`` names (a
trainer of :data:`~sheeprl_tpu_torch.utils.registry.TRAINERS`); :data:`~sheeprl_tpu_torch.config.RUN_DEFAULTS`
fill what it lacks and the ``key.path=value`` overrides win; then
:func:`check_configs` checks the result as the JAX CLI does. A command line
whose first word is not a verb is ``run``'s.
Every run writes into a directory of its own,
``<log_root>/<algo.name>/<env.id>/<run_name>/version_N`` (``run_name`` is
timestamped): its ``config.json``, ``checkpoint/``, ``metrics.jsonl``,
``hparams.json`` and ``memmap_buffer/``. A resumed run takes the old run's
config but its directory, ``checkpoint.resume_from`` and
``algo.learning_starts``, and writes into a new directory.
``checkpoint.resume_from=latest`` resumes from the newest complete
checkpoint under ``<log_root>/<algo.name>/<env.id>`` (the preset's and the
overrides' values), skipping torn saves. ``p2e_dv3_finetuning``,
``p2e_dv2_finetuning`` and ``p2e_dv1_finetuning`` start from ``checkpoint.exploration_ckpt_path``: the
exploration run must have the same ``env.id``, and its env keys
:data:`EXPLORATION_ENV_KEYS` win.
``dry_run=true`` runs one iteration with no warm-up. ``serve`` reads
the run configuration beside the checkpoint under
:data:`~sheeprl_tpu_torch.config.SERVE_DEFAULTS`: a PPO or SAC checkpoint
serves stateless requests through the bucket engine, a DreamerV3 one
sessions. ``evaluation`` (alias ``eval``) runs one greedy test episode of a
checkpoint on one env, seeded with the checkpoint run's seed unless
``seed=`` says otherwise. ``agents`` prints the algorithms the port knows.
Each runs on the GPU unless ``fabric.accelerator=cpu`` asks for the CPU;
asking for the GPU on a machine without one raises. Each computes in the
``fabric.precision`` of its run config (``32-true`` by default;
``bf16-mixed`` computes in bfloat16 over float32 parameters, see
:mod:`sheeprl_tpu_torch.parallel.fabric`); ``serve`` and ``evaluation``
take the checkpoint run's, and an unknown one raises.
"""

from __future__ import annotations

import copy
import importlib
import sys
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import (
    EVAL_DEFAULTS,
    RUN_DEFAULTS,
    SERVE_DEFAULTS,
    DotDict,
    apply_overrides,
    dotdict,
    load_config,
    merge,
    plain,
    preset,
)
from sheeprl_tpu_torch.parallel import Precision

__all__ = [
    "main",
    "run",
    "serve",
    "evaluation",
    "agents",
    "compose_run_config",
    "check_configs",
    "compose_serve_config",
    "compose_eval_config",
    "resolve_device",
    "resolve_resume_latest",
    "configure_metrics",
]


def resolve_device(accelerator: Optional[str]) -> torch.device:
    """``cpu`` -> the CPU; ``cuda``/``gpu``/``auto`` (or unset) -> the current
    CUDA device, raising when there is none."""
    name = str(accelerator or "cuda").lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "gpu", "auto"):
        raise ValueError(f"fabric.accelerator must be cuda|gpu|auto|cpu, got {accelerator!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU unless asked for the "
            "CPU with fabric.accelerator=cpu"
        )
    return torch.device("cuda", torch.cuda.current_device())


def compose_serve_config(args: Sequence[str]) -> DotDict:
    """Serve defaults <- the checkpoint's run config <- the overrides."""
    from sheeprl_tpu_torch.utils.checkpoint import find_run_config

    first = apply_overrides({}, args)
    ckpt = first.get("checkpoint_path")
    if not ckpt:
        raise ValueError("serve needs checkpoint_path=<path to a checkpoint>")
    run_cfg = load_config(find_run_config(ckpt))
    cfg = apply_overrides(merge(SERVE_DEFAULTS, plain(run_cfg)), args)
    # the checkpoint's run computes in its own precision, as the JAX verb
    # reads it from the run config alone
    cfg.fabric["precision"] = (run_cfg.get("fabric") or {}).get("precision", "32-true")
    return cfg


def _full_float32() -> None:
    # the JAX package's reference is float32: cuDNN would otherwise run
    # float32 convolutions in TF32 (cuBLAS already defaults off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_resume_latest(cfg: DotDict) -> str:
    """``checkpoint.resume_from=latest`` -> the newest complete checkpoint
    under ``<log_root>/<root_dir>`` (``root_dir`` defaults to
    ``<algo.name>/<env.id>``); raises
    :class:`~sheeprl_tpu_torch.utils.checkpoint.CheckpointError` when there
    is none."""
    from pathlib import Path

    from sheeprl_tpu_torch.fault.manager import find_latest_run_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointError

    algo, env = (cfg.get("algo") or {}).get("name"), (cfg.get("env") or {}).get("id")
    if not algo or not env:
        raise ValueError("checkpoint.resume_from=latest needs algo.name and env.id (from preset=<name> or overrides)")
    root = Path(str(cfg.get("log_root", "logs/runs"))) / str(cfg.get("root_dir") or f"{algo}/{env}")
    resolved = find_latest_run_checkpoint(root)
    if resolved is None:
        raise CheckpointError(f"checkpoint.resume_from=latest: no complete checkpoint found under {root}", root)
    print(f"checkpoint.resume_from=latest -> {resolved}", flush=True)
    return str(resolved)


def _resumed_config(old: Dict[str, Any], fresh: DotDict) -> Dict[str, Any]:
    """The old run's config for a resume (JAX ``resume_from_checkpoint``):
    raises when the new run names another env or algorithm, warns when the
    old run pre-filled its buffer, and drops what belongs to the old run
    alone (its directory: ``root_dir``, ``run_name``, ``log_root``; its
    ``checkpoint.resume_from`` and ``algo.learning_starts``), so the new run
    takes those from the preset, the defaults and the overrides."""
    old_env, old_algo = (old.get("env") or {}).get("id"), (old.get("algo") or {}).get("name")
    env, algo = (fresh.get("env") or {}).get("id"), (fresh.get("algo") or {}).get("name")
    if env is not None and old_env != env:
        raise ValueError(
            "This experiment is run with a different environment from the one of the experiment you want to restart. "
            f"Got '{env}', but the environment of the experiment of the checkpoint was {old_env}."
        )
    if algo is not None and old_algo != algo:
        raise ValueError(
            "This experiment is run with a different algorithm from the one of the experiment you want to restart. "
            f"Got '{algo}', but the algorithm of the experiment of the checkpoint was {old_algo}."
        )
    if (old.get("algo") or {}).get("learning_starts") and old["algo"]["learning_starts"] > 0:
        warnings.warn(
            "The `algo.learning_starts` parameter is greater than zero: the resuming experiment will pre-fill "
            "the buffer for `algo.learning_starts` steps. Set `algo.learning_starts=0` if not intended."
        )
    old = copy.deepcopy(old)
    for key in ("root_dir", "run_name", "log_root"):
        old.pop(key, None)
    (old.get("checkpoint") or {}).pop("resume_from", None)
    (old.get("algo") or {}).pop("learning_starts", None)
    return old


def _resolve_run_names(cfg: DotDict) -> DotDict:
    """Fill ``exp_name``, ``root_dir`` and ``run_name`` left unset (see
    :data:`~sheeprl_tpu_torch.config.RUN_DEFAULTS`)."""
    algo, env = cfg.algo.name, cfg.env.id
    if cfg.get("exp_name") is None:
        cfg["exp_name"] = f"{algo}_{env}"
    if cfg.get("root_dir") is None:
        cfg["root_dir"] = f"{algo}/{env}"
    if cfg.get("run_name") is None:
        cfg["run_name"] = f"{time.strftime('%Y-%m-%d_%H-%M-%S')}_{cfg.exp_name}_{cfg.seed}"
    return cfg


def compose_run_config(args: Sequence[str]) -> DotDict:
    """Run defaults <- the preset <- resuming, the checkpoint's run config
    less what belongs to the old run alone (:func:`_resumed_config`) <- the
    overrides (``preset=<name>`` is not itself an override); then the run's
    names. ``checkpoint.resume_from=latest`` is first resolved to a path from
    the preset and the overrides."""
    from sheeprl_tpu_torch.utils.checkpoint import find_run_config

    overrides = [a for a in args if not a.startswith("preset=")]
    names = [a.split("=", 1)[1] for a in args if a.startswith("preset=")]
    base = merge(RUN_DEFAULTS, plain(preset(names[-1])) if names else {})
    fresh = apply_overrides(base, overrides)
    resume = (fresh.get("checkpoint") or {}).get("resume_from")
    if resume and str(resume).strip().lower() == "latest":
        resume = resolve_resume_latest(fresh)
        overrides = overrides + [f"checkpoint.resume_from={resume}"]
    if resume:
        base = merge(base, _resumed_config(plain(load_config(find_run_config(resume))), fresh))
    elif not names:
        raise ValueError("run needs preset=<name> (see sheeprl_tpu_torch/configs) or checkpoint.resume_from=<ckpt>")
    cfg = apply_overrides(base, overrides)
    check_configs(cfg)
    return _resolve_run_names(cfg)


#: the families whose hybrid host player (``algo.hybrid_player``) the port
#: does not run yet: ``enabled: true`` raises for them, ``auto`` is off
HYBRID_PLAYER_NOT_PORTED = (
    "dreamer_v2", "dreamer_v1", "p2e_dv1_exploration", "p2e_dv1_finetuning", "p2e_dv2_exploration",
    "p2e_dv2_finetuning", "p2e_dv3_exploration", "p2e_dv3_finetuning",
)


def check_configs(cfg: DotDict) -> None:
    """JAX ``check_configs``' checks of a run config that the port has keys
    for: a negative ``algo.learning_starts`` raises; an ``env.action_repeat``
    below 1 becomes 1. An unknown ``fabric.precision`` raises the
    ``ValueError`` of the JAX package's ``Precision.from_string``. An
    ``algo.hybrid_player.enabled`` set on (``true``) for a family of
    :data:`HYBRID_PLAYER_NOT_PORTED` raises: the port has no hybrid path
    for it yet, and would otherwise train coupled while the config says
    hybrid."""
    Precision.from_config(cfg)
    algo = cfg.get("algo") or {}
    enabled = (algo.get("hybrid_player") or {}).get("enabled", "auto")
    if algo.get("name") in HYBRID_PLAYER_NOT_PORTED and str(enabled).lower() == "true":
        raise ValueError(
            f"algo.hybrid_player.enabled=true: the hybrid host player is not ported yet for '{algo.get('name')}' "
            "(DreamerV3 and SAC have it); set algo.hybrid_player.enabled=false or auto, which is off for it"
        )
    learning_starts = (cfg.get("algo") or {}).get("learning_starts")
    if learning_starts is not None and learning_starts < 0:
        raise ValueError("The `algo.learning_starts` parameter must be greater or equal to zero.")
    env = cfg.get("env") or {}
    if env.get("action_repeat") is not None and env["action_repeat"] < 1:
        env["action_repeat"] = 1


def compose_eval_config(args: Sequence[str]) -> DotDict:
    """The checkpoint's run config with one env, the checkpoint's path, and
    the accelerator and seed of :data:`EVAL_DEFAULTS` <- the overrides (the
    seed, if unset, stays the run's own)."""
    from sheeprl_tpu_torch.utils.checkpoint import find_run_config

    eval_cfg = apply_overrides(EVAL_DEFAULTS, args)
    ckpt = eval_cfg.get("checkpoint_path")
    if not ckpt:
        raise ValueError("evaluation needs checkpoint_path=<path to a checkpoint>")
    run_cfg = plain(load_config(find_run_config(ckpt)))
    return dotdict(merge(run_cfg, {
        "env": {"num_envs": 1},
        "fabric": {"accelerator": eval_cfg.fabric.get("accelerator")},
        "checkpoint_path": str(ckpt),
        "seed": eval_cfg.seed if eval_cfg.get("seed") is not None else run_cfg.get("seed", 42),
    }))


def configure_metrics(cfg: DotDict, aggregator_keys: Sequence[str]) -> None:
    """The run's metric switches (JAX ``run_algorithm``): the aggregator
    keeps only the keys its algorithm logs (``aggregator_keys``) and is off
    at ``metric.log_level=0`` or with no key left; the timers are off as
    ``metric.disable_timer`` says, or with it unset, at ``log_level=0``."""
    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.timer import timer

    metric = cfg.metric
    log_level = int(metric.get("log_level", 1))
    disable_timer = metric.get("disable_timer")
    timer.disabled = log_level == 0 if disable_timer is None else bool(disable_timer)
    metrics_cfg = (metric.get("aggregator") or {}).get("metrics") or {}
    for k in set(metrics_cfg) - set(aggregator_keys):
        metrics_cfg.pop(k)
    MetricAggregator.disabled = log_level == 0 or not metrics_cfg


#: the env keys a finetuning run takes from its exploration run (JAX ``cli.py``)
EXPLORATION_ENV_KEYS = (
    "frame_stack", "screen_size", "action_repeat", "grayscale", "clip_rewards", "frame_stack_dilation",
    "max_episode_steps", "reward_as_observation",
)


#: the algorithms that start from an exploration run's checkpoint
FINETUNING_ALGOS = ("p2e_dv3_finetuning", "p2e_dv2_finetuning", "p2e_dv1_finetuning")


def _exploration_handoff(cfg: DotDict) -> None:
    """P2E finetuning: the exploration run's config (beside
    ``checkpoint.exploration_ckpt_path``) must name the same env; its
    :data:`EXPLORATION_ENV_KEYS` replace the run's."""
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import exploration_config

    exploration_cfg = exploration_config(cfg)
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want to "
            f"finetune. Got '{cfg.env.id}', but the environment used during exploration was "
            f"{exploration_cfg.env.id}."
        )
    for k in EXPLORATION_ENV_KEYS:
        if k in exploration_cfg.env:
            cfg.env[k] = exploration_cfg.env[k]


def run(args: Sequence[str]) -> dict:
    """Train; returns the run's summary (counters, metrics, checkpoint)."""
    from sheeprl_tpu_torch.fault.inject import arm_from_env
    from sheeprl_tpu_torch.utils.registry import TRAINERS

    arm_from_env()  # SHEEPRL_FAULT_ARM's fault points, for drills
    cfg = compose_run_config(args)
    if cfg.algo.name not in TRAINERS:
        raise RuntimeError(f"Given the algorithm named '{cfg.algo.name}', no module has been found to be imported.")
    if cfg.algo.name in FINETUNING_ALGOS:
        _exploration_handoff(cfg)
    device = resolve_device(cfg.fabric.get("accelerator"))
    _full_float32()
    module = TRAINERS[cfg.algo.name]
    utils = importlib.import_module(module.rsplit(".", 1)[0] + ".utils")
    configure_metrics(cfg, utils.AGGREGATOR_KEYS)
    return importlib.import_module(module).main(cfg, device)


def serve(args: Sequence[str]) -> None:
    from sheeprl_tpu_torch.serve.server import serve_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import registered_policy_builder_names, resolve_policy_builder

    cfg = compose_serve_config(args)
    Precision.from_config(cfg)
    device = resolve_device(cfg.fabric.get("accelerator"))
    _full_float32()
    builder = resolve_policy_builder(cfg.algo.name)
    if builder is None:
        raise RuntimeError(
            f"no serving policy builder is registered for '{cfg.algo.name}'. "
            f"Registered: {', '.join(registered_policy_builder_names())}."
        )
    state = load_checkpoint(cfg.checkpoint_path)
    serve_policy(cfg, state, builder, device)


def evaluation(args: Sequence[str]) -> dict:
    """One greedy test episode of a checkpoint; returns ``{"reward", "steps",
    "device"}``."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import resolve_evaluation

    cfg = compose_eval_config(args)
    Precision.from_config(cfg)
    device = resolve_device(cfg.fabric.get("accelerator"))
    _full_float32()
    evaluate = resolve_evaluation(cfg.algo.name)
    if evaluate is None:
        raise RuntimeError(f"no evaluation is registered for '{cfg.algo.name}'")
    result = evaluate(cfg, load_checkpoint(cfg.checkpoint_path), device)
    return {"reward": result["reward"], "steps": result["steps"], "device": str(device)}


def agents(args: Sequence[str] = ()) -> List[dict]:
    """Print, and return, one row per algorithm: its name, trainer module,
    whether it evaluates and serves, and its ``decoupled`` flag (the JAX
    CLI's table without ``rich``)."""
    from sheeprl_tpu_torch.utils.registry import algorithm_table

    if args:
        raise ValueError(f"agents takes no arguments, got {list(args)}")
    rows = algorithm_table()
    for row in rows:
        print(f"{row['name']}: trainer={row['trainer']}, evaluation={row['evaluation']}, serving={row['serving']}, "
              f"decoupled={row['decoupled']}")
    return rows


_VERBS = {"run": run, "serve": serve, "evaluation": evaluation, "eval": evaluation, "agents": agents}


def main(argv: Optional[List[str]] = None) -> None:
    """Dispatch on the first word when it is a verb; otherwise every word is
    an argument of ``run``, as in the JAX CLI."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _VERBS:
        _VERBS[argv[0]](argv[1:])
    else:
        run(argv)
