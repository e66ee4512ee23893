"""Command line (counterpart of ``sheeprl_tpu/cli.py``: the ``run``,
``serve``, ``serve_fleet``, ``evaluation`` and ``agents`` verbs)::

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
        [serve.session.buckets=[1,8,32]] [serve.watch=true] [serve.watch_poll_s=2.0] \\
        [--fleet [N]] [--flywheel [DIR]] ...
    python -m sheeprl_tpu_torch serve_fleet checkpoint_path=<ckpt> [serve.fleet.replicas=3] ...
    python -m sheeprl_tpu_torch run --from-serve <DIR> checkpoint_path=<ckpt> [serve.flywheel.*=...]
    python -m sheeprl_tpu_torch evaluation checkpoint_path=<ckpt> [fabric.accelerator=cuda|cpu] [seed=...]
    python -m sheeprl_tpu_torch agents

The JAX CLI's ``registration`` verb is not ported: it exits with the
reason. ``run --pod N`` (``--pod`` alone means 2, ``--pod=N`` too, or
``fabric.pod.workers=N``) trains over a gang-supervised pod of N worker
processes, one device each, joined in one ``torch.distributed`` group
(:mod:`sheeprl_tpu_torch.parallel.pod`); fewer than 2 workers raise. Every
``run``, ``serve`` and ``serve_fleet`` joins the group the
``fabric.distributed`` block or the ``SHEEPRL_*`` variables name
(:func:`~sheeprl_tpu_torch.parallel.distributed.maybe_init`), and a run
checks ``fabric.devices`` (one device per process) and sets the gradient
wire (``fabric.grad_reduce_dtype``, :func:`~sheeprl_tpu_torch.parallel.fabric.setup`).
Under a group of more than one process only the algorithms that reduce
their gradients over it train (:data:`DATA_PARALLEL`); the others raise
``NotImplementedError``. ``serve --fleet N`` (or ``serve.fleet.replicas=N``
with N >= 2, or the ``serve_fleet`` verb, 3 replicas unless
``serve.fleet.replicas`` says otherwise) serves the checkpoint through N
supervised replica processes behind a router
(:mod:`sheeprl_tpu_torch.serve.fleet`); a fleet asked for by the flag or the
verb with fewer than 2 replicas raises. ``serve --flywheel [DIR]`` turns on
the serve→train loop (:mod:`sheeprl_tpu_torch.serve.flywheel`, the spool in
DIR, default ``flywheel/`` beside the checkpoint), whose learner is ``run
--from-serve DIR``.
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
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    "serve_fleet",
    "learn_from_serve",
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


def _wants_cpu(accelerator: Optional[str]) -> bool:
    """True for ``cpu``; for ``cuda``/``gpu``/``auto`` (or unset) False,
    raising when there is no CUDA device (without making a CUDA context)."""
    name = str(accelerator or "cuda").lower()
    if name == "cpu":
        return True
    if name not in ("cuda", "gpu", "auto"):
        raise ValueError(f"fabric.accelerator must be cuda|gpu|auto|cpu, got {accelerator!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU unless asked for the "
            "CPU with fabric.accelerator=cpu"
        )
    return False


def resolve_device(accelerator: Optional[str]) -> torch.device:
    """``cpu`` -> the CPU; ``cuda``/``gpu``/``auto`` (or unset) -> the current
    CUDA device, raising when there is none."""
    if _wants_cpu(accelerator):
        return torch.device("cpu")
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


def check_configs(cfg: DotDict) -> None:
    """JAX ``check_configs``' checks of a run config that the port has keys
    for: a negative ``algo.learning_starts`` raises; an ``env.action_repeat``
    below 1 becomes 1. An unknown ``fabric.precision`` raises the
    ``ValueError`` of the JAX package's ``Precision.from_string``, an unknown
    ``fabric.grad_reduce_dtype`` that of its ``set_grad_reduce_dtype``."""
    from sheeprl_tpu_torch.parallel.comm import parse_grad_reduce_dtype

    Precision.from_config(cfg)
    parse_grad_reduce_dtype((cfg.get("fabric") or {}).get("grad_reduce_dtype", "auto"))
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


def _extract_fleet_flag(args: List[str]) -> Tuple[List[str], Optional[int]]:
    """``--fleet [N]`` / ``--fleet=N`` out of the arguments: (the rest, the
    replica count or None). A bare ``--fleet`` means 3."""
    out: List[str] = []
    fleet: Optional[int] = None
    i = 0
    while i < len(args):
        tok = args[i]
        if tok == "--fleet":
            if i + 1 < len(args) and args[i + 1].isdigit():
                fleet = int(args[i + 1])
                i += 2
            else:
                fleet = 3
                i += 1
            continue
        if tok.startswith("--fleet="):
            fleet = int(tok.split("=", 1)[1])
            i += 1
            continue
        out.append(tok)
        i += 1
    return out, fleet


def _extract_pod_flag(args: List[str]) -> Tuple[List[str], Optional[int]]:
    """``--pod [N]`` / ``--pod=N`` out of the arguments: (the rest, the
    worker count or None). A bare ``--pod`` means 2."""
    out: List[str] = []
    pod: Optional[int] = None
    i = 0
    while i < len(args):
        tok = args[i]
        if tok == "--pod":
            if i + 1 < len(args) and args[i + 1].isdigit():
                pod = int(args[i + 1])
                i += 2
            else:
                pod = 2
                i += 1
            continue
        if tok.startswith("--pod="):
            pod = int(tok.split("=", 1)[1])
            i += 1
            continue
        out.append(tok)
        i += 1
    return out, pod


#: the algorithms whose steps mean-reduce their gradients over a
#: ``torch.distributed`` group; any other raises under more than one process
DATA_PARALLEL = frozenset({"ppo", "a2c", "ppo_recurrent", "sac", "droq", "sac_ae", "dreamer_v3"})

#: the data-parallel algorithms with a hybrid host player
#: (``algo.hybrid_player``), whose bursts do not train under a group yet
HYBRID_FAMILIES = frozenset({"sac", "dreamer_v3"})


def _require_coupled_player(cfg: DotDict, world: int) -> None:
    """Refuse a group of ``world`` > 1 processes for a run whose hybrid host
    player resolves on (``algo.hybrid_player.enabled`` true, or ``auto`` off
    the CPU, as JAX's ``resolve_hybrid_player``): its bursts train on a
    trainer thread that does not reduce over the group yet. Resolved from the
    accelerator's name, so a launcher needs no device to refuse."""
    from sheeprl_tpu_torch.utils.utils import resolve_hybrid_player

    if world <= 1 or cfg.algo.name not in HYBRID_FAMILIES:
        return
    device = "cpu" if str(cfg.fabric.get("accelerator") or "cuda").lower() == "cpu" else "cuda"
    if resolve_hybrid_player(cfg.algo.get("hybrid_player"), device):
        raise NotImplementedError(
            f"{cfg.algo.name}: the hybrid host player (algo.hybrid_player.enabled resolves on, as `auto` does on the "
            f"card) does not train over {world} processes yet; its bursts do not reduce over the group. Pass "
            "algo.hybrid_player.enabled=false for data-parallel training; the hybrid bursts under a group are in "
            "ROADMAP, Queue 1"
        )


def _require_data_parallel(algo: str, world: int) -> None:
    """Refuse a group of ``world`` > 1 processes for an algorithm whose steps
    do not reduce their gradients: each process would train alone on its
    own data."""
    if world > 1 and algo not in DATA_PARALLEL:
        raise NotImplementedError(
            f"{algo}: data-parallel training over {world} processes is not ported for this algorithm; its gradient "
            f"steps do not reduce over the group yet, and each process would train alone. Only "
            f"{', '.join(sorted(DATA_PARALLEL))} train data-parallel; the data-parallel slice of the off-policy, "
            "Dreamer, Anakin, population and async families will add the rest (ROADMAP, Queue 1)"
        )


def _extract_flywheel_flag(args: List[str]) -> Tuple[List[str], bool, Optional[str]]:
    """``--flywheel [DIR]`` / ``--flywheel=DIR`` out of the arguments: (the
    rest, whether it was given, the spool directory or None: ``flywheel/``
    beside the served checkpoint)."""
    out: List[str] = []
    enabled = False
    directory: Optional[str] = None
    i = 0
    while i < len(args):
        tok = args[i]
        if tok == "--flywheel":
            enabled = True
            nxt = args[i + 1] if i + 1 < len(args) else None
            if nxt is not None and "=" not in nxt and not nxt.startswith("-"):
                directory = nxt
                i += 2
            else:
                i += 1
            continue
        if tok.startswith("--flywheel="):
            enabled = True
            directory = tok.split("=", 1)[1] or None
            i += 1
            continue
        out.append(tok)
        i += 1
    return out, enabled, directory


def _extract_from_serve_flag(args: List[str]) -> Tuple[List[str], Optional[str]]:
    """``--from-serve DIR`` / ``--from-serve=DIR`` out of the arguments: (the
    rest, the spool directory or None). DIR is required."""
    out: List[str] = []
    directory: Optional[str] = None
    i = 0
    while i < len(args):
        tok = args[i]
        if tok == "--from-serve":
            if i + 1 >= len(args) or "=" in args[i + 1]:
                raise ValueError("--from-serve needs the flywheel spool directory (`--from-serve <dir>`)")
            directory = args[i + 1]
            i += 2
            continue
        if tok.startswith("--from-serve="):
            directory = tok.split("=", 1)[1]
            if not directory:
                raise ValueError("--from-serve needs the flywheel spool directory (`--from-serve=<dir>`)")
            i += 1
            continue
        out.append(tok)
        i += 1
    return out, directory


def learn_from_serve(args: Sequence[str], directory: str) -> dict:
    """``run --from-serve <dir>``: the flywheel's learner as its own process.
    The config is composed as ``serve``'s (the checkpoint's run config, so
    the learner rebuilds the agent that is served), with the flywheel on and
    its spool in ``directory``; returns the learner's last status."""
    from sheeprl_tpu_torch.serve.flywheel import run_flywheel_learner
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = compose_serve_config(args)
    cfg.serve.flywheel.update({"enabled": True, "dir": str(directory)})
    Precision.from_config(cfg)
    device = resolve_device(cfg.fabric.get("accelerator"))
    _full_float32()
    return run_flywheel_learner(cfg, load_checkpoint(cfg.checkpoint_path), device)


def _apply_run_checks(cfg: DotDict) -> None:
    """The JAX ``run_algorithm``'s process-wide settings from the config:
    ``distribution.validate_args`` and the ``ops`` block (checked; see
    :mod:`~sheeprl_tpu_torch.ops.backend`)."""
    from sheeprl_tpu_torch.distributions import set_validate_args
    from sheeprl_tpu_torch.ops.backend import configure_from_config

    set_validate_args(bool((cfg.get("distribution") or {}).get("validate_args", False)))
    configure_from_config(cfg.get("ops"))


def run(args: Sequence[str]) -> dict:
    """Train; returns the run's summary (counters, metrics, checkpoint).
    ``--from-serve <dir>`` runs the flywheel's learner instead
    (:func:`learn_from_serve`); ``--pod N`` (or ``fabric.pod.workers=N``)
    runs the pod launcher, which returns the pod's summary."""
    from sheeprl_tpu_torch.fault.inject import arm_from_env
    from sheeprl_tpu_torch.parallel import fabric
    from sheeprl_tpu_torch.parallel.distributed import maybe_init
    from sheeprl_tpu_torch.parallel.pod import maybe_start_worker_runtime, pod_worker_active, run_pod
    from sheeprl_tpu_torch.utils.registry import TRAINERS

    args, from_serve = _extract_from_serve_flag(list(args))
    if from_serve is not None:
        return learn_from_serve(args, from_serve)
    args, pod_flag = _extract_pod_flag(args)
    arm_from_env()  # SHEEPRL_FAULT_ARM's fault points, for drills
    cfg = compose_run_config(args)
    if cfg.algo.name not in TRAINERS:
        raise RuntimeError(f"Given the algorithm named '{cfg.algo.name}', no module has been found to be imported.")
    _apply_run_checks(cfg)
    if pod_flag is not None:
        cfg.fabric.pod["workers"] = int(pod_flag)
    if (pod_flag is not None or int(cfg.fabric.pod.get("workers", 0) or 0)) and not pod_worker_active():
        # asked for a pod: get one or a loud error (the launcher wants 2 or
        # more workers), never a lone process
        _require_data_parallel(cfg.algo.name, max(2, int(cfg.fabric.pod.get("workers", 0) or 0)))
        _require_coupled_player(cfg, max(2, int(cfg.fabric.pod.get("workers", 0) or 0)))
        _wants_cpu(cfg.fabric.get("accelerator"))  # no card, no pod; the launcher itself needs none
        return run_pod(cfg, args)
    # the worker runtime first: the launcher's lease must outlive the join
    maybe_start_worker_runtime()
    maybe_init(cfg.fabric.get("distributed"))
    if cfg.algo.name in FINETUNING_ALGOS:
        _exploration_handoff(cfg)
    device = resolve_device(cfg.fabric.get("accelerator"))
    world = fabric.setup(cfg)["world_size"]
    _require_data_parallel(cfg.algo.name, world)
    _require_coupled_player(cfg, world)
    _full_float32()
    module = TRAINERS[cfg.algo.name]
    utils = importlib.import_module(module.rsplit(".", 1)[0] + ".utils")
    configure_metrics(cfg, utils.AGGREGATOR_KEYS)
    summary = importlib.import_module(module).main(cfg, device)
    if pod_worker_active():
        _report_worker(summary, world)
    return summary


def _report_worker(summary: Dict[str, Any], world: int) -> None:
    """A pod worker's ``POD_WORKER`` line: its rank, iterations, host seconds
    of its rollouts and updates, env steps/s, its peak reserved card memory,
    the kernels it launched, the reductions it made and its final
    parameters' digest (the ranks' must be equal)."""
    import json

    from sheeprl_tpu_torch.ops.kernels import LAUNCHES
    from sheeprl_tpu_torch.parallel.comm import REDUCTIONS
    from sheeprl_tpu_torch.parallel.distributed import rank

    print("POD_WORKER " + json.dumps({
        "rank": rank(), "world_size": world, "start_iter": summary.get("start_iter"),
        "iterations": summary.get("iterations"), "policy_steps": summary.get("policy_steps"),
        "rollout_s": sum(summary.get("rollout_s") or summary.get("env_s") or ()),
        "update_s": sum(summary.get("update_s") or summary.get("train_s") or ()),
        "gradient_steps": summary.get("gradient_steps"),
        "env_steps_per_s": summary.get("env_steps_per_s"),
        "cuda_max_reserved_mb": torch.cuda.max_memory_reserved() / 2 ** 20 if torch.cuda.is_initialized() else None,
        "launches": {k: v for k, v in LAUNCHES.items() if v}, "reductions": dict(REDUCTIONS),
        "param_digest": summary.get("param_digest"), "replay_digest": summary.get("replay_digest"),
        "drained": summary.get("drained"),
        "test_reward": summary.get("test_reward"), "test_steps": summary.get("test_steps"),
        "player_steps": summary.get("player_steps"), "replay": summary.get("replay"), "last10": summary.get("last10"),
    }), flush=True)


def serve(args: Sequence[str], fleet: Optional[int] = None, require_fleet: bool = False) -> Optional[dict]:
    """Serve a checkpoint (see the module docstring): one server in this
    process, or with ``serve.fleet.replicas`` >= 2 (``--fleet N``, ``fleet``)
    a fleet of replica processes, whose router's last health it returns.
    ``--flywheel [DIR]`` turns the serve→train loop on."""
    from sheeprl_tpu_torch.serve.server import serve_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import registered_policy_builder_names, resolve_policy_builder

    args, flag_fleet = _extract_fleet_flag(list(args))
    args, flag_flywheel, flywheel_dir = _extract_flywheel_flag(args)
    fleet = flag_fleet if flag_fleet is not None else fleet
    cfg = compose_serve_config(args)
    from sheeprl_tpu_torch.ops.backend import configure_from_config
    from sheeprl_tpu_torch.parallel.distributed import maybe_init

    configure_from_config(cfg.get("ops"))  # JAX's serve checks the ops block too

    # serve joins the same group as run, from the same fabric.distributed / SHEEPRL_* knobs
    maybe_init(cfg.fabric.get("distributed"))
    if fleet is not None:
        cfg.serve.fleet["replicas"] = int(fleet)
    if flag_flywheel:
        cfg.serve.flywheel["enabled"] = True
        if flywheel_dir is not None:
            cfg.serve.flywheel["dir"] = str(flywheel_dir)
    replicas = int(cfg.serve.fleet.get("replicas", 0) or 0)
    if (require_fleet or flag_fleet is not None) and replicas < 2:
        # asked for a fleet: a lone unsupervised server would serve without any
        # of the fleet's fault tolerance, so fail loudly instead
        raise ValueError(f"fleet serving needs serve.fleet.replicas >= 2, got {replicas} — "
                         "drop the fleet flag/verb for a single-process server")
    Precision.from_config(cfg)
    if replicas >= 2:
        from sheeprl_tpu_torch.serve.fleet import serve_fleet as serve_fleet_body

        _wants_cpu(cfg.fabric.get("accelerator"))  # no card, no fleet; the router itself needs none
        return serve_fleet_body(cfg)
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
    return None


def serve_fleet(args: Sequence[str]) -> Optional[dict]:
    """``serve_fleet checkpoint_path=...``: ``serve --fleet N`` with N from
    ``serve.fleet.replicas`` (3 unless given; fewer than 2 raises)."""
    has_replicas = any(a.startswith("serve.fleet.replicas=") for a in args)
    return serve(list(args), fleet=None if has_replicas else 3, require_fleet=True)


def evaluation(args: Sequence[str]) -> dict:
    """One greedy test episode of a checkpoint; returns ``{"reward", "steps",
    "device"}``."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import resolve_evaluation

    from sheeprl_tpu_torch.ops.backend import configure_from_config

    cfg = compose_eval_config(args)
    configure_from_config(cfg.get("ops"))  # JAX's eval checks the ops block too
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


_VERBS = {"run": run, "serve": serve, "serve_fleet": serve_fleet, "evaluation": evaluation, "eval": evaluation,
          "agents": agents}

#: the JAX CLI's verbs (its ``main``), the ported ones and the rest
JAX_VERBS = ("run", "eval", "evaluation", "serve", "serve_fleet", "agents", "registration")

#: why each JAX verb the port lacks is not here
NOT_PORTED = {
    "registration": "model registration needs mlflow, which this round leaves out",
}


def _not_ported(verb: str) -> None:
    raise SystemExit(f"'{verb}' is a verb of the JAX CLI that is not ported: {NOT_PORTED[verb]}")


def main(argv: Optional[List[str]] = None) -> None:
    """Dispatch on the first word when it is a verb; otherwise every word is
    an argument of ``run``, as in the JAX CLI. A JAX verb the port lacks
    (:data:`NOT_PORTED`) exits with the reason instead of reaching ``run``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in JAX_VERBS:
        run(argv)
        return
    verb, rest = argv[0], argv[1:]
    if verb in NOT_PORTED:
        _not_ported(verb)
    _VERBS[verb](rest)
