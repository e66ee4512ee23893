"""JSON run configuration (counterpart of ``sheeprl_tpu/config.py``).

The port reads no YAML. A run's configuration is the ``config.json`` saved
beside its checkpoint, with the same key paths as the JAX package's composed
config (``algo.world_model.recurrent_model.recurrent_state_size``, ...) plus a
``spaces`` block: the observation and action specs, which the JAX package
reads off a gymnasium env. ``serve`` merges :data:`SERVE_DEFAULTS` under the
run config and CLI-style ``key.path=value`` overrides over it; ``run`` merges
:data:`RUN_DEFAULTS` under a preset (or, resuming, the checkpoint's run
config) the same way; ``evaluation`` reads :data:`EVAL_DEFAULTS` and the
overrides, and lays what they pick over the checkpoint's run config.
"""

from __future__ import annotations

import ast
import copy
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable

__all__ = [
    "DotDict",
    "dotdict",
    "plain",
    "load_config",
    "apply_overrides",
    "merge",
    "preset",
    "SERVE_DEFAULTS",
    "RUN_DEFAULTS",
    "EVAL_DEFAULTS",
    "PRESETS_DIR",
]

PRESETS_DIR = Path(__file__).resolve().parent / "configs"


class DotDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e



def dotdict(data: Any) -> Any:
    if isinstance(data, dict):
        return DotDict({k: dotdict(v) for k, v in data.items()})
    if isinstance(data, (list, tuple)):
        return type(data)(dotdict(v) for v in data)
    return data


def plain(data: Any) -> Any:
    if isinstance(data, dict):
        return {k: plain(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [plain(v) for v in data]
    return data


#: what ``serve`` steers, with the JAX package's serve_config.yaml defaults
#: for the keys the port implements
SERVE_DEFAULTS: Dict[str, Any] = {
    "checkpoint_path": None,
    "fabric": {"accelerator": "cuda"},
    "serve": {
        "buckets": None,  # None: serve.engine.default_buckets(), (1, 8, 32, 128)
        "engine": "aot",  # aot: the bucket engine; naive: one dispatch per request
        "seed": 0,  # keys the stateless sample-mode draws
        "mode": "greedy",
        "max_wait_ms": 5.0,
        "max_batch": None,
        "queue_bound": 256,
        "host": "127.0.0.1",
        "port": 0,
        "request_timeout_s": 30.0,
        "session": {"ttl_s": 300.0, "max_sessions": 1024, "buckets": None, "sweep_every_s": 1.0},
        "max_requests": None,
        "log_every_s": 10.0,
        # hot swap: watch the served checkpoint's directory and publish each
        # newer complete save; watch_publish_current adopts the newest save
        # at start; a save that fails to load watcher_quarantine_after times
        # is quarantined; weights older than max_staleness_s (None: no alarm)
        # turn the health probe to degraded
        "watch": False,
        "watch_poll_s": 2.0,
        "watch_publish_current": False,
        "max_staleness_s": None,
        "watcher_quarantine_after": 3,
        # the scheduler and watcher workers' supervisor (fault.supervisor.*)
        "supervisor": {},
    },
}


#: what ``evaluation`` steers, as the JAX package's eval_config.yaml: the
#: seed defaults to the checkpoint run's own
EVAL_DEFAULTS: Dict[str, Any] = {
    "checkpoint_path": None,
    "seed": None,
    "fabric": {"accelerator": "cuda"},
}


#: what ``run`` needs beyond a preset, with the JAX package's defaults.
#: ``exp_name``, ``root_dir`` and ``run_name`` left at None are resolved when
#: ``run`` composes the config: ``<algo.name>_<env.id>``,
#: ``<algo.name>/<env.id>`` and ``<%Y-%m-%d_%H-%M-%S>_<exp_name>_<seed>``, so
#: a run's directory is ``<log_root>/<root_dir>/<run_name>/version_N``
RUN_DEFAULTS: Dict[str, Any] = {
    "seed": 42,
    "exp_name": None,
    "root_dir": None,
    "run_name": None,
    "log_root": "logs/runs",
    # configs/fabric/default.yaml's precision; see sheeprl_tpu_torch/parallel/fabric.py
    "fabric": {"accelerator": "cuda", "precision": "32-true"},
    # configs/metric/default.yaml; disable_timer None: the timers run iff
    # log_level > 0; the presets add their Loss/* and State/* keys
    "metric": {
        "log_level": 1,
        "log_every": 5000,
        "disable_timer": None,
        # the iteration-windowed trace (utils/profiler.py:TraceProfiler)
        "profiler": {"enabled": False, "start_iter": 8, "num_iters": 4},
        "aggregator": {
            "raise_on_missing": False,
            "metrics": {"Rewards/rew_avg": {"_target_": "MeanMetric"}, "Game/ep_len_avg": {"_target_": "MeanMetric"}},
        },
    },
    "logger": {"name": "jsonl"},
    "buffer": {
        "size": 1000000,
        # configs/buffer/default.yaml: host buffers on files under the run's
        # memmap_buffer/ (the PPO and SAC presets turn it off)
        "memmap": True,
        "memmap_mode": "r+",
        "checkpoint": True,
        "sample_next_obs": False,
        "device_resident": False,
        "hbm_budget_gb": 4.0,
        "priority": {"enabled": False, "alpha": 0.6, "beta": 0.4, "eps": 1e-6},
    },
    # the JAX package's configs/checkpoint/default.yaml; resume_from may be a
    # path or "latest" (the newest complete checkpoint under the experiment)
    "checkpoint": {"every": 100, "resume_from": None, "save_last": True, "keep_last": 5, "async_save": False},
    # configs/fault/default.yaml: the in-step finite guard and its sentinel,
    # the async tiers' actor supervision and seeded chaos schedule, and the
    # iterations whose training data is poisoned with NaNs
    "fault": {
        "sentinel": {"enabled": True, "max_consecutive": 3, "action": "rollback"},
        "supervisor": {"enabled": True, "max_restarts": 2, "backoff": 0.5, "escalation": "degrade",
                       "lease_s": 60.0, "grace_s": 300.0, "join_s": 30.0, "handoff_deadline_s": 120.0},
        "chaos": {"enabled": False, "seed": 0, "events": []},
        "inject": {"nan_grads_at": []},
    },
    # configs/env/default.yaml: self-healing env workers (off at 0 attempts
    # and no timeout), and the wrapper chain's keys (envs/vector.py:make_env);
    # capture_video is off, as the port records no video
    "env": {
        "restart_attempts": 0,
        "restart_backoff": 0.5,
        "step_timeout": None,
        "action_repeat": 1,
        "mask_velocities": False,
        "frame_stack": 1,
        "frame_stack_dilation": 1,
        "actions_as_observation": {"num_stack": -1, "noop": "You MUST define the NOOP", "dilation": 1},
        "reward_as_observation": False,
        "grayscale": False,
        "capture_video": False,
    },
    # configs/config.yaml: one iteration, no warm-up and the loops' smallest buffers
    "dry_run": False,
}


def merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge, ``over`` winning; neither input changes."""
    out = copy.deepcopy(dict(base))
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: "str | os.PathLike") -> DotDict:
    with open(path) as f:
        return dotdict(json.load(f))


def preset(name: str) -> DotDict:
    """A run configuration shipped with the package (``configs/<name>.json``)."""
    return load_config(PRESETS_DIR / f"{name}.json")


def _split_top(text: str) -> list:
    """``text`` split at the commas outside brackets and braces."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(text[start:i].strip())
            start = i + 1
    if text[start:].strip():
        parts.append(text[start:].strip())
    return parts


def _parse_value(text: str) -> Any:
    for parse in (json.loads, ast.literal_eval):
        try:
            return parse(text)
        except (ValueError, SyntaxError):
            continue
    if text.startswith("[") and text.endswith("]"):  # a list of bare words, as in algo.cnn_keys.encoder=[rgb]
        inner = text[1:-1].strip()
        return [_parse_value(item.strip()) for item in _split_top(inner)] if inner else []
    if text.startswith("{") and text.endswith("}"):  # a mapping with bare keys, as in hparams={lr: [1e-3, 5e-4]}
        out = {}
        for item in _split_top(text[1:-1].strip()):
            key, sep, value = item.partition(":")
            if not sep:
                raise ValueError(f"cannot parse {text!r}: {item!r} is not key: value")
            out[key.strip()] = _parse_value(value.strip())
        return out
    lowered = text.lower()
    if lowered in ("null", "none"):
        return None
    if lowered in ("true", "false"):
        return lowered == "true"
    return text


def apply_overrides(cfg: Dict[str, Any], overrides: Iterable[str]) -> DotDict:
    """Apply ``a.b.c=value`` tokens; values parse as JSON, then as Python
    literals (``True``, ``[1, 8]``), then as lists of bare words
    (``[rgb, state]``), else stay strings."""
    out = plain(cfg)
    for token in overrides:
        if "=" not in token:
            raise ValueError(f"override '{token}' is not of the form key.path=value")
        key, text = token.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = node[part] = {}
            node = nxt
        node[parts[-1]] = _parse_value(text.strip())
    return dotdict(out)
