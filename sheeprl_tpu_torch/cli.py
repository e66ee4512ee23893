"""Command line (counterpart of ``sheeprl_tpu/cli.py``, ``serve`` verb)::

    python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt> \\
        [fabric.accelerator=cuda|cpu] [serve.port=0] [serve.session.buckets=[1,8,32]] ...

The run configuration is the ``config.json`` beside the checkpoint;
:data:`~sheeprl_tpu_torch.config.SERVE_DEFAULTS` fill what it lacks and the
``key.path=value`` overrides win. The server runs on the GPU unless
``fabric.accelerator=cpu`` asks for the CPU; asking for the GPU on a machine
without one raises.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import SERVE_DEFAULTS, DotDict, apply_overrides, load_config, merge, plain

__all__ = ["main", "serve", "compose_serve_config", "resolve_device"]


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
    return apply_overrides(merge(SERVE_DEFAULTS, plain(run_cfg)), args)


def serve(args: Sequence[str]) -> None:
    from sheeprl_tpu_torch.serve.server import serve_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import registered_policy_builder_names, resolve_policy_builder

    cfg = compose_serve_config(args)
    device = resolve_device(cfg.fabric.get("accelerator"))
    # serve in full float32, as the JAX package's reference does: cuDNN would
    # otherwise run float32 convolutions in TF32 (cuBLAS already defaults off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    builder = resolve_policy_builder(cfg.algo.name)
    if builder is None:
        raise RuntimeError(
            f"no serving policy builder is registered for '{cfg.algo.name}'. "
            f"Registered: {', '.join(registered_policy_builder_names())}."
        )
    state = load_checkpoint(cfg.checkpoint_path)
    serve_policy(cfg, state, builder, device)


_VERBS = {"serve": serve}


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _VERBS:
        raise SystemExit(f"usage: python -m sheeprl_tpu_torch {{{'|'.join(_VERBS)}}} key=value ...")
    _VERBS[argv[0]](argv[1:])
