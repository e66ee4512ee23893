#!/usr/bin/env python3
"""What the fault runtime costs the port's default training paths on one
card, for one tree of this repo (run it on two trees in one session to
compare them)::

    python3 tools/guard_cost.py --tree DIR --out FILE.json [--sac-steps N]

``DIR`` is a checkout of this repo, at this commit or an earlier one:
``sheeprl_tpu_torch`` is imported from there. Every variant a tree does not
have (the guard, the fault config) is left out of its record. Measured:

- ``ppo``: one full-recipe PPO update (``ppo`` preset, 512 rows, 10 epochs x
  8 minibatches of 64) on a synthetic rollout, ending in the losses' one
  read, as the loop's: host ms (median of 3 after a warm-up), device ms and
  device operations (``torch.profiler``). Variants: the tree's optimizer
  (``default``) and each of Adam's forms on the card (``ADAM_FORMS``: the
  ``foreach`` update with its step count on the host or on the card, the
  ``fused`` one), unguarded; the default guarded.
- ``sac``: the ``sac_per`` resident dispatch (append and 4 PER steps) over a
  4,096-row ring, the same variants: one dispatch's device ms and operations, and 48
  dispatches issued back to back as the loop issues them (a host-side row
  append before each), host ms per dispatch, with and without reading the
  guard's skipped count after each (the sentinel's read).
- ``rssm``: one DreamerV3 host-tier gradient step at the
  ``dreamer_v3_100k_atari_dummy`` recipe (batch 16 x sequence 64): device ms
  and operations, the same variants; and the target-critic EMA alone over
  the critic's tensors, in a per-tensor form (four operations a tensor, the
  mix a host number) and in a multi-tensor form with the mix a device
  tensor (the form whose cadence needs no host read).
- ``sac_run``: ``run preset=sac_per algo.total_steps=N`` (the default 4,096):
  wall seconds and the median host ms of a training iteration, with the
  tree's defaults and, where the tree has the fault runtime, with
  ``fault.sentinel.enabled=false``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _device_ops(prof):
    import torch

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    return device_us / 1e3, int(sum(e.count for e in events))


def _profiled(fn):
    """Device ms and operations of one ``fn()``, which ends synchronized."""
    import torch

    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_ops(prof)


def _host_ms(fn, reps: int = 3) -> list:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


#: Adam's forms on the card: (capturable, fused) of its param groups
ADAM_FORMS = {"host_step": (False, None), "capturable": (True, None), "fused": (True, True)}


def _set_adam(opt, variant: str) -> None:
    """Turn a built ``ClippedOptimizer``'s Adam into ``variant``: the tree's
    own (``default``); the ``foreach`` update with its step count on the
    host (``host_step``) or on the card (``capturable``); or the ``fused``
    update, its count on the card. State made so far is moved to match."""
    import torch

    if variant == "default":
        return
    capturable, fused = ADAM_FORMS[variant]
    for group in opt.optimizer.param_groups:
        group["capturable"], group["fused"] = capturable, fused
    for st in opt.optimizer.state.values():
        step = st.get("step")
        if isinstance(step, torch.Tensor):
            st["step"] = step.to(st["exp_avg"].device if capturable else "cpu", torch.float32)


def _guard_kwargs(guard: bool) -> dict:
    return {"guard": True} if guard else {}


def _has_guard(builder) -> bool:
    return "guard" in inspect.signature(builder).parameters


def ppo_costs() -> dict:
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
    from sheeprl_tpu_torch.config import preset

    cfg = preset("ppo")
    rows = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    rng = np.random.default_rng(10)
    data = {
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)],
        "logprobs": (np.log(0.5) + 0.2 * rng.normal(size=(rows, 1))).astype(np.float32),
        "values": rng.normal(size=(rows, 1)).astype(np.float32),
        "returns": (rng.normal(size=(rows, 1)) * 3).astype(np.float32),
        "advantages": rng.normal(size=(rows, 1)).astype(np.float32),
        "rewards": np.ones((rows, 1), np.float32),
        "dones": (rng.uniform(size=(rows, 1)) < 0.05).astype(np.uint8),
        "state": (rng.normal(size=(rows, 4)) * 0.1).astype(np.float32),
    }
    data = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    variants = [("default", False), *((form, False) for form in ADAM_FORMS)]
    if _has_guard(make_train_step):
        variants.append(("default", True))
    out = {}
    for adam, guard in variants:
        agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cuda")
        optimizer = make_optimizer(cfg, agent)
        _set_adam(optimizer, adam)
        update = make_train_step(agent, optimizer, cfg, rows, **_guard_kwargs(guard))
        gen = torch.Generator(device="cuda").manual_seed(11)

        def train():  # ends in the loop's one read
            res = update(data, 0.2, 0.0, generator=gen)
            if isinstance(res, tuple):
                res = torch.cat([res[0], res[1].reshape(1)])
            return res.cpu()

        train()
        host = _host_ms(train)
        device_ms, ops = _profiled(train)
        out[f"{adam}{'_guarded' if guard else ''}"] = {
            "host_ms": float(np.median(host)), "host_ms_all": host, "device_ms": device_ms, "device_ops": ops}
        print(f"ppo {adam} guard={guard}: {json.dumps(out[list(out)[-1]])}", flush=True)
    return out


def _sac_setup(adam: str, guard: bool):
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import _ring_specs, make_optimizers, make_resident_train_step
    from sheeprl_tpu_torch.config import preset
    from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState
    from sheeprl_tpu_torch.replay import sumtree as st

    cfg = preset("sac_per")
    agent, _ = build_agent(cfg, 3, {"shape": [1], "low": [-2.0], "high": [2.0]}, "cuda", None)
    optimizers = make_optimizers(cfg, agent)
    for opt in optimizers:
        _set_adam(opt, adam)
    per, n_envs = cfg.buffer.priority, int(cfg.env.num_envs)
    drb = DeviceReplayBuffer(_ring_specs(3, 1), int(cfg.buffer.size) // n_envs, n_envs, device="cuda",
                             prioritized=True, per_alpha=float(per.alpha), per_eps=float(per.eps), seed=29)
    rng, filled = np.random.default_rng(14), 4096
    arrays = {}
    for k, (shape, _) in drb.specs.items():
        full = np.zeros((drb.capacity, n_envs) + shape, np.float32)
        full[:filled] = rng.normal(size=(filled, n_envs) + shape)
        arrays[f"storage/{k}"] = torch.from_numpy(full)
    arrays["storage/terminated"].zero_()
    leaves = filled * n_envs
    arrays["tree"] = st.update(st.init(drb.capacity * n_envs), torch.arange(leaves),
                               torch.from_numpy(rng.uniform(0.05, 2.0, size=leaves).astype(np.float32)))
    arrays["max_p"] = torch.tensor(2.5)
    meta = {"capacity": drb.capacity, "n_envs": n_envs, "prioritized": True, "host_pos": filled, "host_full": False}
    drb.load_state_dict(DeviceReplayState("uniform", {**arrays, "key": drb.generator.get_state()}, meta))
    train = make_resident_train_step(agent, optimizers, cfg, drb,
                                     **_guard_kwargs(guard))
    return drb, train, rng


def sac_costs() -> dict:
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step

    variants = [("default", False), *((form, False) for form in ADAM_FORMS)]
    if _has_guard(make_resident_train_step):
        variants.append(("default", True))
    out = {}
    for adam, guard in variants:
        drb, train, rng = _sac_setup(adam, guard)

        def dispatch(read: bool):
            drb.add({k: rng.normal(size=(1, 4) + shape).astype(np.float32) for k, (shape, _) in drb.specs.items()})
            res = train(drb.make_job(), [1.0] * 4, 1.0)
            if read:
                float(res[1])

        for _ in range(3):
            dispatch(False)
        device_ms, ops = _profiled(lambda: dispatch(False))
        rec = {"device_ms": device_ms, "device_ops": ops}
        for read in ((False, True) if guard else (False,)):
            per = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(16):
                    dispatch(read)
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3 / 16)
            rec["pipelined_host_ms_read" if read else "pipelined_host_ms"] = float(np.median(per))
            rec["pipelined_host_ms_read_all" if read else "pipelined_host_ms_all"] = per
        out[f"{adam}{'_guarded' if guard else ''}"] = rec
        print(f"sac {adam} guard={guard}: {json.dumps(rec)}", flush=True)
    return out


def rssm_costs() -> dict:
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config import apply_overrides, preset

    cfg = apply_overrides(preset("dreamer_v3_100k_atari_dummy"), [])
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                     "actions": {"n": [18], "continuous": False}}
    cfg = apply_overrides(cfg, [])
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    rng = np.random.default_rng(6)
    data = {
        "rgb": rng.integers(0, 256, (1, T, B, 64, 64, 3)).astype(np.float32),
        "actions": np.eye(18, dtype=np.float32)[rng.integers(0, 18, (1, T, B))],
        "rewards": (rng.random((1, T, B, 1)) < 0.1).astype(np.float32) * 10,
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    variants = [("default", False), *((form, False) for form in ADAM_FORMS)]
    if _has_guard(make_train_step):
        variants.append(("default", True))
    out = {}
    modules = None
    for adam, guard in variants:
        modules = build_training_agent(cfg, "cuda")
        optimizers = make_optimizers(cfg, *modules[:3])
        for opt in optimizers.values():
            _set_adam(opt, adam)
        train = make_train_step(*modules, optimizers, cfg, **_guard_kwargs(guard))
        gen = torch.Generator(device="cuda").manual_seed(7)
        state = {"moments": init_moments("cuda")}

        def step():
            state["moments"] = train(data, state["moments"], 1, gen)[0]

        key = f"{adam}{'_guarded' if guard else ''}"
        try:
            step()
        except RuntimeError as e:  # a tree whose optimizer cannot take this form
            out[key] = {"error": f"{type(e).__name__}: {e}"}
            print(f"rssm {adam} guard={guard}: {out[key]['error']}", flush=True)
            continue
        host = _host_ms(step)
        device_ms, ops = _profiled(step)
        out[key] = {"host_ms": float(np.median(host)), "host_ms_all": host, "device_ms": device_ms, "device_ops": ops}
        print(f"rssm {adam} guard={guard}: {json.dumps(out[key])}", flush=True)
        del train, optimizers
    critic, target = list(modules[2].parameters()), list(modules[3].parameters())
    tau = float(cfg.algo.critic.tau)

    def per_tensor(cum: int = 1):
        mix = 1.0 if cum == 0 else tau
        with torch.no_grad():
            for t, c in zip(target, critic):
                t.copy_(mix * c + (1.0 - mix) * t)

    cum = torch.ones((), dtype=torch.int64, device="cuda")

    def multi_tensor():
        mix = torch.where(cum % 1 == 0, torch.where(cum == 0, 1.0, tau), 0.0).to(torch.float32)
        with torch.no_grad():
            moved = torch._foreach_mul(critic, mix)
            torch._foreach_add_(moved, torch._foreach_mul(target, 1.0 - mix))
            torch._foreach_copy_(target, moved)

    ema = {"tensors": len(critic)}
    for name, fn in (("per_tensor", per_tensor), ("multi_tensor", multi_tensor)):
        fn()
        host = _host_ms(lambda: [fn() for _ in range(20)])
        device_ms, ops = _profiled(fn)
        ema[name] = {"host_ms": float(np.median(host)) / 20, "device_ms": device_ms, "device_ops": ops}
    out["ema"] = ema
    print(f"rssm ema: {json.dumps(ema)}", flush=True)
    return out


def sac_run_costs(steps: int) -> dict:
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import RUN_DEFAULTS

    variants = [("default", [])]
    if "fault" in RUN_DEFAULTS:
        variants.append(("sentinel_off", ["fault.sentinel.enabled=false"]))
    with tempfile.TemporaryDirectory() as root:  # a short warm-up run: imports, kernel loads, allocator
        cli.run(["preset=sac_per", "algo.total_steps=400", "metric.log_level=0", "algo.run_test=false",
                 f"log_root={root}"])
    out = {}
    for name, extra in variants:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            summary = cli.run(["preset=sac_per", f"algo.total_steps={steps}", "metric.log_level=0", "algo.run_test=false",
                               f"log_root={root}", *extra])
            wall = time.perf_counter() - t0
        train_ms = np.asarray(summary["train_s"]) * 1e3
        trained = train_ms[train_ms > 0]
        out[name] = {"wall_s": wall, "train_calls": summary["train_calls"],
                     "train_median_ms": float(np.median(trained)) if trained.size else None,
                     "env_median_ms": float(np.median(np.asarray(summary["env_s"]) * 1e3)),
                     "skipped": summary.get("Fault/skipped_updates")}
        print(f"sac_run {name}: {json.dumps(out[name])}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="checkout whose sheeprl_tpu_torch is measured")
    parser.add_argument("--out", required=True, help="JSON file for the record")
    parser.add_argument("--sac-steps", type=int, default=4096)
    parser.add_argument("--parts", default="ppo,sac,rssm,sac_run")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import sheeprl_tpu_torch

    if not Path(sheeprl_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"sheeprl_tpu_torch came from {sheeprl_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        print("guard_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    record = {"tree": str(tree), "card": card, "torch": torch.__version__}
    parts = {"ppo": ppo_costs, "sac": sac_costs, "rssm": rssm_costs, "sac_run": lambda: sac_run_costs(args.sac_steps)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = []
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        try:
            record[name] = parts[name]()
        except Exception as e:  # the other parts still measure; the exit code says one failed
            record[name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
            print(f"{name} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        record[f"{name}_s"] = time.perf_counter() - t0
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"tree": str(tree), "card": card, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
